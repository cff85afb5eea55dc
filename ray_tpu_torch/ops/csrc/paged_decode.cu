// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over that sequence's K/V pages in a shared pool.
//
// Replaces the three Pallas kernels of ray_tpu/ops/paged_attention.py:
//   _paged_decode_kernel              (paged_decode_attention, one sequence)
//   _paged_decode_batch_kernel        (paged_decode_attention_batch)
//   _paged_decode_batch_fused_kernel  (paged_decode_attention_batch,
//                                      fused_heads=True)
// and computes what their shared _online_softmax_update computes: scores
// = (q . k) * sm_scale in f32, tokens at or past `length` masked to
// -1e30, then m_new = max(m, max(scores)), alpha = exp(m - m_new),
// p = exp(scores - m_new), l = alpha * l + sum(p), acc = alpha * acc +
// p @ v; finally out = acc / (l == 0 ? 1 : l), in q's dtype. Like the
// Pallas kernels it has no -inf guards. Page indices come from
// tables[b, i] (the TPU kernels had them in SMEM by scalar prefetch);
// pages at or past ceil(length / page) are skipped and none past the
// table's NP is read. The online softmax gives the same result for any
// order of its chunks, up to f32 rounding.
//
// Length 0. Every score is -1e30, so m stays -1e30 and p = exp(0) = 1 on
// every one of the table's NP * page tokens: the output is the mean of V
// over all NP pages, padding entries included. Both kernels below walk
// the whole table when length == 0 and mask every token, which gives
// exactly that; nothing is special-cased after the walk.
//
// Bound. A decode step reads every live K/V byte once per query group
// and does about 4 * G flops per K/V element (two dot products), far
// below the ~300 flops/byte where Hopper turns compute bound: the bound
// is bytes. But at the engine's shapes (B 8, a 9-page table, 2.4 us of
// bytes at 3.35 TB/s) a block's time is a chain of latencies, measured
// on the card with timestamps in the kernel, cold as a decode step finds
// its data: one round trip of set-up reads (~3.3 us), the first TMA copy
// (~1.5 us), its chunks (~1-2 us each), the merge (~1 us in the block,
// then the cluster barrier, which waits for the cluster's slowest split,
// and the remote reads, ~1 us). So the design keeps that chain short and
// never lets the grid take a second wave; at B 32 the chunks' bytes
// dominate and the card runs near its memory rate until the longest
// sequences' blocks finish.
//
// K2 and K3: paged_decode_cluster_kernel, one launch.
// - Mapping. One block per (split of the page table, KV head, group of at
//   most 128 query rows (64 in f32), sequence); the splits of one
//   (sequence, KV head, row group) form a thread-block cluster of at most
//   8 blocks (the portable size). A split owns a run of `tile`-token
//   chunks (64 tokens unless shared memory forces 32 or 16), runs
//   balanced to within one chunk. The host (`cluster_splits` in
//   paged_attention.py) takes the most splits, up to 8 and the table's
//   chunks, for which the CUDA runtime says the card holds every cluster
//   at once (cudaOccupancyMaxActiveClusters): at the engine's shapes 8 at
//   B 1 (64 blocks; 9 chunks cannot split further in 8), 5 at B 8 (320)
//   and 1 at B 32 (256), where a second wave would pay every block's
//   fixed costs twice.
// - Copies. In the (P, Hkv, page, D) pool one KV head's page is
//   contiguous, so the pool is a (P * Hkv * page, D) matrix and a chunk
//   is a few boxes of it whose row coordinates come from the page table.
//   One thread issues the boxes by TMA into a ring of two stages on
//   mbarriers, in the input type, in 128-byte columns ("atoms") with the
//   128-byte swizzle, so that ldmatrix and the f32 path's 16-byte reads of
//   eight consecutive rows hit distinct banks. A box is the largest power
//   of two of rows (<= the chunk) that divides the page; below 8 rows
//   (odd page sizes) the swizzle is off. The last of the block's warps to
//   finish a stage refills it. Two stages keep three blocks an SM
//   resident in bf16 (a third stage bought nothing at B 32 and cost
//   residency). The set-up issues every global read (length, the split's
//   table entries, q, the tensor maps' prefetch) before it uses any.
// - Products, bf16 and f16: mma.sync m16n8k16 with f32 sums. Each warp
//   owns 16 query rows (zero-padded past G; 4 of 16 used at G 4: the
//   tensor cores are there to cut instructions, not to add flops) and a
//   share of every chunk's 16-token groups: S = q K^T from ldmatrix
//   fragments (q from shared memory, K swizzled), scale, masks and the
//   online softmax in registers (each warp keeps its own m, l and
//   accumulators), then acc += P V with V by ldmatrix.trans. P is not
//   rounded where the plain version keeps it in f32: it is split as hi +
//   lo in the input type and both halves multiplied (error about 2^-16 of
//   p), at twice the P V products, which the byte bound pays for. f32:
//   exact CUDA-core FMAs (TF32 cannot meet 2e-4); a warp owns 8 query
//   rows, a lane one token of a 16-token group and half of the rows for
//   S, then 4 columns of every row for P V.
// - Merge, deterministic, inside the launch (thread-block clusters, not a
//   last-block-arrives counter). Each warp leaves (m, l, acc) in shared
//   memory; the block merges its warps in order, then, after a cluster
//   barrier, every block of the cluster merges a share of the outputs
//   from all splits in split order through distributed shared memory and
//   writes them, and a second cluster barrier keeps every block's shared
//   memory alive until its peers are done. No device-memory workspace, no
//   second kernel: two calls give the same bits. M = max m over parts
//   with l > 0, out = sum e^(m - M) acc / sum e^(m - M) l.
// - Masks and edges. Tokens at or past `length` score -1e30, tokens past
//   the table's end (the last chunk of a table whose NP * page is not a
//   multiple of the chunk) -2e30, so that they weigh 0 even at length 0;
//   they are never loaded, and the ring starts zeroed in that case so no
//   stale byte is ever multiplied.
//
// K4 (fused_heads=True). The TPU kernel fuses every KV head into one grid
// step per (sequence, page), because there grid steps and DMA size set
// throughput. Here K4 is a split-KV ("flash-decoding") kernel: one block
// per (sequence, KV head, split of the page table), the split count
// chosen on the host (`split_pages`) so that the grid has at least about
// two blocks an SM. A block walks its pages below ceil(length / page) (all
// of its pages at length 0) with its K and V chunks double-buffered by
// 16-byte cp.async copies, and writes its (m, l, acc) to an f32
// workspace; a block whose pages all lie at or past `length` writes m =
// -1e30 and l = 0 and nothing else. A second kernel merges the splits of
// each query head in split order, skipping splits with l == 0 (at length
// 0 every split has l > 0 and every m is -1e30, so all weigh 1). A
// sequence whose tokens all fall in one split gets K3's answer to
// rounding.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;
constexpr size_t kMaxSmemBytes = 232448;  // per block on sm_90
constexpr float kNegInf = -1e30f;
constexpr float kPastTable = -2e30f;  // tokens past the table: weigh 0
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// exp2 on the special function unit; exp2(0) is exactly 1.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// K2 and K3: the cluster kernel.
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kStages = 2;      // chunks in flight a block
constexpr int kMaxWarps = 8;
constexpr int kMaxSlots = 4;  // warps sharing a row tile (Plan::gs)
constexpr int kAtomBytes = 128;  // one swizzled row of a column atom

// What a launch needs to know about its shapes; the same on host and card.
struct Plan {
  int item;        // bytes of an element
  int rt;          // query rows a warp owns: 16 (mma.sync) or 8 (f32)
  int rb;          // query rows a block owns
  int row_blocks;  // blocks per (sequence, KV head) for the rows
  int mt;          // warps' row tiles per block
  int gs;          // warps per row tile (slots), each a share of the groups
  int warps;
  int atoms;       // 128-byte column atoms covering D
  int tile;        // tokens per chunk
  int box;         // rows per TMA box
  int swz;         // 7: 128-byte swizzle, 0: none
  int units;       // chunks in the table
  uint32_t off_q, off_tab, off_bars, off_rel;  // after the ring / merge area
  uint32_t off_blk;  // inside the merge area, after the warps' parts
  size_t smem;       // dynamic bytes, 1024 of slack for alignment included
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// The plan for these shapes; a block keeps up to the whole table row.
Plan make_plan(int G, int D, int page, int item, int NP) {
  Plan p{};
  p.item = item;
  p.rt = item == 4 ? 8 : 16;
  const int rb_max = p.rt * kMaxWarps;
  p.row_blocks = ceil_div(G, rb_max);
  p.rb = ceil_div(G, p.row_blocks);
  p.mt = ceil_div(p.rb, p.rt);
  p.gs = p.mt >= 4 ? 1 : 4 / p.mt;
  p.warps = p.mt * p.gs;
  p.atoms = ceil_div(D * item, kAtomBytes);
  int pow2 = 1;
  while (pow2 < 64 && page % (pow2 * 2) == 0) pow2 *= 2;
  const size_t q_bytes =
      item == 4 ? (size_t)p.mt * p.rt * D * 4
                : (size_t)p.mt * 16 * (ceil_div(D, 16) * 32 + 16);
  const size_t parts = (size_t)p.gs * p.mt * p.rt * (D + 2) * 4;
  const size_t merge = parts + (size_t)p.rb * (D + 2) * 4;
  const int tiles[3] = {64, 32, 16};
  for (int ti = 0; ti < 3; ++ti) {
    {
      const int tile = tiles[ti];
      const size_t ring = (size_t)kStages * 2 * p.atoms * tile * kAtomBytes;
      const int units = ceil_div(NP * page, tile);
      const int tab = NP;
      size_t at = align16(ring > merge ? ring : merge);
      const uint32_t off_q = (uint32_t)at;
      at = align16(at + q_bytes);
      const uint32_t off_tab = (uint32_t)at;
      at = align16(at + (size_t)tab * 4);
      const uint32_t off_bars = (uint32_t)at;
      at += 8 * kStages;
      const uint32_t off_rel = (uint32_t)at;
      at += 4 * kStages;
      const size_t smem = at + 1024;
      if (smem > kMaxSmemBytes) continue;
      p.tile = tile;
      p.box = pow2 < tile ? pow2 : tile;
      p.swz = p.box % 8 == 0 ? 7 : 0;
      p.units = units;
      p.off_q = off_q;
      p.off_tab = off_tab;
      p.off_bars = off_bars;
      p.off_rel = off_rel;
      p.off_blk = (uint32_t)parts;
      p.smem = smem;
      return p;
    }
  }
  p.tile = 0;  // nothing fits
  return p;
}

struct ClusterArgs {
  const void* q;
  void* out;
  const int* tables;
  const int* lengths;
  int H, Hkv, G, D, page, NP, splits;
  float scale;
  Plan p;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity`; traps after about ten seconds
// (a byte count that does not match its boxes) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000ll) __trap();
  }
}

// One box (one 128-byte column atom x `box` rows) of the pool matrix.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of shared address `addr` of block `rank` of this cluster,
// in the cluster's shared window.
__device__ __forceinline__ uint32_t map_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// A float of the cluster's shared window. Volatile, so not moved above
// the cluster barrier; no memory clobber, so loads overlap.
__device__ __forceinline__ float ld_cluster(uint32_t remote) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint16_t bits(T x);
template <>
__device__ __forceinline__ uint16_t bits<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <>
__device__ __forceinline__ uint16_t bits<__half>(__half x) {
  return __half_as_ushort(x);
}

// Two floats as the input type's hi parts (`hi`) and what they leave (`lo`).
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const T h0 = from_float<T>(x0), h1 = from_float<T>(x1);
  const T l0 = from_float<T>(x0 - to_float(h0));
  const T l1 = from_float<T>(x1 - to_float(h1));
  hi = (uint32_t)bits(h0) | ((uint32_t)bits(h1) << 16);
  lo = (uint32_t)bits(l0) | ((uint32_t)bits(l1) << 16);
}

// Byte address of 16-byte piece `piece` of row `row` of a tile of `tile`
// rows held as 128-byte column atoms, swizzled when swz == 7.
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int tile, int row,
                                              int piece, int swz) {
  return base + (piece >> 3) * tile * kAtomBytes + row * kAtomBytes +
         (((piece & 7) ^ (row & swz)) << 4);
}

// The shared state of one block: where it is and what it walks.
struct Block {
  int split, h, row0, gb, b, length, T, u0, n, p_first;
  uint32_t ring, bars;
  unsigned* rel;
  int* tab;
};

// Issues chunk k of the block's walk (chunk u0 + k of the table) into
// stage k % stages: the boxes of its tokens that lie in the table.
__device__ __forceinline__ void issue_chunk(const ClusterArgs& a,
                                           const Block& blk,
                                           const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, int k) {
  const Plan& p = a.p;
  const int st = k % kStages;
  const uint32_t bar = blk.bars + 8 * st;
  const uint32_t tile_bytes = p.atoms * p.tile * kAtomBytes;
  const uint32_t k_dst = blk.ring + st * 2 * tile_bytes;
  const uint32_t v_dst = k_dst + tile_bytes;
  const int tok0 = (blk.u0 + k) * p.tile;
  const int rows = min(p.tile, blk.T - tok0);
  const int boxes = rows / p.box;
  mbar_expect_tx(bar, boxes * p.atoms * p.box * kAtomBytes * 2);
  const int col_step = kAtomBytes / p.item;
  for (int j = 0; j < boxes; ++j) {
    const int tok = tok0 + j * p.box;
    const int pi = tok / a.page;
    const int row =
        (blk.tab[pi - blk.p_first] * a.Hkv + blk.h) * a.page + tok % a.page;
    for (int at = 0; at < p.atoms; ++at) {
      const uint32_t off = at * p.tile * kAtomBytes + j * p.box * kAtomBytes;
      tma_load(k_dst + off, k_map, bar, at * col_step, row);
      tma_load(v_dst + off, v_map, bar, at * col_step, row);
    }
  }
}

// Every warp calls this when done with chunk k; the last of the block's
// warps to do so refills its stage with chunk k + stages.
__device__ __forceinline__ void release_chunk(const ClusterArgs& a,
                                              const Block& blk,
                                              const CUtensorMap* k_map,
                                              const CUtensorMap* v_map, int k,
                                              int lane) {
  const Plan& p = a.p;
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    if (atomicAdd(&blk.rel[k % kStages], 1u) % p.warps == p.warps - 1 &&
        k + kStages < blk.n) {
      __threadfence_block();
      issue_chunk(a, blk, k_map, v_map, k + kStages);
    }
  }
}

// Score of token `tok` (its product already scaled) under the masks.
__device__ __forceinline__ float masked(float s, int tok, int length, int T) {
  return tok >= T ? kPastTable : (tok < length ? s : kNegInf);
}

// Sets up the block: indices, its table slice, q, barriers, and the first
// chunks in flight. Returns the block; `smem` is 1024-aligned. The data
// is cold on a decode step (the layer's weights have just streamed
// through L2), so every global read of the set-up (the length, the
// split's table entries, q, the tensor maps) is issued before any is
// used: one round trip before the first TMA copy, not four.
template <typename T>
__device__ Block setup(const ClusterArgs& a, uint8_t* smem,
                       const CUtensorMap* k_map, const CUtensorMap* v_map) {
  const Plan& p = a.p;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(k_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(v_map) : "memory");
  }
  Block blk;
  blk.split = blockIdx.x;
  blk.h = blockIdx.y / p.row_blocks;
  blk.row0 = blockIdx.y % p.row_blocks * p.rb;
  blk.gb = min(p.rb, a.G - blk.row0);
  blk.b = blockIdx.z;
  blk.T = a.NP * a.page;
  blk.u0 = (int)((long long)blk.split * p.units / a.splits);
  const int u1 = (int)((long long)(blk.split + 1) * p.units / a.splits);
  blk.p_first = blk.u0 * p.tile / a.page;
  // The split's table entries, whatever the length (entries past it are
  // valid indices too).
  const int n_tab = (min(u1 * p.tile, blk.T) - 1) / a.page - blk.p_first + 1;
  const int* tab_g = a.tables + (size_t)blk.b * a.NP + blk.p_first;
  const T* q = static_cast<const T*>(a.q) +
               ((size_t)blk.b * a.H + (size_t)blk.h * a.G + blk.row0) * a.D;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kQv = 4;  // 16-byte pieces of q a thread reads at once
  const int q_pieces = blk.gb * a.D / kVec;
  const bool q_vec = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  blk.length = a.lengths[blk.b];
  const int tab0 = tid < n_tab ? tab_g[tid] : 0;
  uint4 qv[kQv];
#pragma unroll
  for (int j = 0; j < kQv; ++j) {
    const int v = tid + j * nthreads;
    if (q_vec && v < q_pieces) qv[j] = reinterpret_cast<const uint4*>(q)[v];
  }

  // At length 0 the whole table is walked (every token masked alike).
  const int live = blk.length == 0 ? blk.T : min(blk.length, blk.T);
  blk.n = max(0, min(u1, ceil_div(live, p.tile)) - blk.u0);
  blk.ring = smem_u32(smem);
  blk.bars = blk.ring + p.off_bars;
  blk.rel = reinterpret_cast<unsigned*>(smem + p.off_rel);
  blk.tab = reinterpret_cast<int*>(smem + p.off_tab);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(blk.bars + 8 * i);
      blk.rel[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < n_tab) blk.tab[tid] = tab0;
  for (int i = tid + nthreads; i < n_tab; i += nthreads) blk.tab[i] = tab_g[i];
  // q in shared memory: rows of `stride` elements (f32: D; else D padded
  // to 16 columns, and 8 more so that ldmatrix rows hit distinct banks),
  // rows past G and columns past D zero.
  const int cols = p.item == 4 ? a.D : ceil_div(a.D, 16) * 16;
  const int stride = p.item == 4 ? a.D : cols + 8;
  T* q_s = reinterpret_cast<T*>(smem + p.off_q);
  for (int i = tid; i < p.mt * p.rt * cols; i += nthreads) {
    const int r = i / cols, c = i - r * cols;
    if (r >= blk.gb || c >= a.D) q_s[r * stride + c] = from_float<T>(0.f);
  }
  if (q_vec) {
    auto put = [&](int v, uint4 x) {
      const int e = v * kVec, r = e / a.D;
      *reinterpret_cast<uint4*>(q_s + r * stride + e - r * a.D) = x;
    };
#pragma unroll
    for (int j = 0; j < kQv; ++j)
      if (tid + j * nthreads < q_pieces) put(tid + j * nthreads, qv[j]);
    for (int v = tid + kQv * nthreads; v < q_pieces; v += nthreads)
      put(v, reinterpret_cast<const uint4*>(q)[v]);
  } else {
    for (int i = tid; i < blk.gb * a.D; i += nthreads) {
      const int r = i / a.D;
      q_s[r * stride + i - r * a.D] = q[i];
    }
  }
  // A table whose token count is not a multiple of the chunk leaves rows
  // of its last chunk unloaded: the ring starts zeroed, so that no stale
  // or uninitialised byte meets a weight of 0.
  if (blk.T % p.tile != 0) {
    uint4* ring = reinterpret_cast<uint4*>(smem);
    const int n = kStages * 2 * p.atoms * p.tile * kAtomBytes / 16;
    for (int i = tid; i < n; i += nthreads) ring[i] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kStages && k < blk.n; ++k)
      issue_chunk(a, blk, k_map, v_map, k);
  return blk;
}

// One part of the merge: (m, l, acc[D]) as D + 2 floats.
__device__ __forceinline__ float* part_row(uint8_t* smem, const Plan& p,
                                           int slot, int row, int D) {
  return reinterpret_cast<float*>(smem) +
         ((size_t)slot * p.mt * p.rt + row) * (D + 2);
}

// Merges the warps' parts into the block's (m, l, acc), then the blocks
// of the cluster in split order into the output.
template <typename T>
__device__ void merge_and_store(const ClusterArgs& a, const Block& blk,
                                uint8_t* smem) {
  const Plan& p = a.p;
  const int tid = threadIdx.x, nthreads = blockDim.x, D = a.D;
  float* out_blk = reinterpret_cast<float*>(smem + p.off_blk);
  __syncthreads();  // every warp's part is written
  for (int i = tid; i < blk.gb * D; i += nthreads) {
    const int g = i / D, d = i - g * D;
    float ms[kMaxSlots], ls[kMaxSlots], as[kMaxSlots];
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {  // all in flight together
      if (s < p.gs) {
        const float* pr = part_row(smem, p, s, g, D);
        ms[s] = pr[0];
        ls[s] = pr[1];
        as[s] = pr[2 + d];
      }
    }
    float M = kNegInf;
    bool any = false;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      if (s < p.gs && ls[s] != 0.f) {
        M = any ? fmaxf(M, ms[s]) : ms[s];
        any = true;
      }
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      if (s < p.gs && ls[s] != 0.f) {
        const float w = exp2_approx((ms[s] - M) * kLog2e);
        l = fmaf(w, ls[s], l);
        acc = fmaf(w, as[s], acc);
      }
    }
    float* row = out_blk + (size_t)g * (D + 2);
    row[2 + d] = acc;
    if (d == 0) {
      row[0] = M;
      row[1] = l;
    }
  }
  cluster_sync();  // every block's (m, l, acc) is written
  // Each split's copy of the area, in the cluster's shared window.
  const uint32_t base = smem_u32(out_blk);
  uint32_t peer[kMaxCluster];
#pragma unroll
  for (int s = 0; s < kMaxCluster; ++s)
    peer[s] = s < a.splits ? map_cluster(base, s) : 0;
  T* out = static_cast<T*>(a.out) +
           ((size_t)blk.b * a.H + (size_t)blk.h * a.G + blk.row0) * D;
  for (int i = blk.split * nthreads + tid; i < blk.gb * D;
       i += a.splits * nthreads) {
    const int g = i / D, d = i - g * D;
    const uint32_t row = (uint32_t)(g * (D + 2)) * 4;
    float ms[kMaxCluster], ls[kMaxCluster], as[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {  // all in flight together
      if (s < a.splits) {
        ms[s] = ld_cluster(peer[s] + row);
        ls[s] = ld_cluster(peer[s] + row + 4);
        as[s] = ld_cluster(peer[s] + row + 8 + 4 * d);
      }
    }
    float M = kNegInf;
    bool any = false;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < a.splits && ls[s] != 0.f) {
        M = any ? fmaxf(M, ms[s]) : ms[s];
        any = true;
      }
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < a.splits && ls[s] != 0.f) {
        const float w = exp2_approx((ms[s] - M) * kLog2e);
        l = fmaf(w, ls[s], l);
        acc = fmaf(w, as[s], acc);
      }
    }
    out[(size_t)g * D + d] = from_float<T>(acc / (l == 0.f ? 1.f : l));
  }
  cluster_sync();  // peers are done reading this block's shared memory
}

// bf16 and f16 on mma.sync. KB: 16-column steps of D, a bucket (D <= 16 KB).
template <typename T, int KB>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    paged_decode_cluster_kernel(const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const ClusterArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Plan& p = a.p;
  const Block blk = setup<T>(a, smem, &k_map, &v_map);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp / p.gs, slot = warp % p.gs;
  const int ks = ceil_div(a.D, 16);  // 16-column steps in use
  const uint32_t tile_bytes = p.atoms * p.tile * kAtomBytes;
  const int q_stride = ks * 32 + 16;  // bytes; odd in 16-byte pieces
  const uint32_t q_s = blk.ring + p.off_q + mt * 16 * q_stride;
  const int lim = min(blk.length, blk.T);
  const int c2 = (lane & 3) * 2;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2 * KB][4];
#pragma unroll
  for (int n = 0; n < 2 * KB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k = 0; k < blk.n; ++k) {
    const int st = k % kStages;
    mbar_wait(blk.bars + 8 * st, (k / kStages) & 1);
    const uint32_t k_t = blk.ring + st * 2 * tile_bytes;
    const uint32_t v_t = k_t + tile_bytes;
    const int tok0 = (blk.u0 + k) * p.tile;
    for (int grp = slot; grp < p.tile / 16; grp += p.gs) {
      const int gt0 = tok0 + grp * 16;
      if (gt0 >= blk.T) break;  // past the table: nothing loaded
      // S = q K^T over this group's 16 tokens: two 8-token n-tiles.
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        if (kk < ks) {
          uint32_t qa[4], kb[4];
          ldsm_x4(qa, q_s + ((mat & 1) * 8 + (lane & 7)) * q_stride +
                          (kk * 2 + (mat >> 1)) * 16);
          ldsm_x4(kb, tile_addr(k_t, p.tile,
                                grp * 16 + (mat >> 1) * 8 + (lane & 7),
                                kk * 2 + (mat & 1), p.swz));
          mma16816<T>(s[0], qa, kb[0], kb[1]);
          mma16816<T>(s[1], qa, kb[2], kb[3]);
        }
      }
      // Scale, masks, and the online softmax of rows lane/4 and lane/4+8.
      const bool edge = gt0 + 16 > lim;
      float mx[2] = {kNegInf * 4.f, kNegInf * 4.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * a.scale;
          if (edge)
            x = masked(x, gt0 + nt * 8 + c2 + (e & 1), blk.length, blk.T);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_approx((s[nt][e] - m[e >> 1]) * kLog2e);
          s[nt][e] = pe;
          sum[e >> 1] += pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(alpha[r], l[r], sum[r]);
#pragma unroll
      for (int n = 0; n < 2 * KB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // P as the A operand, hi and lo halves in the input type.
      uint32_t ph[4], pl[4];
      split2<T>(s[0][0], s[0][1], ph[0], pl[0]);
      split2<T>(s[0][2], s[0][3], ph[1], pl[1]);
      split2<T>(s[1][0], s[1][1], ph[2], pl[2]);
      split2<T>(s[1][2], s[1][3], ph[3], pl[3]);
      // acc += P V: V's 16 rows by ldmatrix.trans, two 8-column n-tiles
      // per load.
#pragma unroll
      for (int np = 0; np < KB; ++np) {
        if (np < ks) {
          uint32_t vb[4];
          ldsm_x4_t(vb, tile_addr(v_t, p.tile,
                                  grp * 16 + (mat & 1) * 8 + (lane & 7),
                                  np * 2 + (mat >> 1), p.swz));
          mma16816<T>(acc[2 * np], ph, vb[0], vb[1]);
          mma16816<T>(acc[2 * np], pl, vb[0], vb[1]);
          mma16816<T>(acc[2 * np + 1], ph, vb[2], vb[3]);
          mma16816<T>(acc[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
    }
    release_chunk(a, blk, &k_map, &v_map, k, lane);
  }

  // This warp's part: rows lane/4 and lane/4 + 8 of its row tile.
  __syncthreads();  // the ring is read out; the merge area overlays it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = mt * 16 + (lane >> 2) + 8 * r;
    if (row >= blk.gb) continue;
    float* pr = part_row(smem, p, slot, row, a.D);
    if ((lane & 3) == 0) {
      pr[0] = m[r];
      pr[1] = l[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * KB; ++n) {
      const int d = n * 8 + c2;
      if (d < a.D) {
        pr[2 + d] = acc[n][2 * r];
        pr[3 + d] = acc[n][2 * r + 1];
      }
    }
  }
  merge_and_store<T>(a, blk, smem);
}

// f32 on exact FMAs. DV: 128-column steps of D, a bucket (D <= 128 DV).
template <int DV>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    paged_decode_cluster_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    const ClusterArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Plan& p = a.p;
  const Block blk = setup<float>(a, smem, &k_map, &v_map);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp / p.gs, slot = warp % p.gs;
  const int t = lane & 15, half = lane >> 4;
  const int D = a.D, d4 = D / 4;
  const uint32_t tile_bytes = p.atoms * p.tile * kAtomBytes;
  // This warp's 8 query rows; a lane computes scores for rows half + 2j.
  const float4* q_s =
      reinterpret_cast<const float4*>(smem + p.off_q) + mt * 8 * d4;
  const int lim = min(blk.length, blk.T);

  float m[4], l[4];
  float4 acc[8][DV];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k = 0; k < blk.n; ++k) {
    const int st = k % kStages;
    mbar_wait(blk.bars + 8 * st, (k / kStages) & 1);
    const uint32_t k_t = blk.ring + st * 2 * tile_bytes;
    const uint8_t* k_g = smem + (k_t - blk.ring);
    const uint8_t* v_g = k_g + tile_bytes;
    const int tok0 = (blk.u0 + k) * p.tile;
    for (int grp = slot; grp < p.tile / 16; grp += p.gs) {
      const int gt0 = tok0 + grp * 16;
      if (gt0 >= blk.T) break;  // past the table: nothing loaded
      const int lt = grp * 16 + t;  // this lane's token in the chunk
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int x = 0; x < d4; ++x) {
        const float4 kf = *reinterpret_cast<const float4*>(
            k_g + (tile_addr(0, p.tile, lt, x, p.swz)));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qf = q_s[(half + 2 * j) * d4 + x];
          dot[j] = fmaf(qf.x, kf.x, dot[j]);
          dot[j] = fmaf(qf.y, kf.y, dot[j]);
          dot[j] = fmaf(qf.z, kf.z, dot[j]);
          dot[j] = fmaf(qf.w, kf.w, dot[j]);
        }
      }
      const bool edge = gt0 + 16 > lim;
      float pj[4], alpha[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = dot[j] * a.scale;
        if (edge) x = masked(x, gt0 + t, blk.length, blk.T);
        float mx = x;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[j], mx);
        alpha[j] = exp2_approx((m[j] - m_new) * kLog2e);
        pj[j] = exp2_approx((x - m_new) * kLog2e);
        l[j] = fmaf(alpha[j], l[j], pj[j]);  // this lane's token only
        m[j] = m_new;
      }
      // acc[r] = alpha_r acc[r] + sum_t p[r][t] v[t], a lane holding
      // columns 4 * (lane + 32 i) of every row.
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float al =
            __shfl_sync(0xffffffffu, alpha[r >> 1], (r & 1) * 16);
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          acc[r][i].x *= al;
          acc[r][i].y *= al;
          acc[r][i].z *= al;
          acc[r][i].w *= al;
        }
      }
      for (int tt = 0; tt < 16; ++tt) {
        float4 vf[DV];
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          const int x = lane + 32 * i;
          vf[i] = x < d4 ? *reinterpret_cast<const float4*>(
                               v_g + tile_addr(0, p.tile, grp * 16 + tt, x,
                                               p.swz))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float pr =
              __shfl_sync(0xffffffffu, pj[r >> 1], tt + 16 * (r & 1));
#pragma unroll
          for (int i = 0; i < DV; ++i) {
            acc[r][i].x = fmaf(pr, vf[i].x, acc[r][i].x);
            acc[r][i].y = fmaf(pr, vf[i].y, acc[r][i].y);
            acc[r][i].z = fmaf(pr, vf[i].z, acc[r][i].z);
            acc[r][i].w = fmaf(pr, vf[i].w, acc[r][i].w);
          }
        }
      }
    }
    release_chunk(a, blk, &k_map, &v_map, k, lane);
  }

  __syncthreads();  // the ring is read out; the merge area overlays it
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float mr = __shfl_sync(0xffffffffu, m[r >> 1], (r & 1) * 16);
    const float lr = __shfl_sync(0xffffffffu, l[r >> 1], (r & 1) * 16);
    const int row = mt * 8 + r;
    if (row >= blk.gb) continue;
    float* pr = part_row(smem, p, slot, row, D);
    if (lane == 0) {
      pr[0] = mr;
      pr[1] = lr;
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int x = lane + 32 * i;
      if (x < d4) {
        pr[2 + 4 * x] = acc[r][i].x;
        pr[3 + 4 * x] = acc[r][i].y;
        pr[4 + 4 * x] = acc[r][i].z;
        pr[5 + 4 * x] = acc[r][i].w;
      }
    }
  }
  merge_and_store<float>(a, blk, smem);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The pool (P, Hkv, page, D) as a (P * Hkv * page, D) matrix: boxes of
// one 128-byte column atom by `box` rows, zeros past D.
cudaError_t pool_map(CUtensorMap* map, const void* pool, int dtype,
                     long long rows, int D, const Plan& p) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType type =
      dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * p.item};
  const cuuint32_t box[2] = {(cuuint32_t)(kAtomBytes / p.item),
                             (cuuint32_t)p.box};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(pool), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      p.swz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using ClusterKernel = void (*)(CUtensorMap, CUtensorMap, ClusterArgs);

// The kernel for a dtype code and head dim (register arrays are sized by
// a bucket of D).
ClusterKernel cluster_kernel(int dtype, int D) {
  if (dtype == 0)
    return D <= 128 ? paged_decode_cluster_f32_kernel<1>
                    : paged_decode_cluster_f32_kernel<2>;
  const int ks = ceil_div(D, 16);
  if (dtype == 1)
    return ks <= 2   ? paged_decode_cluster_kernel<__nv_bfloat16, 2>
           : ks <= 4 ? paged_decode_cluster_kernel<__nv_bfloat16, 4>
           : ks <= 8 ? paged_decode_cluster_kernel<__nv_bfloat16, 8>
                     : paged_decode_cluster_kernel<__nv_bfloat16, 16>;
  return ks <= 2   ? paged_decode_cluster_kernel<__half, 2>
         : ks <= 4 ? paged_decode_cluster_kernel<__half, 4>
         : ks <= 8 ? paged_decode_cluster_kernel<__half, 8>
                   : paged_decode_cluster_kernel<__half, 16>;
}

// A launch of `kernel` over clusters of `splits` blocks, `clusters` of
// them (grid (splits, clusters / B, B)).
cudaLaunchConfig_t cluster_config(const Plan& p, int splits, dim3 grid,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.warps * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_cluster(ClusterKernel kernel, const CUtensorMap& k_map,
                           const CUtensorMap& v_map, const ClusterArgs& a,
                           int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      a.p, a.splits, dim3(a.splits, a.Hkv * a.p.row_blocks, B), &attr,
      stream);
  err = cudaLaunchKernelEx(&cfg, kernel, k_map, v_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: split-KV decode.
// ---------------------------------------------------------------------------

// Online-softmax update of one chunk's scores s_s (G rows of `tt`, row
// stride `tile`), in place into probabilities; one warp per query row.
__device__ __forceinline__ void softmax_update(float* s_s, float* m_s,
                                               float* l_s, float* alpha_s,
                                               int G, int tt, int tile) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += kWarps) {
    float* row = s_s + g * tile;
    float mx = kNegInf;
    for (int t = lane; t < tt; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < tt; t += 32) {
      const float p = expf(row[t] - m_new);
      row[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      alpha_s[g] = alpha;
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
    }
  }
}

// acc = alpha * acc + p @ v over one chunk (V rows of D in the input
// type): one thread per (row, dim).
template <typename V>
__device__ __forceinline__ void pv_update(float* acc_s, const float* s_s,
                                          const float* alpha_s, const V* v_s,
                                          int G, int D, int tt, int tile) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    const float* p = s_s + g * tile;
    float pv = 0.f;
#pragma unroll 8
    for (int t = 0; t < tt; ++t) pv = fmaf(p[t], to_float(v_s[t * D + d]), pv);
    acc_s[i] = acc_s[i] * alpha_s[g] + pv;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one K row in shared memory: 16 more than the row, so that the
// 16-byte reads of eight threads on eight tokens hit distinct banks.
__host__ __device__ __forceinline__ int split_k_row(int D, int item) {
  return D * item + 16;
}

// The f32 head of the split kernel's shared memory (q, acc, scores, m,
// l, alpha), rounded up to 16 bytes.
__host__ __device__ __forceinline__ size_t split_head_bytes(int G, int D,
                                                           int tile) {
  const size_t f = 2 * (size_t)G * D + (size_t)G * tile + 3 * (size_t)G;
  return (f * sizeof(float) + 15) / 16 * 16;
}

// The head, then two stages of a K chunk and a V chunk in the input type.
size_t split_smem_bytes(int G, int D, int tile, int item) {
  return split_head_bytes(G, D, tile) +
         2 * (size_t)tile * (split_k_row(D, item) + (size_t)D * item);
}

int pick_split_tile(int G, int D, int page, int item) {
  int tile = page < kMaxTile ? page : kMaxTile;
  while (tile > 1 && split_smem_bytes(G, D, tile, item) > kMaxSmemBytes)
    tile /= 2;
  return tile;
}

// One block per (sequence, KV head, split): pages [split * pps,
// min((split + 1) * pps, NP, ceil(length / page))), all of its pages at
// length 0. Writes, for each of the G query heads, (m, l, acc[D]) at
// part[((b H + h G + g) * splits + split) * (D + 2)].
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part, int H,
    int Hkv, int D, int page, int NP, int tile, float sm_scale, int pps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  const int G = H / Hkv;
  const int GD = G * D;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* acc_s = q_s + GD;
  float* s_s = acc_s + GD;
  float* m_s = s_s + G * tile;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  const int k_row = split_k_row(D, sizeof(T)), v_row = D * sizeof(T);
  unsigned char* k_st = smem_raw + split_head_bytes(G, D, tile);
  unsigned char* v_st = k_st + 2 * tile * k_row;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int length = lengths[b];
  // The tokens walked: up to `length`, or the whole table at length 0
  // (where every score is masked alike).
  const int walk = length == 0 ? NP * page : length;
  const int p_begin = split * pps;
  const int p_end = min(min(p_begin + pps, NP), (walk + page - 1) / page);
  float* part_b = part + ((size_t)b * H + (size_t)h * G) * splits * (D + 2);
  auto part_row = [&](int g) {
    return part_b + ((size_t)g * splits + split) * (D + 2);
  };
  if (p_end <= p_begin) {  // every page at or past `length`
    for (int g = tid; g < G; g += kThreads) {
      part_row(g)[0] = kNegInf;
      part_row(g)[1] = 0.f;
    }
    return;
  }

  // Chunks of `tile` tokens, page by page, up to the last walked token.
  const int per_page = (page + tile - 1) / tile;
  const int live = min(walk, p_end * page) - p_begin * page;
  const int n_chunks =
      live / page * per_page + (live % page + tile - 1) / tile;
  const int* table = tables + (size_t)b * NP;
  const int vecs = v_row / 16;  // 16-byte pieces of a row
  auto load = [&](int c) {
    const int pi = p_begin + c / per_page, t0 = c % per_page * tile;
    const int tt = min(tile, page - t0);
    const size_t at = (((size_t)table[pi] * Hkv + h) * page + t0) * D;
    const unsigned char* k_src =
        reinterpret_cast<const unsigned char*>(k_pool + at);
    const unsigned char* v_src =
        reinterpret_cast<const unsigned char*>(v_pool + at);
    unsigned char* k_dst = k_st + (c & 1) * tile * k_row;
    unsigned char* v_dst = v_st + (c & 1) * tile * v_row;
    for (int i = tid; i < tt * vecs; i += kThreads) {
      const int r = i / vecs, x = (i - r * vecs) * 16;
      cp_async16(k_dst + r * k_row + x, k_src + (size_t)r * v_row + x);
      cp_async16(v_dst + r * v_row + x, v_src + (size_t)r * v_row + x);
    }
    cp_async_commit();
  };

  load(0);
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_float(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c + 1 goes into the other stage, read by chunk c - 1 (done at
    // the barrier that ended the previous step).
    if (c + 1 < n_chunks) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = c % per_page * tile;
    const int tok0 = (p_begin + c / per_page) * page + t0;
    const int tt = min(tile, page - t0);
    const unsigned char* k_c = k_st + (c & 1) * tile * k_row;
    const T* v_c = reinterpret_cast<const T*>(v_st + (c & 1) * tile * v_row);

    // Scores: one thread per (query row, token), K read 16 bytes at a
    // time, summed over d in order.
    for (int i = tid; i < G * tt; i += kThreads) {
      const int g = i / tt;
      const int t = i - g * tt;
      const float* q_row = q_s + g * D;
      const uint4* k_vec = reinterpret_cast<const uint4*>(k_c + t * k_row);
      float dot = 0.f;
      for (int x = 0; x < vecs; ++x) {
        const uint4 kr = k_vec[x];
        const T* ke = reinterpret_cast<const T*>(&kr);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          dot = fmaf(q_row[x * kVec + j], to_float(ke[j]), dot);
      }
      s_s[g * tile + t] = tok0 + t < length ? dot * sm_scale : kNegInf;
    }
    __syncthreads();
    softmax_update(s_s, m_s, l_s, alpha_s, G, tt, tile);
    __syncthreads();
    pv_update(acc_s, s_s, alpha_s, v_c, G, D, tt, tile);
    __syncthreads();
  }

  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D;
    part_row(g)[2 + i - g * D] = acc_s[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_row(g)[0] = m_s[g];
    part_row(g)[1] = l_s[g];
  }
}

// Merges the splits of one (sequence, query head) in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int D, int splits) {
  const float* p = part + (size_t)blockIdx.x * splits * (D + 2);
  float m = kNegInf;
  for (int s = 0; s < splits; ++s)
    if (p[s * (D + 2) + 1] != 0.f) m = fmaxf(m, p[s * (D + 2)]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = p + s * (D + 2);
      if (ps[1] == 0.f) continue;  // an empty split: no acc was written
      const float w = expf(ps[0] - m);
      l = fmaf(w, ps[1], l);
      acc = fmaf(w, ps[2 + d], acc);
    }
    out[(size_t)blockIdx.x * D + d] =
        from_float<T>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* lengths, void* out, float* part, int B,
                         int H, int Hkv, int D, int page, int NP,
                         float sm_scale, int splits, int pps,
                         cudaStream_t stream) {
  const int G = H / Hkv;
  const int tile = pick_split_tile(G, D, page, sizeof(T));
  const size_t smem = split_smem_bytes(G, D, tile, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_split_kernel<T><<<dim3(B, Hkv, splits), kThreads, smem,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), part, H, Hkv, D, page, NP, tile,
      sm_scale, pps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part, static_cast<T*>(out), D, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q and out (B, H, D); pools
// (P, Hkv, page, D), 16-byte aligned, with D a multiple of 8; tables
// (B, NP) int32 with entries in [0, P); lengths (B,) int32. All contiguous
// on the current device. K2 and K3: one launch of the cluster kernel over
// `splits` splits of each table (1 <= splits <= 8, at most the table's
// chunks: paged_decode_tile). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape whose shared memory does not fit).
extern "C" int paged_decode(int dtype, const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, int B, int H,
                            int Hkv, int D, int page, int NP, int P,
                            float sm_scale, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2 || splits < 1 || splits > kMaxCluster)
    return cudaErrorInvalidValue;
  ClusterArgs a{};
  a.q = q;
  a.out = out;
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.H = H, a.Hkv = Hkv, a.G = H / Hkv, a.D = D, a.page = page, a.NP = NP;
  a.splits = splits;
  a.scale = sm_scale;
  a.p = make_plan(a.G, D, page, dtype == 0 ? 4 : 2, NP);
  if (a.p.tile == 0 || splits > a.p.units) return cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  const long long rows = (long long)P * Hkv * page;
  cudaError_t err = pool_map(&k_map, k_pool, dtype, rows, D, a.p);
  if (err == cudaSuccess) err = pool_map(&v_map, v_pool, dtype, rows, D, a.p);
  if (err != cudaSuccess) return err;
  return launch_cluster(cluster_kernel(dtype, D), k_map, v_map, a, B, s);
}

// K4: as paged_decode, over `splits` splits of `pps` pages of each table
// (splits * pps >= NP); part is an f32 workspace of B * H * splits *
// (D + 2) floats. Launches the split kernel and the combine kernel.
extern "C" int paged_decode_split(int dtype, const void* q,
                                  const void* k_pool, const void* v_pool,
                                  const void* tables, const void* lengths,
                                  void* out, float* part, int B, int H,
                                  int Hkv, int D, int page, int NP,
                                  float sm_scale, int splits, int pps,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_split<float>(q, k_pool, v_pool, tables, lengths, out,
                                 part, B, H, Hkv, D, page, NP, sm_scale,
                                 splits, pps, s);
    case 1:
      return launch_split<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths,
                                         out, part, B, H, Hkv, D, page, NP,
                                         sm_scale, splits, pps, s);
    case 2:
      return launch_split<__half>(q, k_pool, v_pool, tables, lengths, out,
                                  part, B, H, Hkv, D, page, NP, sm_scale,
                                  splits, pps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The cluster kernel's chunk for these shapes (0 when no chunk fits
// shared memory), through `units` the chunks in a table of NP pages, and
// through `row_blocks` the blocks that share a (sequence, KV head)'s
// query rows.
extern "C" int paged_decode_tile(int G, int D, int page, int item, int NP,
                                 int* units, int* row_blocks) {
  const Plan p = make_plan(G, D, page, item, NP);
  *units = p.units;
  *row_blocks = p.row_blocks;
  return p.tile;
}

// Shared memory one block needs: the cluster kernel's, or, with
// `split_kernel`, K4's split kernel's (above kMaxSmemBytes the launch
// would fail; 0: the cluster kernel fits no chunk).
extern "C" size_t paged_decode_smem_bytes(int G, int D, int page, int item,
                                          int NP, int split_kernel) {
  if (split_kernel)
    return split_smem_bytes(G, D, pick_split_tile(G, D, page, item), item);
  const Plan p = make_plan(G, D, page, item, NP);
  return p.tile ? p.smem : 0;
}

// How many clusters of `splits` blocks of the cluster kernel the card
// holds at once for these shapes (the split chooser keeps the grid to
// that); negative: the cudaError_t of the query.
extern "C" int paged_decode_resident_clusters(int dtype, int G, int D,
                                              int page, int NP, int splits) {
  if (dtype < 0 || dtype > 2) return -(int)cudaErrorInvalidValue;
  const Plan p = make_plan(G, D, page, dtype == 0 ? 4 : 2, NP);
  if (p.tile == 0) return -(int)cudaErrorInvalidValue;
  const ClusterKernel kernel = cluster_kernel(dtype, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(p, splits, dim3(splits, 1, 1), &attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
