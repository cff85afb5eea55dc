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
// Pallas kernels it has no -inf guards. The update runs once per chunk
// of `tile` tokens (a whole page for pages of up to 64 tokens); the
// online softmax gives the same result for any chunking, up to f32
// rounding.
//
// Block mappings. K2 and K3: one block per (sequence, KV head), grid
// (B, Hkv). A block serves the G = H / Hkv query heads that share its KV
// head, so each K/V page is read once per query group. Each block reads
// its own page indices from tables[b, i] (the TPU kernels had them in
// SMEM by scalar prefetch) and walks pages i < min(ceil(length / page),
// NP), skipping the chunks of the last page that lie wholly at or past
// `length`. For length >= 1 that gives the TPU grid's result: a chunk the
// TPU masks wholly adds exp(-1e30 - m) = 0 and leaves alpha = 1, and like
// the TPU grid it never reads past NP pages.
//
// K4 (fused_heads=True). The TPU kernel fuses every KV head into one grid
// step per (sequence, page), because there grid steps and DMA size set
// throughput. On Hopper what sets it is bytes in flight on every SM, so
// K4 is a split-KV ("flash-decoding") kernel: one block per (sequence, KV
// head, split of the page table), the split count chosen on the host so
// that the grid has at least about two blocks an SM. A block walks its
// pages below ceil(length / page) as K3 does, with its K and V chunks
// double-buffered by 16-byte cp.async copies (the next chunk in flight
// while this one is used), and writes its (m, l, acc) to an f32
// workspace; a block whose pages all lie at or past `length` writes m =
// -1e30 and l = 0 and nothing else. A second kernel merges the splits of
// each query head in split order (deterministic): M = max m over splits
// with l > 0, out = sum e^(m - M) acc / sum e^(m - M) l. A sequence whose
// tokens all fall in one split gets K3's answer exactly.
//
// Length 0: the TPU kernels average V over the table's pages (every score
// is -1e30, so p = exp(0)); these kernels walk no page and write 0. The
// engine always passes lengths >= 1.
//
// Bound: memory bandwidth. A decode step reads every live K/V byte once
// per query group and does about 4 * G flops per K/V element (two dot
// products), far below the ~300 flops/byte where Hopper turns compute
// bound. So the design spends its effort on having loads in flight. In K2
// and K3 each chunk's K and V tiles come in together as 16-byte vector
// loads (all of a 64 x 128 bf16 chunk in one round trip) and are widened
// to f32 in shared memory (K with an odd row stride, so the per-token dot
// products below hit distinct banks); K4 keeps them in the input type,
// K's rows padded by 16 bytes for the same reason. Then one thread per
// (query row, token) takes a dot product, one warp per row runs the
// softmax update, and one thread per (row, dim) the P.V update. What is
// left: K2 and K3 wait for each chunk before they compute and leave SMs
// idle at small batches (the split mapping is offered to them in a later
// change, once their times can be ranked); wgmma and TMA are for later
// work too.

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

// Shared memory, in floats: q and acc (G x D each), scores (G x tile),
// m, l, alpha (G each), a K tile (tile x (D + 1)) and a V tile (tile x D).
size_t smem_floats(int G, int D, int tile) {
  return 2 * (size_t)G * D + (size_t)G * tile + 3 * (size_t)G +
         (size_t)tile * (2 * D + 1);
}

// Tokens per chunk: the page up to 64, halved until shared memory fits.
int pick_tile(int G, int D, int page) {
  int tile = page < kMaxTile ? page : kMaxTile;
  while (tile > 1 && smem_floats(G, D, tile) * sizeof(float) > kMaxSmemBytes)
    tile /= 2;
  return tile;
}

// K and V rows [0, tt) of one page chunk into shared memory as f32, by
// 16-byte vector loads (D * sizeof(T) is a multiple of 16 and the pools
// are 16-byte aligned: the wrapper checks both).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ k_src,
                                           const T* __restrict__ v_src,
                                           float* k_s, float* v_s, int tt,
                                           int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = tt * D / kVec;
  const uint4* kv = reinterpret_cast<const uint4*>(k_src);
  const uint4* vv = reinterpret_cast<const uint4*>(v_src);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 kr = kv[i];
    const uint4 vr = vv[i];
    const T* ke = reinterpret_cast<const T*>(&kr);
    const T* ve = reinterpret_cast<const T*>(&vr);
    const int flat = i * kVec;
    const int t = flat / D;
    const int d = flat - t * D;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      k_s[t * (D + 1) + d + j] = to_float(ke[j]);
      v_s[flat + j] = to_float(ve[j]);
    }
  }
}

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

// acc = alpha * acc + p @ v over one chunk (V rows of D, in f32 or the
// input type): one thread per (row, dim).
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

// K2 and K3: one block per (sequence, KV head).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
    int D, int page, int NP, int tile, float sm_scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int GD = G * D;
  float* q_s = smem;
  float* acc_s = q_s + GD;
  float* s_s = acc_s + GD;  // scores, then probabilities, of one chunk
  float* m_s = s_s + G * tile;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  float* k_s = alpha_s + G;
  float* v_s = k_s + tile * (D + 1);

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int length = lengths[b];
  const int n_pages = min((length + page - 1) / page, NP);
  const int* table = tables + (size_t)b * NP;
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_float(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int pi = 0; pi < n_pages; ++pi) {
    const size_t base = (((size_t)table[pi] * Hkv + h) * page) * D;
    for (int t0 = 0; t0 < page; t0 += tile) {
      const int tok0 = pi * page + t0;
      if (tok0 >= length) break;  // wholly masked: adds nothing
      const int tt = min(tile, page - t0);
      load_chunk<T>(k_pool + base + (size_t)t0 * D,
                    v_pool + base + (size_t)t0 * D, k_s, v_s, tt, D);
      __syncthreads();

      // Scores: one thread per (query row, token).
      for (int i = tid; i < G * tt; i += kThreads) {
        const int g = i / tt;
        const int t = i - g * tt;
        const float* q_row = q_s + g * D;
        const float* k_row = k_s + t * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(q_row[d], k_row[d], dot);
        s_s[g * tile + t] = tok0 + t < length ? dot * sm_scale : kNegInf;
      }
      __syncthreads();
      softmax_update(s_s, m_s, l_s, alpha_s, G, tt, tile);
      __syncthreads();
      pv_update(acc_s, s_s, alpha_s, v_s, G, D, tt, tile);
      __syncthreads();
    }
  }

  __syncthreads();  // the q/acc init above when no chunk ran
  for (int i = tid; i < GD; i += kThreads) {
    const float l = l_s[i / D];
    out[row0 + i] = from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// K4: split-KV decode.
// ---------------------------------------------------------------------------

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
// min((split + 1) * pps, NP, ceil(length / page))). Writes, for each of
// the G query heads, (m, l, acc[D]) at part[((b H + h G + g) * splits +
// split) * (D + 2)].
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
  const int p_begin = split * pps;
  const int p_end =
      min(min(p_begin + pps, NP), (length + page - 1) / page);
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

  // Chunks of `tile` tokens, page by page, up to the last live token.
  const int per_page = (page + tile - 1) / tile;
  const int live = min(length, p_end * page) - p_begin * page;
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
    // time, summed over d in order as K3 sums them.
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
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int B,
                   int H, int Hkv, int D, int page, int NP, float sm_scale,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const int tile = pick_tile(G, D, page);
  const size_t smem = smem_floats(G, D, tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D, page,
      NP, tile, sm_scale);
  return cudaGetLastError();
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
// on the current device. K2 and K3. Returns the cudaError_t of the launch.
extern "C" int paged_decode(int dtype, const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, int B, int H,
                            int Hkv, int D, int page, int NP, float sm_scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, H, Hkv,
                           D, page, NP, sm_scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                   H, Hkv, D, page, NP, sm_scale, s);
    case 2:
      return launch<__half>(q, k_pool, v_pool, tables, lengths, out, B, H, Hkv,
                            D, page, NP, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
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

// Shared memory one block needs for G query rows per KV head, head dim D,
// pages of `page` tokens and `item`-byte elements; `split` for K4's
// kernel, else K2's and K3's (above kMaxSmemBytes the launch would fail).
extern "C" size_t paged_decode_smem_bytes(int G, int D, int page, int item,
                                          int split) {
  if (split)
    return split_smem_bytes(G, D, pick_split_tile(G, D, page, item), item);
  return smem_floats(G, D, pick_tile(G, D, page)) * sizeof(float);
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
