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
// Block mapping. One block per (sequence, KV head) for the single and
// batched kernels (heads_per_block = 1, grid (B, Hkv)); one block per
// sequence looping over all KV heads for the fused mapping
// (heads_per_block = Hkv, grid (B, 1)). A block serves the G = H / Hkv
// query heads that share its KV head, so each K/V page is read once per
// query group. Each block reads its own page indices from tables[b, i]
// (the TPU kernels had them in SMEM by scalar prefetch) and walks pages
// i < min(ceil(length / page), NP), skipping the chunks of the last page
// that lie wholly at or past `length`. For length >= 1 that gives the TPU
// grid's result: a chunk the TPU masks wholly adds exp(-1e30 - m) = 0 and
// leaves alpha = 1, and like the TPU grid it never reads past NP pages.
//
// Length 0: the TPU kernels average V over the table's pages (every score
// is -1e30, so p = exp(0)); this kernel walks no page and writes 0. The
// engine always passes lengths >= 1.
//
// Bound: memory bandwidth. A decode step reads every live K/V byte once
// per query group and does about 4 * G flops per K/V element (two dot
// products), far below the ~300 flops/byte where Hopper turns compute
// bound. So the design spends its effort on having loads in flight: each
// chunk's K and V tiles come in together as 16-byte vector loads (all of
// a 64 x 128 bf16 chunk in one round trip), are widened to f32 in shared
// memory (K with an odd row stride, so the per-token dot products below
// hit distinct banks), and then one thread per (query row, token) takes
// a dot product, one warp per row runs the softmax update, and one
// thread per (row, dim) the P.V update. What is left: a block still
// waits for each chunk before it computes (no double buffering), and a
// small batch leaves SMs idle (no split of a sequence's pages across
// blocks); wgmma and TMA are for later work too.

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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
    int D, int page, int NP, int tile, float sm_scale, int heads_per_block) {
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

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int n_pages = min((length + page - 1) / page, NP);
  const int* table = tables + (size_t)b * NP;

  for (int hh = 0; hh < heads_per_block; ++hh) {
    const int h = blockIdx.y * heads_per_block + hh;
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

        // Online-softmax update, one warp per query row.
        for (int g = warp; g < G; g += kWarps) {
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
        __syncthreads();

        // acc = alpha * acc + p @ v: one thread per (row, dim).
        for (int i = tid; i < GD; i += kThreads) {
          const int g = i / D;
          const int d = i - g * D;
          const float* p = s_s + g * tile;
          float pv = 0.f;
#pragma unroll 8
          for (int t = 0; t < tt; ++t) pv = fmaf(p[t], v_s[t * D + d], pv);
          acc_s[i] = acc_s[i] * alpha_s[g] + pv;
        }
        __syncthreads();
      }
    }

    __syncthreads();  // the q/acc init above when no chunk ran
    for (int i = tid; i < GD; i += kThreads) {
      const float l = l_s[i / D];
      out[row0 + i] = from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
    }
    __syncthreads();  // the next head reuses shared memory
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int B,
                   int H, int Hkv, int D, int page, int NP, float sm_scale,
                   int fused_heads, cudaStream_t stream) {
  const int G = H / Hkv;
  const int tile = pick_tile(G, D, page);
  const size_t smem = smem_floats(G, D, tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int heads_per_block = fused_heads ? Hkv : 1;
  const dim3 grid(B, Hkv / heads_per_block);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D, page,
      NP, tile, sm_scale, heads_per_block);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q and out (B, H, D); pools
// (P, Hkv, page, D), 16-byte aligned, with D a multiple of 8; tables
// (B, NP) int32 with entries in [0, P); lengths (B,) int32. All contiguous
// on the current device. Returns the cudaError_t of the launch.
extern "C" int paged_decode(int dtype, const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, int B, int H,
                            int Hkv, int D, int page, int NP, float sm_scale,
                            int fused_heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, H, Hkv,
                           D, page, NP, sm_scale, fused_heads, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                   H, Hkv, D, page, NP, sm_scale, fused_heads,
                                   s);
    case 2:
      return launch<__half>(q, k_pool, v_pool, tables, lengths, out, B, H, Hkv,
                            D, page, NP, sm_scale, fused_heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared memory one block needs for G query rows per KV head, head dim D
// and pages of `page` tokens (above kMaxSmemBytes the launch would fail).
extern "C" size_t paged_decode_smem_bytes(int G, int D, int page) {
  return smem_floats(G, D, pick_tile(G, D, page)) * sizeof(float);
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
