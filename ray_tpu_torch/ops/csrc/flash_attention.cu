// Flash attention for Hopper (sm_90a): the forward and its backward.
//
// Replaces, in ray_tpu/ops/attention.py:
//   _flash_fwd_kernel / _flash_forward   (K1, the Pallas forward)
//   _flash_backward                      (the lax.scan backward, which
//                                         the JAX package runs as XLA ops)
// and computes what they compute. Forward: s = (q . k) * sm_scale in f32,
// masked to -1e30 above the causal diagonal (top-left aligned) and at
// keys >= kv_len; an online softmax with the JAX guards (m_safe, p = 0
// for masked scores, alpha = 0 while the running max is masked); p
// rounded to the input type before P.V; out = acc / (l == 0 ? 1 : l) in
// the input type, lse = m + log(l), or -1e30 where l == 0. Backward:
// delta = rowsum(dO * O); P = exp(s - lse) recomputed with the same
// masks and, as in JAX, no guards; dV = P^T dO with P rounded to the
// input type; dS = P * (dO V^T - delta) * sm_scale rounded to the input
// type; dQ = dS K, dK = dS^T Q. Every sum is f32; outputs are in the
// input type.
//
// Block mapping. The TPU grid walks k-blocks in order and carries the
// softmax state in VMEM scratch; here one thread block owns one
// (batch, head, q tile) and loops over key tiles itself, with the running
// max, denominator and accumulator in registers. Causal
// tiles wholly above the diagonal are never visited (the loop ends at
// the last tile touching it), which is what `needed` and the clamped
// kv_index do on the TPU. Any Sq and Sk: the last tile of each is
// masked here, where the Pallas wrapper shrinks its blocks to divisors
// of S (and a prime S to one block); tile sizes change only the order
// of f32 sums. The backward has no atomics: a dK/dV kernel owns a block
// of keys and loops over the q tiles at and below the diagonal; a dQ
// kernel owns a block of q rows and loops over key tiles. Both recompute
// P and dS, so the backward does 7 tile products where a kernel with
// atomic dQ updates would do 5; the result is deterministic. A small
// pre-pass computes delta.
//
// Bound. At the training shapes (B 2, H 16, S 2048, D 128, causal,
// bf16) the forward does 4 * B * H * D * sum(keys per row) = 3.44e10
// flops: 34.8 us at 989 TFLOP/s, against 67 MB of q, k, v and out, 20 us
// at 3.35 TB/s. It is bound by operations. The backward's function has
// 5 tile products, 2.5x the forward's flops, about 87 us; the kernels
// below do 7 (they recompute S and dP on both sides). Two designs:
//
// - bf16 with D <= 128 (the training path): every tile product on wgmma,
//   on tiles that TMA loads into the 128-byte swizzle, three stages deep
//   (namespace wg): the forward, and the backward's dQ and dK/dV kernels.
//   The inputs must suit TMA: a 16-byte aligned base and (batch, head,
//   seq) strides that are multiples of 8 elements. Score accumulators are
//   reused in registers as the A operand of the next product. What is
//   left: no producer warp or register reallocation, and in each
//   warpgroup the exponentials run beside only the other warpgroup's
//   products (ROADMAP queue B).
// - f32 (and bf16 with D > 128): every product an f32 FMA on the CUDA
//   cores, exact as the 2e-5 and 1e-4 tolerances of the JAX tests need
//   (TF32 could not meet them), from f32 tiles in shared memory; 256
//   threads as a 16 x 16 grid, each holding a 4 x 4 block of scores and
//   4 rows x D/16 columns of accumulators in registers, so each
//   shared-memory load feeds 2 to 4 FMAs; rows padded to an odd stride so
//   that column reads hit distinct banks. Its bound is the 67 TFLOP/s of
//   f32 FMA.
//
// All schedule the longest causal tiles first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: ty = tid / 16, tx = tid % 16
constexpr float kNegInf = -1e30f;
constexpr float kMasked = kNegInf / 2;  // the JAX guards' test: x <= -5e29

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back, as `.astype(v.dtype)` before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Max and sum over the 16 lanes of a half warp: the threads of one row.
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A (B, H, S, D) tensor with a contiguous last dim; strides in elements.
struct View {
  const void* ptr;
  long long sb, sh, ss;
};

struct Args {
  View q, k, v, o, dout;
  const float* lse;  // (B, H, Sq) from the forward
  float* delta;      // (B, H, Sq) scratch of the backward
  void* out;         // forward outputs, contiguous
  float* lse_out;
  void* dq;  // backward outputs, contiguous
  void* dk;
  void* dv;
  int B, H, Sq, Sk, D;
  int kv_len;  // keys at or past kv_len are masked (Sk without a mask)
  int causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head(const View& t, int b, int h) {
  return static_cast<const T*>(t.ptr) + b * t.sb + h * t.sh;
}

// Rows [r0, r0 + rows) of one head into dst (row stride ld) as f32;
// rows at or past `limit` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long ss, int r0, int rows,
                                          int limit, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int gr = r0 + r;
    dst[r * ld + d] = gr < limit ? to_float(src[gr * ss + d]) : 0.f;
  }
}

// acc[i][j] = sum over d of a[(ty + 16 i) * ld + d] * b[(tx + 16 j) * ld + d]
template <int RA, int RB>
__device__ __forceinline__ void dot_rows(const float* a, const float* b,
                                         int ld, int D, int ty, int tx,
                                         float (&acc)[RA][RB]) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RA], bv[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < RB; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool masked(const Args& a, int row, int col) {
  return (a.causal && col > row) || col >= a.kv_len;
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, head, batch).
// ---------------------------------------------------------------------------

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DMAX <= 128 ? 2 : 1)
    flash_fwd_kernel(const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* q_s = smem;             // BQ x ld
  float* k_s = q_s + BQ * ld;    // BK x ld
  float* v_s = k_s + BK * ld;    // BK x D
  float* p_s = v_s + BK * D;     // BQ x (BK + 1)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const T* q = head<T>(a.q, b, h);
  const T* k = head<T>(a.k, b, h);
  const T* v = head<T>(a.v, b, h);
  const int q_end = min(q0 + BQ, a.Sq);
  const int k_end = a.causal ? min(a.kv_len, q_end) : a.kv_len;

  load_rows<T>(q_s, ld, q, a.q.ss, q0, BQ, a.Sq, D);

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are read
    load_rows<T>(k_s, ld, k, a.k.ss, k0, BK, a.Sk, D);
    load_rows<T>(v_s, D, v, a.v.ss, k0, BK, a.Sk, D);
    __syncthreads();

    float s[RQ][RK];
    dot_rows<RQ, RK>(q_s, k_s, ld, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float x =
            masked(a, row, k0 + tx + 16 * j) ? kNegInf : s[i][j] * a.scale;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kMasked ? 0.f : m_new;
      const float alpha = m[i] <= kMasked ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = s[i][j] <= kMasked ? 0.f : expf(s[i][j] - m_safe);
        sum += p;
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = round_to<T>(p);
      }
      sum = row_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pc[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pc[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = v_s[c * D + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pc[i], vv, acc[i][j]);
        }
      }
    }
  }

  const size_t bh = (size_t)b * a.H + h;
  T* out = static_cast<T*>(a.out) + bh * a.Sq * D;
  float* lse = a.lse_out + bh * a.Sq;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[(size_t)row * D + d] = from_float<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) lse[row] = l[i] == 0.f ? kNegInf : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// delta = rowsum(dO * O) in f32: one warp per row. The FMA kernels read
// it as (B, H, Sq). The wgmma kernels (kTiled) read, for each 64-row q
// tile of each (batch, head), 64 floats of lse * log2(e) and then 64 of
// delta, rows past Sq padded with 1e30 and 0 (so their P is 0).
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const Args a) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int S = kTiled ? (a.Sq + 63) / 64 * 64 : a.Sq;
  if (row >= (long long)a.B * a.H * S) return;  // the whole warp
  const int s = (int)(row % S);
  const int bh = (int)(row / S);
  float sum = 0.f;
  if (s < a.Sq) {
    const T* o = head<T>(a.o, bh / a.H, bh % a.H) + s * a.o.ss;
    const T* g = head<T>(a.dout, bh / a.H, bh % a.H) + s * a.dout.ss;
    for (int d = lane; d < a.D; d += 32)
      sum = fmaf(to_float(o[d]), to_float(g[d]), sum);
  }
  sum = warp_sum(sum);
  if (lane != 0) return;
  if (kTiled) {
    float* st = a.delta + ((size_t)bh * (S / 64) + s / 64) * 128 + s % 64;
    st[0] = s < a.Sq ? a.lse[(size_t)bh * a.Sq + s] * 1.4426950408889634f
                     : 1e30f;
    st[64] = sum;
  } else {
    a.delta[row] = sum;
  }
}

// Rows [q0, q0 + BQ) of lse and delta into shared memory (0 past Sq).
template <int BQ>
__device__ __forceinline__ void load_row_stats(const Args& a, size_t bh,
                                               int q0, float* lse_s,
                                               float* delta_s) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    lse_s[r] = row < a.Sq ? a.lse[bh * a.Sq + row] : 0.f;
    delta_s[r] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
  }
}

// P and dS of one (q tile, key tile) pair, rows ty + 16 i, columns
// tx + 16 j, from the scores s and dp = dO . V; rows past Sq give 0.
template <typename T, int RQ, int RK>
__device__ __forceinline__ void p_and_ds(const Args& a, int q0, int k0,
                                         int tx, int ty, const float* lse_s,
                                         const float* delta_s,
                                         float (&s)[RQ][RK],
                                         float (&dp)[RQ][RK]) {
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const float x =
          masked(a, row, k0 + tx + 16 * j) ? kNegInf : s[i][j] * a.scale;
      const float p = row < a.Sq ? expf(x - lse_s[r]) : 0.f;
      s[i][j] = round_to<T>(p);
      dp[i][j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * a.scale);
    }
  }
}

// dK and dV: one block per (key tile, head, batch).
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* k_s = smem;                  // BK x ld
  float* v_s = k_s + BK * ld;         // BK x ld
  float* q_s = v_s + BK * ld;         // BQ x ld
  float* do_s = q_s + BQ * ld;        // BQ x ld
  float* p_s = do_s + BQ * ld;        // BQ x (BK + 1)
  float* ds_s = p_s + BQ * (BK + 1);  // BQ x (BK + 1)
  float* lse_s = ds_s + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const size_t bh = (size_t)b * a.H + h;
  const T* q = head<T>(a.q, b, h);
  const T* dout = head<T>(a.dout, b, h);

  float dk[RK][RD], dv[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (k0 < a.kv_len) {  // keys past kv_len have P = 0: no gradient
    load_rows<T>(k_s, ld, head<T>(a.k, b, h), a.k.ss, k0, BK, a.Sk, D);
    load_rows<T>(v_s, ld, head<T>(a.v, b, h), a.v.ss, k0, BK, a.Sk, D);
    // Causal: rows above this tile's first key see none of its keys.
    for (int q0 = a.causal ? k0 / BQ * BQ : 0; q0 < a.Sq; q0 += BQ) {
      __syncthreads();  // the previous q tile is read
      load_rows<T>(q_s, ld, q, a.q.ss, q0, BQ, a.Sq, D);
      load_rows<T>(do_s, ld, dout, a.dout.ss, q0, BQ, a.Sq, D);
      load_row_stats<BQ>(a, bh, q0, lse_s, delta_s);
      __syncthreads();

      float s[RQ][RK], dp[RQ][RK];
      dot_rows<RQ, RK>(q_s, k_s, ld, D, ty, tx, s);
      dot_rows<RQ, RK>(do_s, v_s, ld, D, ty, tx, dp);
      p_and_ds<T, RQ, RK>(a, q0, k0, tx, ty, lse_s, delta_s, s, dp);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int at = (ty + 16 * i) * (BK + 1) + tx + 16 * j;
          p_s[at] = s[i][j];
          ds_s[at] = dp[i][j];
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: rows ty + 16 i of the key tile.
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], dsr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = p_s[r * (BK + 1) + ty + 16 * i];
          dsr[i] = ds_s[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float g = do_s[r * ld + d];
            const float x = q_s[r * ld + d];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              dv[i][j] = fmaf(pr[i], g, dv[i][j]);
              dk[i][j] = fmaf(dsr[i], x, dk[i][j]);
            }
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk) + bh * a.Sk * D;
  T* dv_out = static_cast<T*>(a.dv) + bh * a.Sk * D;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk_out[(size_t)key * D + d] = from_float<T>(dk[i][j]);
        dv_out[(size_t)key * D + d] = from_float<T>(dv[i][j]);
      }
    }
  }
}

// dQ: one block per (q tile, head, batch).
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* q_s = smem;                  // BQ x ld
  float* do_s = q_s + BQ * ld;        // BQ x ld
  float* k_s = do_s + BQ * ld;        // BK x ld
  float* v_s = k_s + BK * ld;         // BK x ld
  float* ds_s = v_s + BK * ld;        // BQ x (BK + 1)
  float* lse_s = ds_s + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const size_t bh = (size_t)b * a.H + h;
  const T* k = head<T>(a.k, b, h);
  const T* v = head<T>(a.v, b, h);
  const int q_end = min(q0 + BQ, a.Sq);
  const int k_end = a.causal ? min(a.kv_len, q_end) : a.kv_len;

  load_rows<T>(q_s, ld, head<T>(a.q, b, h), a.q.ss, q0, BQ, a.Sq, D);
  load_rows<T>(do_s, ld, head<T>(a.dout, b, h), a.dout.ss, q0, BQ, a.Sq, D);
  load_row_stats<BQ>(a, bh, q0, lse_s, delta_s);

  float dq[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous key tile is read
    load_rows<T>(k_s, ld, k, a.k.ss, k0, BK, a.Sk, D);
    load_rows<T>(v_s, ld, v, a.v.ss, k0, BK, a.Sk, D);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
    dot_rows<RQ, RK>(q_s, k_s, ld, D, ty, tx, s);
    dot_rows<RQ, RK>(do_s, v_s, ld, D, ty, tx, dp);
    p_and_ds<T, RQ, RK>(a, q0, k0, tx, ty, lse_s, delta_s, s, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j)
        ds_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ += dS K: rows ty + 16 i of the q tile.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsc[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsc[i] = ds_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kv = k_s[c * ld + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) dq[i][j] = fmaf(dsc[i], kv, dq[i][j]);
        }
      }
    }
  }

  T* dq_out = static_cast<T*>(a.dq) + bh * a.Sq * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq_out[(size_t)row * D + d] = from_float<T>(dq[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fragment helpers of the tensor-core kernels (namespace wg). A wgmma
// accumulator is laid out, warp by warp, as mma.sync's m16n8 C fragments:
// g = lane / 4 and c = 2 (lane % 4) index rows (g and g + 8) and column
// pairs. Two such 16 x 8 tiles, rounded to bf16, are lane for lane the A
// operand of a 16-deep product from registers (P.V, dS K, P^T dO,
// dS^T Q), which is where JAX rounds P and dS.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

// The A operand of a 16 x 16 product from two 16 x 8 accumulator tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4], const float (&l)[4],
                                         const float (&r)[4]) {
  f[0] = pack(l[0], l[1]);
  f[1] = pack(l[2], l[3]);
  f[2] = pack(r[0], r[1]);
  f[3] = pack(r[2], r[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Writes rows r0 + g and r0 + g + 8 (below `limit`) of a warp's 16 x D
// accumulators to a contiguous head, in bf16.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, int r0, int limit,
                                           int D, const float (&acc)[DP / 8][4],
                                           int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= limit) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + c;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(out + (size_t)row * D + d) =
            pack(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The bf16 forward for D <= 128 on wgmma and TMA.
//
// One block of two warpgroups (256 threads) owns 128 q rows of one
// (batch, head), 64 rows per warpgroup, and loops over key tiles of 128.
// Tiles arrive by TMA in the 128-byte swizzle that wgmma reads: the Q
// tile once, and K and V in a ring of three stages, so that tiles j + 1
// and j + 2 are in flight while tile j is used. Thread 0 loads the first
// tiles; a stage is refilled by the last of the block's eight warps to be
// done with it. Out-of-bounds rows and columns arrive as zeros, so ragged
// S and D < DP need no code. Each tile:
//   S = Q K^T    wgmma m64n128k16, Q and K from shared memory (K-major);
//   softmax      in registers: a warp's part of the accumulator is laid out
//                as mma.sync's m16n8 C fragments (rows g and g + 8, two
//                columns per lane), so a row's max and sum are two quad
//                shuffles; exp2 with scale * log2(e) folded into one FFMA;
//                masks only on tiles that cross the diagonal or kv_len;
//   O += P V     wgmma m64n{DP}k16, P from registers as bf16 (where JAX
//                rounds it), V from shared memory (MN-major, transposed).
// A warpgroup issues tile j + 1's S = Q K^T and then tile j's O += P V,
// and runs tile j + 1's softmax while P V is on the tensor cores. No
// producer warp, no register reallocation, no ping-pong between the
// warpgroups: at the training shape the softmax, which overlaps neither
// its own warpgroup's S = Q K^T nor, by design, the other's products,
// adds about 40% to the kernel's time without it (PERF.md).
// ---------------------------------------------------------------------------

namespace wg {

using tc::bf16;
constexpr int kThreads = 256;  // two warpgroups
constexpr int BQ = 128, BK = 128, kStages = 3;
constexpr int kAtomCols = 64;   // bf16 columns in one 128-byte swizzled row
constexpr uint32_t kRowBytes = 128;

template <int DP>
constexpr size_t smem_bytes() {
  // Q, the K and V rings, mbarriers and counters, and slack to align
  // to 1024.
  return (size_t)(BQ + 2 * kStages * BK) * DP * sizeof(bf16) + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A load that never
// lands (a byte count that does not match its boxes) traps after about
// ten seconds instead of hanging the card.
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

// One box (64 columns x rows) of a (D, S, H, B) tensor map into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(s0),
      "r"(h), "r"(b)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
// K-major (Q, K): sbo = 1024, the stride between 8-row groups; lbo unused.
// MN-major (V): lbo = the stride between 64-column atoms, sbo = 1024
// between groups of 8 rows (keys, the reduction dim).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WG_ACC(j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_ACC8(j)                                                       \
  WG_ACC(j), WG_ACC(j + 1), WG_ACC(j + 2), WG_ACC(j + 3), WG_ACC(j + 4), \
      WG_ACC(j + 5), WG_ACC(j + 6), WG_ACC(j + 7)
#define WG_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define WG_REGS64                                                        \
  WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128) = or += A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) = or += A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B, A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_REGS64
#undef WG_REGS32
#undef WG_ACC8
#undef WG_ACC

// K and V tile j into stage j % kStages, counted on that stage's barrier.
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        uint32_t k_s, uint32_t v_s,
                                        uint32_t bars, int j, int h, int b) {
  constexpr uint32_t kTileBytes = BK * DP * sizeof(bf16);
  const int st = j % kStages;
  const uint32_t bar = bars + 8 * (1 + st);
  mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
  for (int t = 0; t < DP / kAtomCols; ++t) {
    const uint32_t at = st * kTileBytes + t * BK * kRowBytes;
    tma_load(k_s + at, k_map, bar, t * kAtomCols, j * BK, h, b);
    tma_load(v_s + at, v_map, bar, t * kAtomCols, j * BK, h, b);
  }
}

// exp2 on the special function unit; flushes results below 2^-126 to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile, in place: scores in raw units
// (the scale enters through sl2 = scale * log2(e), scale > 0: the kernel
// folds a scale <= 0 into Q first) become p; m and l move on, and alpha
// is the factor for O. Masks are tested only on a tile that crosses the
// diagonal or kv_len (`edge`). A masked score is -1e30, so exp2 of its
// FFMA is exactly 0, JAX's p = 0, with no test per element.
template <int NJ>
__device__ __forceinline__ void softmax(float (&s)[NJ][4], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Args& a, int k0, bool edge,
                                        const int (&rows)[2], int c,
                                        float sl2) {
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + jn * 8 + c + (e & 1);
      if (edge && ((a.causal && col > rows[e >> 1]) || col >= a.kv_len))
        s[jn][e] = kNegInf;
    }
  float mx[2] = {kNegInf, kNegInf}, neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], tc::quad_max(mx[r]));
    const float m_safe = m_new <= kMasked ? 0.f : m_new;
    alpha[r] = m[r] <= kMasked ? 0.f : exp2_approx((m[r] - m_safe) * sl2);
    neg[r] = -m_safe * sl2;
    m[r] = m_new;
  }
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[jn][e], sl2, neg[e >> 1]));
      s[jn][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + tc::quad_sum(sum[r]);
}

// S = Q K^T for this warpgroup's 64 rows over DP / 16 steps of 16
// columns: 32 bytes on within a 128-byte swizzled row, then on to the
// next 64-column atom. Issued, not waited for.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 8][4], uint32_t q_wg,
                                         uint32_t k_t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss_n128(s, desc(q_wg + (kk >> 2) * BQ * kRowBytes + col, 16, 1024),
                  desc(k_t + (kk >> 2) * BK * kRowBytes + col, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's 16-key steps: V's 16 keys are two 8-row groups
// (sbo), its DP columns one or two 64-column atoms (lbo). Issued, not
// waited for.
template <int NO>
__device__ __forceinline__ void issue_pv(float (&o)[NO][4],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_t) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
    wgmma_rs(o, pa[t], desc(v_t + t * 16 * kRowBytes, BK * kRowBytes, 1024));
  wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const Args a) {
  constexpr int kAtoms = DP / kAtomCols, NJ = BK / 8;
  constexpr uint32_t kQBytes = BQ * DP * sizeof(bf16);
  constexpr uint32_t kTileBytes = BK * DP * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1024 bytes, and wgmma finds its phase from
  // address bits: every tile starts on a 1024-byte boundary.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                // kStages tiles
  const uint32_t v_s = k_s + kStages * kTileBytes;   // kStages tiles
  const uint32_t bars = v_s + kStages * kTileBytes;  // q, then one a stage
  // Per stage, the warps done with its tile (a count that only grows).
  unsigned* released = reinterpret_cast<unsigned*>(
      smem_raw + (bars + 8 * (1 + kStages) - raw));
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = (lane & 3) * 2;
  const int wgi = tid >> 7;
  // Blocks launch in index order, and the q tile varies slowest: the
  // longest causal tiles of all heads go first. (Head by head instead
  // keeps a head's K and V in L2 while its tiles run, which pays once
  // the heads' K and V outgrow L2, not at the training shape: PERF.md.)
  const int n_bh = a.B * a.H;
  const int bh_i = blockIdx.x % n_bh, h = bh_i % a.H, b = bh_i / a.H;
  const int q0 = (gridDim.x / n_bh - 1 - blockIdx.x / n_bh) * BQ;
  const int r0 = q0 + wgi * 64 + ((tid >> 5) & 3) * 16;  // this warp's rows
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  const int q_end = min(q0 + BQ, a.Sq);
  const int k_end = a.causal ? min(a.kv_len, q_end) : a.kv_len;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto edge = [&](int k0) {
    return (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.kv_len;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i);
    for (int i = 0; i < kStages; ++i) released[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, kQBytes);
#pragma unroll
    for (int t = 0; t < kAtoms; ++t)
      tma_load(q_s + t * BQ * kRowBytes, &q_map, bars, t * kAtomCols, q0, h,
               b);
    for (int j = 0; j < kStages && j < n_tiles; ++j)
      load_kv<DP>(&k_map, &v_map, k_s, v_s, bars, j, h, b);
  }

  // The row max below must be the extreme that becomes the max once
  // scaled, so a scale <= 0 is folded into Q once (below): Q negated for a
  // negative scale (the max of -s is the min of s), zeroed for a zero
  // scale (every score 0, every unmasked p 1). `scale` is then |scale|,
  // or 1 for 0; a NaN scale stays NaN.
  const float scale = a.scale < 0.f    ? -a.scale
                      : a.scale == 0.f ? 1.f
                                       : a.scale;
  // scale * log2(e): p = exp2(s * sl2 - m * sl2) = exp(s * scale - m * scale).
  const float sl2 = scale * 1.4426950408889634f;
  float o[DP / 8][4], s[NJ][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[BK / 16][4];  // P of the tile in hand, bf16, as wgmma's A
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const uint32_t q_wg = q_s + wgi * 64 * kRowBytes;  // this warpgroup's rows
  auto kv_full = [&](int j) {
    return mbar_wait(bars + 8 * (1 + j % kStages), (j / kStages) & 1);
  };

  // Tile 0's scores and P.
  mbar_wait(bars, 0);
  if (a.scale <= 0.f) {  // block-uniform; a positive scale skips it
    const uint32_t flip = a.scale < 0.f ? 0x80008000u : 0u;
    uint32_t* qw = reinterpret_cast<uint32_t*>(smem_raw + (q_s - raw));
    for (int i = tid; i < (int)(kQBytes / 4); i += kThreads)
      qw[i] = flip ? qw[i] ^ flip : 0u;
    // Generic-proxy writes, then wgmma's async-proxy reads of Q.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  kv_full(0);
  wgmma_fence();
  issue_qk<DP>(s, q_wg, k_s);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(s, m, l, alpha, a, 0, edge(0), rows, c, sl2);
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) tc::acc_to_a(pa[t], s[2 * t], s[2 * t + 1]);

  // Each step issues tile j + 1's scores and then O += P_j V_j, and runs
  // the softmax of tile j + 1 while P_j V_j is on the tensor cores. The
  // last tile's P V follows the loop, so that no branch in the loop
  // decides what is in flight (ptxas would serialize the wgmmas).
  for (int j = 0; j + 1 < n_tiles; ++j) {
    kv_full(j + 1);
    fence_regs(o);
    wgmma_fence();
    issue_qk<DP>(s, q_wg, k_s + (j + 1) % kStages * kTileBytes);
    issue_pv(o, pa, v_s + j % kStages * kTileBytes);
    wgmma_wait<1>();  // the scores; P_j V_j may still run
    fence_regs(s);
    softmax(s, m, l, alpha, a, (j + 1) * BK, edge((j + 1) * BK), rows, c,
            sl2);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      tc::acc_to_a(pa[t], s[2 * t], s[2 * t + 1]);  // P rounded to bf16
    // Tile j's stage is read (its K by step j - 1, its V here): each warp
    // counts itself done with it after its wgmma wait, and the last of
    // the eight refills it with tile j + 3. No warp waits for another, so
    // one warpgroup's softmax can run beside the other's wgmmas.
    if (j + kStages < n_tiles && lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[j % kStages], 1) % (kThreads / 32) ==
          kThreads / 32 - 1) {
        __threadfence_block();
        load_kv<DP>(&k_map, &v_map, k_s, v_s, bars, j + kStages, h, b);
      }
    }
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv(o, pa, v_s + (n_tiles - 1) % kStages * kTileBytes);
  wgmma_wait<0>();
  fence_regs(o);

  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][2 * r] /= l_safe;
      o[n][2 * r + 1] /= l_safe;
    }
    // The one conversion back to natural log: m * scale is JAX's max.
    if ((lane & 3) == 0 && rows[r] < a.Sq)
      a.lse_out[bh * a.Sq + rows[r]] =
          l[r] == 0.f ? kNegInf : m[r] * scale + logf(l_safe);
  }
  tc::store_rows<DP>(static_cast<bf16*>(a.out) + bh * a.Sq * a.D, r0, a.Sq,
                     a.D, o, lane);
}

// ---------------------------------------------------------------------------
// The bf16 backward for D <= 128 on wgmma and TMA: a dQ kernel and a dK/dV
// kernel, after a pre-pass that writes each 64-row q tile's row stats,
// lse * log2(e) and delta, as 128 contiguous floats (rows past Sq: 1e30
// and 0, so that their P is exactly 0).
//
// Each block is two warpgroups that own 128 rows, 64 each: q rows in the
// dQ kernel, keys in the dK/dV kernel. TMA loads those rows' two tiles
// once (Q and dO, or K and V) and streams the other side's two tiles of
// 64 rows (K and V, or Q and dO, with the q tile's stats by a bulk copy)
// through a ring of three stages, refilled as in the forward. Every tile
// product is one of the forward's two wgmma forms:
//   dQ kernel     S = Q K^T, dP = dO V^T     ss, m64n64k16, K-major;
//                 dQ += dS K                 rs, dS from registers, K
//                                            MN-major (as the forward's V);
//   dK/dV kernel  S^T = K Q^T, dP^T = V dO^T ss, m64n64k16, K-major;
//                 dV += P^T dO, dK += dS^T Q rs, dO and Q MN-major.
// P = exp2(s * scale * log2(e) - lse * log2(e)), one FFMA and ex2, with
// no row max, so any scale works; masked elements (above the diagonal, at
// keys >= kv_len), tested only on tiles that cross either, get P = 0.
// P is rounded to bf16 for dV, dS = P (dP - delta) scale to bf16 for dQ
// and dK, as JAX rounds them. No atomics: both kernels recompute P, 7
// tile products where 5 would do, and the grads are deterministic.
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 128;  // a block's own rows
constexpr int kBwdTile = 64;   // rows of a streamed tile
constexpr int kStatFloats = 2 * kBwdTile;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
constexpr size_t bwd_smem_bytes() {
  // Two tiles of the block's rows, the ring of two streamed tiles and
  // their stats a stage, mbarriers and counters, slack to align to 1024.
  return (size_t)(2 * kBwdRows + 2 * kStages * kBwdTile) * DP * sizeof(bf16) +
         kStages * kStatFloats * sizeof(float) + 64 + 1024;
}

// `bytes` contiguous bytes from global memory, counted on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A tile of ROWS rows from s0 (its 64-column atoms one after another).
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows_tma(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int s0, int h,
                                              int b) {
#pragma unroll
  for (int t = 0; t < DP / kAtomCols; ++t)
    tma_load(dst + t * ROWS * kRowBytes, map, bar, t * kAtomCols, s0, h, b);
}

// d (64 x 64) = A B^T over DP: A this warpgroup's 64 of a 128-row tile,
// B a 64-row tile, both K-major. Issued, not committed.
template <int DP>
__device__ __forceinline__ void issue_ss64(float (&d)[8][4], uint32_t a_wg,
                                           uint32_t b_t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss_n64(d,
                 desc(a_wg + (kk >> 2) * kBwdRows * kRowBytes + col, 16, 1024),
                 desc(b_t + (kk >> 2) * kBwdTile * kRowBytes + col, 16, 1024),
                 kk > 0);
  }
}

// d (64 x DP) += A B over 64 rows of B: A from registers, B a 64-row
// tile read MN-major. Issued, not committed.
template <int NO>
__device__ __forceinline__ void issue_rs64(
    float (&d)[NO][4], const uint32_t (&a)[kBwdTile / 16][4], uint32_t b_t) {
#pragma unroll
  for (int t = 0; t < kBwdTile / 16; ++t)
    wgmma_rs(d, a[t],
             desc(b_t + t * 16 * kRowBytes, kBwdTile * kRowBytes, 1024));
}

template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&f)[N / 2][4],
                                       const float (&acc)[N][4]) {
#pragma unroll
  for (int t = 0; t < N / 2; ++t)
    tc::acc_to_a(f[t], acc[2 * t], acc[2 * t + 1]);
}

// Counts this warp done with stage `st`; the last of the block's eight
// warps refills it (`refill`). No warp waits for another.
template <typename Refill>
__device__ __forceinline__ void release(unsigned* released, int st, int lane,
                                        Refill refill) {
  if (lane == 0) {
    __threadfence_block();
    if (atomicAdd(&released[st], 1) % (kThreads / 32) == kThreads / 32 - 1) {
      __threadfence_block();
      refill();
    }
  }
}

// dQ: one block per 128 q rows of a (batch, head), longest causal rows
// first; loops over key tiles of 64.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const Args a) {
  constexpr int BQ = kBwdRows, BK = kBwdTile, NJ = BK / 8;
  constexpr uint32_t kOwnBytes = BQ * DP * sizeof(bf16);
  constexpr uint32_t kTileBytes = BK * DP * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + kOwnBytes;
  const uint32_t k_s = do_s + kOwnBytes;             // kStages tiles
  const uint32_t v_s = k_s + kStages * kTileBytes;   // kStages tiles
  const uint32_t bars = v_s + kStages * kTileBytes;  // own rows, then stages
  unsigned* released = reinterpret_cast<unsigned*>(
      smem_raw + (bars + 8 * (1 + kStages) - raw));
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = (lane & 3) * 2;
  const int wgi = tid >> 7;
  const int n_bh = a.B * a.H;
  const int bh_i = blockIdx.x % n_bh, h = bh_i % a.H, b = bh_i / a.H;
  const int q0 = (gridDim.x / n_bh - 1 - blockIdx.x / n_bh) * BQ;
  const int r0 = q0 + wgi * 64 + ((tid >> 5) & 3) * 16;  // this warp's rows
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  const int q_end = min(q0 + BQ, a.Sq);
  const int k_end = a.causal ? min(a.kv_len, q_end) : a.kv_len;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto edge = [&](int k0) {
    return (a.causal && k0 + BK - 1 > r0) || k0 + BK > a.kv_len;
  };
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    const uint32_t bar = bars + 8 * (1 + st);
    mbar_expect_tx(bar, 2 * kTileBytes);
    load_rows_tma<DP, BK>(k_s + st * kTileBytes, &k_map, bar, j * BK, h, b);
    load_rows_tma<DP, BK>(v_s + st * kTileBytes, &v_map, bar, j * BK, h, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i);
    for (int i = 0; i < kStages; ++i) released[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * kOwnBytes);
    load_rows_tma<DP, BQ>(q_s, &q_map, bars, q0, h, b);
    load_rows_tma<DP, BQ>(do_s, &do_map, bars, q0, h, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }

  // This thread's two rows: lse * log2(e) and delta from the pre-pass.
  const size_t bh = (size_t)b * a.H + h;
  const float* stats = a.delta + bh * ((a.Sq + BK - 1) / BK) * kStatFloats;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    const float* st = stats + row / BK * kStatFloats + row % BK;
    lse2[r] = row < a.Sq ? st[0] : 1e30f;
    dl[r] = row < a.Sq ? st[kBwdTile] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  // s and dp of a key tile; dp becomes dS in place.
  auto dscores = [&](float (&s)[NJ][4], float (&dp)[NJ][4], int k0) {
    const bool e_k = edge(k0);
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + jn * 8 + c + (e & 1);
        float p = exp2_approx(fmaf(s[jn][e], sl2, -lse2[r]));
        if (e_k && ((a.causal && col > rows[r]) || col >= a.kv_len)) p = 0.f;
        dp[jn][e] = p * (dp[jn][e] - dl[r]) * a.scale;
      }
  };

  float dq[DP / 8][4], s[NJ][4], dp[NJ][4];
  uint32_t ds_a[BK / 16][4];  // dS of the tile in hand, bf16, as wgmma's A
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const uint32_t q_wg = q_s + wgi * 64 * kRowBytes;
  const uint32_t do_wg = do_s + wgi * 64 * kRowBytes;
  auto kv_full = [&](int j) {
    return mbar_wait(bars + 8 * (1 + j % kStages), (j / kStages) & 1);
  };
  auto issue_scores = [&](int j) {
    const uint32_t at = j % kStages * kTileBytes;
    issue_ss64<DP>(s, q_wg, k_s + at);
    issue_ss64<DP>(dp, do_wg, v_s + at);
    wgmma_commit();
  };

  mbar_wait(bars, 0);
  kv_full(0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  dscores(s, dp, 0);
  pack_a(ds_a, dp);  // dS rounded to bf16

  // Each step issues tile j + 1's S and dP and then dQ += dS_j K_j, and
  // forms dS_{j+1} while dQ's product runs. The last tile's product
  // follows the loop, so that no branch in the loop decides what is in
  // flight.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    kv_full(j + 1);
    fence_regs(dq);
    wgmma_fence();
    issue_scores(j + 1);
    issue_rs64(dq, ds_a, k_s + j % kStages * kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S and dP; dQ's product may still run
    fence_regs(s);
    fence_regs(dp);
    dscores(s, dp, (j + 1) * BK);
    wgmma_wait<0>();
    fence_regs(dq);
    pack_a(ds_a, dp);
    if (j + kStages < n_tiles)
      release(released, j % kStages, lane, [&] { load_kv(j + kStages); });
  }
  fence_regs(dq);
  wgmma_fence();
  issue_rs64(dq, ds_a, k_s + (n_tiles - 1) % kStages * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  tc::store_rows<DP>(static_cast<bf16*>(a.dq) + bh * a.Sq * a.D, r0, a.Sq,
                     a.D, dq, lane);
}

// dK and dV: one block per 128 keys of a (batch, head), the keys with the
// most causal q rows first; loops over q tiles of 64 from the block's
// first key (causal) or 0.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const Args a) {
  constexpr int BK = kBwdRows, BQ = kBwdTile, NJ = BQ / 8;
  constexpr uint32_t kOwnBytes = BK * DP * sizeof(bf16);
  constexpr uint32_t kTileBytes = BQ * DP * sizeof(bf16);
  constexpr uint32_t kStatBytes = kStatFloats * sizeof(float);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kOwnBytes;
  const uint32_t q_s = v_s + kOwnBytes;               // kStages tiles
  const uint32_t do_s = q_s + kStages * kTileBytes;   // kStages tiles
  const uint32_t st_s = do_s + kStages * kTileBytes;  // kStages stats
  const uint32_t bars = st_s + kStages * kStatBytes;  // own rows, then stages
  const float* stats_s =
      reinterpret_cast<const float*>(smem_raw + (st_s - raw));
  unsigned* released = reinterpret_cast<unsigned*>(
      smem_raw + (bars + 8 * (1 + kStages) - raw));
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = (lane & 3) * 2;
  const int wgi = tid >> 7;
  const int n_bh = a.B * a.H;
  const int bh_i = blockIdx.x % n_bh, h = bh_i % a.H, b = bh_i / a.H;
  const int k0 = blockIdx.x / n_bh * BK;
  const int kw = k0 + wgi * 64 + ((tid >> 5) & 3) * 16;  // this warp's keys
  const int keys[2] = {kw + (lane >> 2), kw + (lane >> 2) + 8};
  // Causal: rows above the block's first key see none of its keys.
  const int q_start = a.causal ? k0 : 0;
  const int n_tiles = k0 < a.kv_len && q_start < a.Sq
                          ? (a.Sq - q_start + BQ - 1) / BQ
                          : 0;
  auto edge = [&](int q0) {
    return (a.causal && q0 < kw + 15) || kw + 16 > a.kv_len;
  };
  const size_t bh = (size_t)b * a.H + h;
  const float* stats = a.delta + (bh * ((a.Sq + BQ - 1) / BQ) + q_start / BQ) *
                                     kStatFloats;
  auto load_qdo = [&](int i) {
    const int st = i % kStages;
    const uint32_t bar = bars + 8 * (1 + st);
    mbar_expect_tx(bar, 2 * kTileBytes + kStatBytes);
    load_rows_tma<DP, BQ>(q_s + st * kTileBytes, &q_map, bar,
                          q_start + i * BQ, h, b);
    load_rows_tma<DP, BQ>(do_s + st * kTileBytes, &do_map, bar,
                          q_start + i * BQ, h, b);
    bulk_load(st_s + st * kStatBytes, stats + i * kStatFloats, kStatBytes,
              bar);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i);
    for (int i = 0; i < kStages; ++i) released[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bars, 2 * kOwnBytes);
    load_rows_tma<DP, BK>(k_s, &k_map, bars, k0, h, b);
    load_rows_tma<DP, BK>(v_s, &v_map, bars, k0, h, b);
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_qdo(i);
  }

  const float sl2 = a.scale * kLog2e;
  float dk[DP / 8][4], dv[DP / 8][4], sc[NJ][4], dpt[NJ][4];
  uint32_t p_a[BQ / 16][4], ds_a[BQ / 16][4];  // P^T and dS^T, bf16
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const uint32_t k_wg = k_s + wgi * 64 * kRowBytes;
  const uint32_t v_wg = v_s + wgi * 64 * kRowBytes;
  if (n_tiles > 0) mbar_wait(bars, 0);

  // Each step issues tile i's S^T and dP^T behind tile i - 1's dV and dK
  // products, waits for all, forms P^T and dS^T, and issues tile i's dV
  // and dK products, which run while the next step waits for its tile.
  for (int i = 0; i < n_tiles; ++i) {
    const int sti = i % kStages;
    const int q0 = q_start + i * BQ;
    mbar_wait(bars + 8 * (1 + sti), (i / kStages) & 1);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    issue_ss64<DP>(sc, k_wg, q_s + sti * kTileBytes);
    issue_ss64<DP>(dpt, v_wg, do_s + sti * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();  // and tile i - 1's dV and dK
    fence_regs(sc);
    fence_regs(dpt);
    fence_regs(dk);
    fence_regs(dv);
    if (i > 0 && i - 1 + kStages < n_tiles) {
      const int prev = (i - 1) % kStages;
      release(released, prev, lane, [&] { load_qdo(i - 1 + kStages); });
    }
    // Rows of S^T are keys, columns q rows: each column's stats.
    const float* lse2 = stats_s + sti * kStatFloats;
    const bool e_q = edge(q0);
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = jn * 8 + c + (e & 1), key = keys[e >> 1];
        float p = exp2_approx(fmaf(sc[jn][e], sl2, -lse2[qc]));
        if (e_q && ((a.causal && key > q0 + qc) || key >= a.kv_len)) p = 0.f;
        sc[jn][e] = p;
        dpt[jn][e] = p * (dpt[jn][e] - lse2[kBwdTile + qc]) * a.scale;
      }
    pack_a(p_a, sc);   // P rounded to bf16
    pack_a(ds_a, dpt);  // dS rounded to bf16
    wgmma_fence();
    issue_rs64(dv, p_a, do_s + sti * kTileBytes);
    issue_rs64(dk, ds_a, q_s + sti * kTileBytes);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  tc::store_rows<DP>(static_cast<bf16*>(a.dk) + bh * a.Sk * a.D, kw, a.Sk,
                     a.D, dk, lane);
  tc::store_rows<DP>(static_cast<bf16*>(a.dv) + bh * a.Sk * a.D, kw, a.Sk,
                     a.D, dv, lane);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTiled>
cudaError_t delta_pass(const Args& a, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / 32;
  const long long rows =
      (long long)a.B * a.H * (kTiled ? (a.Sq + 63) / 64 * 64 : a.Sq);
  return launch(flash_bwd_delta_kernel<T, kTiled>,
                dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock)),
                kThreads, 0, stream, a);
}

// CUDA-core kernels, for f32 (exact FMA) and for head dims above 128.
template <typename T, int DMAX>
cudaError_t run_fma(const Args& a, bool bwd, cudaStream_t stream) {
  const size_t ld = a.D + 1, f = sizeof(float);
  if (!bwd) {
    constexpr int BQ = 64, BK = 64;
    return launch(flash_fwd_kernel<T, DMAX, BQ, BK>,
                  dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), kThreads,
                  f * ((BQ + BK) * ld + BK * (size_t)a.D + BQ * (BK + 1)),
                  stream, a);
  }
  cudaError_t err = delta_pass<T, false>(a, stream);
  if (err != cudaSuccess) return err;
  {  // dK, dV: for D > 128 a 32-row q tile keeps four tiles in 227 KB
    constexpr int BQ = DMAX > 128 ? 32 : 64, BK = 64;
    err = launch(flash_bwd_dkdv_kernel<T, DMAX, BQ, BK>,
                 dim3((a.Sk + BK - 1) / BK, a.H, a.B), kThreads,
                 f * (2 * (BK + BQ) * ld + 2 * BQ * (BK + 1) + 2 * BQ),
                 stream, a);
    if (err != cudaSuccess) return err;
  }
  constexpr int BQ = 64, BK = DMAX > 128 ? 32 : 64;
  return launch(flash_bwd_dq_kernel<T, DMAX, BQ, BK>,
                dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), kThreads,
                f * (2 * (BQ + BK) * ld + BQ * (BK + 1) + 2 * BQ), stream, a);
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 (B, H, S, D) view as (D, S, H, B), strides in
// bytes, boxes of 64 columns by `rows`, 128-byte swizzle, zeros out of
// bounds. A dim of size 1 is never stepped over: it gets the stride a
// contiguous tensor would have, which TMA's multiple-of-16 rule accepts.
cudaError_t tile_map(CUtensorMap* map, const View& t, int B, int H, int S,
                     int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)t.ss * 2, (cuuint64_t)t.sh * 2,
                           (cuuint64_t)t.sb * 2};
  if (S == 1) strides[0] = (cuuint64_t)D * 2;
  if (H == 1) strides[1] = strides[0] * S;
  if (B == 1) strides[2] = strides[1] * H;
  const cuuint32_t box[4] = {(cuuint32_t)wg::kAtomCols, (cuuint32_t)rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t.ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 forward for D <= 128: tensor maps built for this call.
template <int DP>
cudaError_t run_fwd_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tile_map(&q_map, a.q, a.B, a.H, a.Sq, a.D, wg::BQ);
  if (err == cudaSuccess)
    err = tile_map(&k_map, a.k, a.B, a.H, a.Sk, a.D, wg::BK);
  if (err == cudaSuccess)
    err = tile_map(&v_map, a.v, a.B, a.H, a.Sk, a.D, wg::BK);
  if (err != cudaSuccess) return err;
  const auto kernel = wg::flash_fwd_wgmma_kernel<DP>;
  constexpr size_t smem = wg::smem_bytes<DP>();
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned n_q = (a.Sq + wg::BQ - 1) / wg::BQ;
  kernel<<<n_q * a.B * a.H, wg::kThreads, smem, stream>>>(q_map, k_map, v_map,
                                                          a);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, size_t smem, unsigned blocks,
                         cudaStream_t stream, const CUtensorMap& m0,
                         const CUtensorMap& m1, const CUtensorMap& m2,
                         const CUtensorMap& m3, const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, wg::kThreads, smem, stream>>>(m0, m1, m2, m3, a);
  return cudaGetLastError();
}

// The bf16 backward for D <= 128: the stats pre-pass, then the dK/dV and
// the dQ kernels, with a tensor map per operand and box height.
template <int DP>
cudaError_t run_bwd_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int kOwn = wg::kBwdRows, kTile = wg::kBwdTile;
  CUtensorMap q_own, do_own, k_tile, v_tile, k_own, v_own, q_tile, do_tile;
  const struct {
    CUtensorMap* map;
    const View& t;
    int S, rows;
  } maps[] = {{&q_own, a.q, a.Sq, kOwn},    {&do_own, a.dout, a.Sq, kOwn},
              {&k_tile, a.k, a.Sk, kTile},  {&v_tile, a.v, a.Sk, kTile},
              {&k_own, a.k, a.Sk, kOwn},    {&v_own, a.v, a.Sk, kOwn},
              {&q_tile, a.q, a.Sq, kTile},  {&do_tile, a.dout, a.Sq, kTile}};
  for (const auto& m : maps) {
    const cudaError_t err = tile_map(m.map, m.t, a.B, a.H, m.S, a.D, m.rows);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = delta_pass<wg::bf16, true>(a, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = wg::bwd_smem_bytes<DP>();
  const unsigned n_bh = a.B * a.H;
  err = launch_wgmma(wg::flash_bwd_dkdv_wgmma_kernel<DP>, smem,
                     (a.Sk + kOwn - 1) / kOwn * n_bh, stream, k_own, v_own,
                     q_tile, do_tile, a);
  if (err != cudaSuccess) return err;
  return launch_wgmma(wg::flash_bwd_dq_wgmma_kernel<DP>, smem,
                      (a.Sq + kOwn - 1) / kOwn * n_bh, stream, q_own, do_own,
                      k_tile, v_tile, a);
}

// Tensor-core kernels, for bf16 with D <= 128 (padded to DP).
template <int DP>
cudaError_t run_tc(const Args& a, bool bwd, cudaStream_t stream) {
  return bwd ? run_bwd_wgmma<DP>(a, stream) : run_fwd_wgmma<DP>(a, stream);
}

// Head dims are bucketed so each thread's accumulators are sized at
// compile time (columns past D are skipped or zero).
cudaError_t dispatch(int dtype, const Args& a, bool bwd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (a.D <= 64) return run_fma<float, 64>(a, bwd, s);
      if (a.D <= 128) return run_fma<float, 128>(a, bwd, s);
      return run_fma<float, 256>(a, bwd, s);
    case 1:
      if (a.D <= 64) return run_tc<64>(a, bwd, s);
      if (a.D <= 128) return run_tc<128>(a, bwd, s);
      return run_fma<__nv_bfloat16, 256>(a, bwd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

View view(const void* ptr, const long long* strides) {
  return View{ptr, strides[0], strides[1], strides[2]};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q (B, H, Sq, D), k and v (B, H, Sk, D),
// one dtype, each with a contiguous last dim; `strides` holds the
// (batch, head, seq) strides of q, k and v in elements. out (B, H, Sq, D)
// and lse (B, H, Sq) f32 are contiguous. 16 <= D <= 256, D % 8 == 0;
// 1 <= kv_len <= Sk; any scale. bf16 with D <= 128 is loaded by TMA: q,
// k and v need 16-byte aligned bases and strides that are multiples of 8
// (else cudaErrorInvalidValue). Launches on `stream`;
// returns the cudaError_t.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const long long* strides, void* out,
                         float* lse, int B, int H, int Sq, int Sk, int D,
                         float scale, int causal, int kv_len, void* stream) {
  Args a{};
  a.q = view(q, strides);
  a.k = view(k, strides + 3);
  a.v = view(v, strides + 6);
  a.out = out;
  a.lse_out = lse;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.kv_len = kv_len, a.causal = causal, a.scale = scale;
  return dispatch(dtype, a, false, stream);
}

// The backward of flash_fwd: q, k, v, out (the forward's) and dout, with
// their (batch, head, seq) strides in that order in `strides`; lse from
// the forward; delta f32 scratch of flash_bwd_scratch_floats() floats;
// dq, dk, dv contiguous in the input dtype. bf16 with D <= 128 loads q,
// k, v and dout by TMA, as flash_fwd does.
extern "C" int flash_bwd(int dtype, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         const long long* strides, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int H, int Sq, int Sk, int D, float scale, int causal,
                         int kv_len, void* stream) {
  Args a{};
  a.q = view(q, strides);
  a.k = view(k, strides + 3);
  a.v = view(v, strides + 6);
  a.o = view(o, strides + 9);
  a.dout = view(dout, strides + 12);
  a.lse = lse;
  a.delta = delta;
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.kv_len = kv_len, a.causal = causal, a.scale = scale;
  return dispatch(dtype, a, true, stream);
}

// Floats of flash_bwd's scratch: delta for the FMA kernels, each 64-row
// q tile's stats for the wgmma kernels.
extern "C" long long flash_bwd_scratch_floats(int dtype, int B, int H, int Sq,
                                              int D) {
  if (dtype == 1 && D <= 128) return (long long)B * H * ((Sq + 63) / 64) * 128;
  return (long long)B * H * Sq;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
