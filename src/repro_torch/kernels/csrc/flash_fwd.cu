// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA,
// emitting the output `o` and the f32 row log-sum-exp `lse`.
//
// Replaces the TPU kernel `_fa_fwd_kernel`
// (src/repro/kernels/attention.py:153, entry `flash_attention_fwd_pallas`).
//
// What bounds it on the H100: operations.  At the prefill lengths that take
// this path (S >= 1024) a causal head does 2 x S^2 x D flops for 4 x S x D x 2
// bytes, hundreds of flops per byte.  The design keeps the S x S score matrix
// out of device memory and skips the masked half of it:
//   * one CTA per (q block, b * H + h); the CTA walks exactly the k-block
//     range [lo, hi] of its row in the pruned pair schedule, which the host
//     builds with the copied `_pair_schedule` / `_row_range` (fully masked
//     k blocks are never loaded); an empty range drains o = 0, lse = -1e30;
//   * GQA: the kv row is (b * H + h) / G, so the G heads of a group read the
//     same K/V blocks (through L2; each CTA loads its own copy to shared);
//   * q, k, v and o are read and written in the engine's (B, S, H, D) layout
//     through strides: no transposed or padded copy is made; rows past Sq
//     and keys past Sk load as zeros and are masked.
// The numerics follow the TPU kernel: the mask guard is applied before exp,
// so a fully masked row contributes 0; p is rounded to v's dtype before the
// PV product; m, l and acc stay in f32; l == 0 drains as 1 and
// lse = m + log(l).
// This first version computes on the CUDA cores in f32 from shared memory
// (64 x 64 score tile, 4 x 4 register tile per thread, 16 x 4 threads per
// row reduction).  Tensor-core `wgmma`, TMA loads and a pipeline of K/V
// stages are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Load a (64, D) tile of rows [row0, row0 + 64) into shared memory with a
// row pitch of D + 1 floats; rows at or past n_rows load as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_row, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, e = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + e] = row < n_rows ? to_f(src[row * s_row + e]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ ranges, int H, int G, int Sq, int Sk, int causal,
    int window, float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss) {
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][D + 1]
  float* kv_s = q_s + BQ * (D + 1);  // [BK][D + 1]: K, then V
  float* p_s = kv_s + BK * (D + 1);  // [BQ][BK + 1]

  const int iq = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = iq * BQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  load_tile<T, D>(q_s, qb, q_ss, q0, Sq);
  const int lo = ranges[2 * iq], hi = ranges[2 * iq + 1];
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // q_s written / last block's kv_s, p_s reads done
    load_tile<T, D>(kv_s, kb, k_ss, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int e = 0; e < D; ++e) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * (D + 1) + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kv_s[(tx + 16 * j) * (D + 1) + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // mask guard before exp: a fully masked tile adds exactly 0
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            round_to(p, static_cast<T*>(nullptr));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading K from kv_s
    load_tile<T, D>(kv_s, vb, v_ss, k0, Sk);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = kv_s[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float safe = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(&ob[row * o_ss + tx + 16 * j], acc[i][j] / safe);
    if (tx == 0) lse[(long long)bh * Sq + row] = m[i] + logf(safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* ranges, int B, int H, int G, int Sq, int Sk, int nq,
           int causal, int window, long long q_sb, long long q_sh,
           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, long long o_sb,
           long long o_sh, long long o_ss, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) +
                                         BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(ranges), H, G, Sq, Sk, causal, window, scale,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32; D: 64 or 128; window <= 0 means none.
// ranges: (nq, 2) int32 inclusive k-block range of each q block.
// Returns cudaGetLastError(), or -1 for a shape this file does not build.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* ranges, int dtype, int B,
                         int H, int G, int Sq, int Sk, int D, int nq,
                         int causal, int window, long long q_sb,
                         long long q_sh, long long q_ss, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, long long o_sb,
                         long long o_sh, long long o_ss, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                 \
  q, k, v, o, lse, ranges, B, H, G, Sq, Sk, nq, causal, window, q_sb, q_sh, \
      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, s
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(ARGS);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(ARGS);
  if (dtype == 1 && D == 128) return launch<float, 128>(ARGS);
  if (dtype == 1 && D == 64) return launch<float, 64>(ARGS);
#undef ARGS
  return -1;
}
