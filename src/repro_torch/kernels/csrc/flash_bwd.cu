// Flash-attention backward for Hopper (sm_90a): causal / sliding-window GQA,
// from the forward's saved residuals lse (f32 row log-sum-exp) and
// delta = rowsum(o * do) (f32, computed by the caller).  Two kernels:
//
//   flash_bwd_dq   replaces `_fa_bwd_dq_kernel`
//                  (src/repro/kernels/attention.py:311)
//   flash_bwd_dkv  replaces `_fa_bwd_dkv_kernel`
//                  (src/repro/kernels/attention.py:360)
//
// (entry `flash_attention_bwd_pallas`).  Both emit f32 gradients; the
// caller casts them to the inputs' dtypes.
//
// What bounds them on the H100: operations.  Per unmasked (q, k) pair dq
// does 6 x D flops (s = q.k, dp = do.v, dq += ds.k) and dk/dv 8 x D (s, dp,
// dv += p.do, dk += ds.q), for 4 x S x D x 2 bytes of inputs per head: the
// same hundreds of flops per byte as the forward.  The design re-streams
// the forward's pruned schedule and keeps the S x S matrices p and ds out
// of device memory:
//   * dq: one CTA per (q block, b * H + h).  It walks that row's k-block
//     range [lo, hi] (the row-ordered pair table, `row_block_ranges`),
//     recomputes p = exp(s * scale - lse) under the mask guard, forms
//     ds = p * (do.v^T - delta) * scale in shared memory and accumulates
//     dq += ds.k in registers.  The q and do tiles stay in shared memory.
//   * dk/dv: one CTA per (k block, b * Hkv + hk).  It holds its K and V
//     tiles in shared memory and walks its column's q-block range (the
//     column-ordered pair table, `col_block_ranges`) and, inside it, the
//     G q heads of its GQA group, as the TPU kernel folds the group into
//     one tile.  dk and dv accumulate in registers.  Each output element
//     has exactly one writer: no atomics, so the result is the same from
//     run to run (the per-layer recompute depends on that).
//   * an empty range still drains: the CTA writes zeros (the outputs come
//     from torch.empty; the TPU kernel's sentinel pairs drain 0 there).
//   * q, k, v and do are read in the engine's (B, S, H, D) layout through
//     strides; rows past Sq and keys past Sk load as zeros and are masked.
// The numerics follow the TPU kernels: f32 scores from the inputs' values,
// the mask guard before exp (a fully masked row has lse = -1e30 and would
// otherwise come back as exp(0)), and f32 throughout (no rounding of p or
// ds).  This first version computes on the CUDA cores in f32 from shared
// memory (64 x 64 tiles, 4 x 4 register tile per thread), with more than
// 48 KB of dynamic shared memory per CTA.  Tensor-core `wgmma`, TMA loads
// and staged pipelines are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// s[i][j] = sum_e a[ty + 16 i][e] * b[tx + 16 j][e] for two (64, D) tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int e = 0; e < D; ++e) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (D + 1) + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += x[i] * y[j];
  }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int Sq, int Sk,
                                     int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    const int* __restrict__ ranges, int H, int G, int Sq, int Sk, int causal,
    int window, float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss) {
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][D + 1]
  float* do_s = q_s + BQ * (D + 1);   // [BQ][D + 1]
  float* k_s = do_s + BQ * (D + 1);   // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D + 1]
  float* ds_s = v_s + BK * (D + 1);   // [BQ][BK + 1]

  const int iq = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = iq * BQ;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  float* dqb = dq + b * dq_sb + h * dq_sh;

  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[(long long)bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int lo = ranges[2 * iq], hi = ranges[2 * iq + 1];
  if (lo <= hi) {
    load_tile<T, D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
    load_tile<T, D>(do_s, dout + b * do_sb + h * do_sh, do_ss, q0, Sq);
  }
  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // q_s / do_s written; last block's k_s, ds_s reads done
    load_tile<T, D>(k_s, kb, k_ss, k0, Sk);
    load_tile<T, D>(v_s, vb, v_ss, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, q_s, k_s, tx, ty);
    tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        // mask guard before exp: a masked entry adds exactly 0
        const float p = live(qpos, kpos, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        ds_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = k_s[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqb[row * dq_ss + tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, const int* __restrict__ ranges, int H, int G,
    int Sq, int Sk, int causal, int window, float scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D + 1]
  float* q_s = v_s + BK * (D + 1);    // [BQ][D + 1]
  float* do_s = q_s + BQ * (D + 1);   // [BQ][D + 1]
  float* p_s = do_s + BQ * (D + 1);   // [BQ][BK + 1]
  float* ds_s = p_s + BQ * (BK + 1);  // [BQ][BK + 1]

  const int ik = blockIdx.x;
  const int Hkv = H / G;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = ik * BK;

  // accumulators: key row ty + 16 i of the block, head-dim column tx + 16 j
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int lo = ranges[2 * ik], hi = ranges[2 * ik + 1];
  if (lo <= hi) {
    load_tile<T, D>(k_s, k + b * k_sb + hk * k_sh, k_ss, k0, Sk);
    load_tile<T, D>(v_s, v + b * v_sb + hk * v_sh, v_ss, k0, Sk);
  }
  for (int iq = lo; iq <= hi; ++iq) {
    const int q0 = iq * BQ;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long bh = (long long)b * H + h;
      __syncthreads();  // k_s / v_s written; last tile's reads done
      load_tile<T, D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
      load_tile<T, D>(do_s, dout + b * do_sb + h * do_sh, do_ss, q0, Sq);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(s, q_s, k_s, tx, ty);   // q row ty + 16 i, key tx + 16 j
      tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        const float l = qpos < Sq ? lse[bh * Sq + qpos] : 0.f;
        const float dl = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const float p = live(qpos, kpos, Sq, Sk, causal, window)
                              ? expf(s[i][j] * scale - l)
                              : 0.f;
          const int at = (ty + 16 * i) * (BK + 1) + tx + 16 * j;
          p_s[at] = p;
          ds_s[at] = p * (dp[i][j] - dl) * scale;
        }
      }
      __syncthreads();
      // dv += p^T do, dk += ds^T q over the tile's 64 q rows
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * (BK + 1) + ty + 16 * i];
          dsv[i] = ds_s[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = do_s[r * (D + 1) + tx + 16 * j];
          const float qv = q_s[r * (D + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] += pv[i] * dov;
            acc_k[i][j] += dsv[i] * qv;
          }
        }
      }
    }
  }

  float* dkb = dk + b * dk_sb + hk * dk_sh;
  float* dvb = dv + b * dv_sb + hk * dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[row * dk_ss + tx + 16 * j] = acc_k[i][j];
      dvb[row * dv_ss + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* ranges, int B, int H, int G, int Sq, int Sk,
              int nq, int causal, int window, const long long* st,
              float scale, cudaStream_t stream) {
  const int smem =
      (int)sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<const int*>(ranges), H, G, Sq, Sk,
      causal, window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* ranges, int B, int H, int G, int Sq, int Sk,
               int nk, int causal, int window, const long long* st,
               float scale, cudaStream_t stream) {
  const int smem =
      (int)sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nk, B * (H / G));
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(ranges), H, G, Sq, Sk, causal, window, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (q, k, v, do); D: 64 or 128; window <= 0 means
// none.  lse, delta: f32 (B * H, Sq) contiguous.  dq: f32, written through
// its strides.  ranges: (nq, 2) int32 inclusive k-block range of each q
// block (empty: lo > hi).  strides: (batch, head, seq) of q, k, v, do, dq.
// Returns cudaGetLastError(), or -1 for a shape this file does not build.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* ranges,
                            int dtype, int B, int H, int G, int Sq, int Sk,
                            int D, int nq, int causal, int window,
                            const long long* strides, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                              \
  q, k, v, dout, lse, delta, dq, ranges, B, H, G, Sq, Sk, nq, causal, \
      window, strides, scale, s
  if (dtype == 0 && D == 128) return launch_dq<__nv_bfloat16, 128>(ARGS);
  if (dtype == 0 && D == 64) return launch_dq<__nv_bfloat16, 64>(ARGS);
  if (dtype == 1 && D == 128) return launch_dq<float, 128>(ARGS);
  if (dtype == 1 && D == 64) return launch_dq<float, 64>(ARGS);
#undef ARGS
  return -1;
}

// As flash_bwd_dq, for dk and dv (f32, each written through its strides).
// ranges: (nk, 2) int32 inclusive q-block range of each k block.  strides:
// (batch, head, seq) of q, k, v, do, dk, dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* ranges, int dtype, int B, int H,
                             int G, int Sq, int Sk, int D, int nk,
                             int causal, int window,
                             const long long* strides, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                \
  q, k, v, dout, lse, delta, dk, dv, ranges, B, H, G, Sq, Sk, nk, causal, \
      window, strides, scale, s
  if (dtype == 0 && D == 128) return launch_dkv<__nv_bfloat16, 128>(ARGS);
  if (dtype == 0 && D == 64) return launch_dkv<__nv_bfloat16, 64>(ARGS);
  if (dtype == 1 && D == 128) return launch_dkv<float, 128>(ARGS);
  if (dtype == 1 && D == 64) return launch_dkv<float, 64>(ARGS);
#undef ARGS
  return -1;
}
