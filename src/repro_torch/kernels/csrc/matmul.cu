// Matrix product for Hopper (sm_90a): C = A @ B with A (M, K), B (K, N),
// C (M, N) in the inputs' dtype, f32 accumulation.  Three kernels, one per
// route; the wrapper (kernels/matmul.py, `matmul_route`) picks one from the
// dtype, M and the operands' alignment before the launch:
//
//   * `matmul_wgmma` (route "matmul"): bf16, M > 1 (or any M when the
//     caller names a tile), row strides and bases TMA can take (16-byte
//     multiples).  One CTA per (bm, bn) output tile:
//     bm / 64 consumer warpgroups of 64 rows each issue `wgmma` on the
//     tensor cores with the f32 accumulator in registers, and one producer
//     warp keeps a ring of 4 shared-memory stages filled by TMA (A and B
//     tiles in bf16 with the 128-byte swizzle, completion on mbarriers), so
//     the next k tiles' loads run under this tile's math.  A (row-major) is
//     K-major for wgmma; B (row-major) is N-major and read through wgmma's
//     transpose bit, so no copy of B is made.  TMA zero-fills the ragged M,
//     N and K edges; the epilogue masks the store and writes bf16.  Tiles:
//     bm 64 or 128, bn 64, 128 or 256, bk 64 (one swizzle row of bf16).
//   * `matmul_gemv` (route "matmul_gemv"): bf16, M < 64 in groups of 8
//     rows; the route sends it only M = 1 (GEMM_FC), the one M where it
//     beat the wgmma kernel's 64-row tile on the H100.
//     Bound by bytes: B is read once per row group with 16-byte loads by
//     (64-column strip x K split) CTAs, enough for several per SM; each CTA writes f32
//     partials to a scratch the wrapper allocates, and a second small
//     kernel sums the splits in a fixed order (deterministic, no atomics).
//   * `matmul_simt` (route "matmul_simt"): f32, or operands TMA cannot
//     take.  The first port's CUDA-core kernel, described below.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py:21,
// entry `matmul_pallas`).
//
// What bounds it on the H100: operations for a square GEMM (GEMM_1K does
// 2 x 1024^3 flops on 6 MB: ~340 flop/byte, above the card's ~295), bytes
// for a GEMV (GEMM_FC, M = 1, reads its 75 MB weight once).
//
// The CUDA-core kernel (route "matmul_simt"):
//   * the TPU kernel's sequential `k` grid axis and its VMEM accumulator
//     become one CTA per (bm, bn) output tile that loops over k itself and
//     keeps the f32 accumulator in registers (TM x 4 values a thread);
//   * A and B tiles are staged in shared memory as f32 (A k-major and
//     padded by one column, so its transposed stores hit distinct banks);
//   * the ragged M, N and K edges are masked in the loads and the store;
//   * the tiles are exactly those `core/cuda_bridge.matmul_block_shapes`
//     can return for this route (bm 8..128, bn 64 or 128, bk 32 or 64).
//
// Launch contract (checked by the Python wrapper): A and B row-major with
// unit column stride, row strides lda / ldb; C contiguous (ldc = N).  Each
// entry point returns cudaGetLastError(), -1 for a tile or dtype this file
// does not build, or -2 when a TMA descriptor cannot be encoded.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// route "matmul": wgmma + TMA ring
// ---------------------------------------------------------------------------

constexpr int WG_STAGES = 4;

template <int BM, int BN>
struct WgTile {
  static constexpr int CONSUMERS = BM / 64;             // warpgroups
  static constexpr int THREADS = CONSUMERS * 128 + 32;  // + a producer warp
  static constexpr int A_BYTES = BM * 128;              // BM rows x 64 bf16
  static constexpr int B_BYTES = BN * 128;  // BN / 64 atoms x 64 k rows
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = WG_STAGES * STAGE + 2 * WG_STAGES * 8 + 1024;
};

template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM, BN>::THREADS, 1)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using T = WgTile<BM, BN>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * T::STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int nk = (K + 63) / 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == T::CONSUMERS) {  // the producer warp: one lane issues the TMA
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(&empty[s], ((kt / WG_STAGES) & 1) ^ 1);
        unsigned char* a_s = smem + s * T::STAGE;
        unsigned char* b_s = a_s + T::A_BYTES;
        mbar_expect_tx(&full[s], T::STAGE);
        tma_load_2d(a_s, &ta, &full[s], kt * 64, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(b_s + c * 8192, &tb, &full[s], n0 + 64 * c, kt * 64);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    const unsigned char* a_s = smem + s * T::STAGE + wg * 64 * 128;
    const unsigned char* b_s = smem + s * T::STAGE + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<BN>::template ss<1>(acc, desc_sw128(a_s + 32 * kk, 16, 1024),
                              desc_sw128(b_s + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    // keep this tile's wgmma in flight; the previous one has finished
    // reading its stage, which goes back to the producer
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      __nv_bfloat16* p = C + (long long)row * N + col;
      const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16(x0);
        if (col + 1 < N) p[1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int BM, int BN>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                 int M, int N, int K, cudaStream_t s) {
  using T = WgTile<BM, BN>;
  auto kern = mm_wgmma_kernel<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "matmul_gemv": split-K skinny product, then a fixed-order reduction
// ---------------------------------------------------------------------------

constexpr int GV_COLS = 64;      // columns of a CTA: 8 vectors of 8 bf16
constexpr int GV_THREADS = 256;  // 8 column vectors x 32 k lanes
constexpr int GV_UNROLL = 4;     // 16-byte loads in flight per thread

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int n, int N,
                                      float (&x)[8]) {
  if (n + 8 <= N) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + n));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = (n + e < N) ? __bfloat162float(row[n + e]) : 0.f;
  }
}

// One CTA: rows [m0, m0 + MT) of A, columns [64 x, 64 x + 64) of B, k in
// [split * kchunk, (split + 1) * kchunk).  Thread (kl, cv) sums k = kl,
// kl + 32, ... for its 8 columns; the 32 k lanes are summed in a fixed
// order and the CTA writes its f32 partial.
template <int MT>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B, float* __restrict__ part,
                int M, int N, int K, long long lda, long long ldb,
                int kchunk) {
  __shared__ float red[GV_THREADS / 32][MT][GV_COLS];
  const int cv = threadIdx.x % 8, kl = threadIdx.x / 8;
  const int n = blockIdx.x * GV_COLS + cv * 8;
  const int split = blockIdx.y, m0 = blockIdx.z * MT;
  const int kb = split * kchunk, ke = min(K, kb + kchunk);
  const __nv_bfloat16* arow[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)  // rows past M read row M - 1, not stored
    arow[mi] = A + (long long)min(m0 + mi, M - 1) * lda;

  float acc[MT][8];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[mi][e] = 0.f;

  if (n < N) {
    int k = kb + kl;
    for (; k + 32 * (GV_UNROLL - 1) < ke; k += 32 * GV_UNROLL) {
      float b[GV_UNROLL][8];
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u)
        load8(B + (long long)(k + 32 * u) * ldb, n, N, b[u]);
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float a = __bfloat162float(arow[mi][k + 32 * u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[mi][e] += a * b[u][e];
        }
    }
    for (; k < ke; k += 32) {
      float b[8];
      load8(B + (long long)k * ldb, n, N, b);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float a = __bfloat162float(arow[mi][k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[mi][e] += a * b[e];
      }
    }
  }
  // lanes l, l ^ 8, l ^ 16, l ^ 24 of a warp share their columns
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = acc[mi][e];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[mi][e] = v;
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < 8) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp][mi][lane * 8 + e] = acc[mi][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * GV_COLS; i += GV_THREADS) {
    const int mi = i / GV_COLS, c = i % GV_COLS;
    const int m = m0 + mi, nn = blockIdx.x * GV_COLS + c;
    if (m >= M || nn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GV_THREADS / 32; ++w) s += red[w][mi][c];
    part[((long long)split * M + m) * N + nn] = s;
  }
}

// C = sum over splits of part[split], in split order, rounded to bf16.
__global__ void __launch_bounds__(256)
    gemv_reduce_kernel(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ C, long long MN,
                       int splits) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= MN) return;
  float s = part[i];
  for (int p = 1; p < splits; ++p) s += part[p * MN + i];
  C[i] = __float2bfloat16(s);
}

template <int MT>
int launch_gemv(const void* a, const void* b, void* c, void* part, int M,
                int N, int K, long long lda, long long ldb, int splits,
                int kchunk, cudaStream_t s) {
  dim3 grid((N + GV_COLS - 1) / GV_COLS, splits, (M + MT - 1) / MT);
  gemv_kernel<MT><<<grid, GV_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(part), M, N,
      K, lda, ldb, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long MN = (long long)M * N;
  gemv_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(c), MN,
      splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "matmul_simt": the CUDA-core kernel
// ---------------------------------------------------------------------------


__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int BM, int BN>
struct Layout {
  static constexpr int TN = 4;                        // columns a thread owns
  static constexpr int THREADS = (BM * BN / TN < 256) ? BM * BN / TN : 256;
  static constexpr int COLS = BN / TN;                // threads across a row
  static constexpr int ROWS_PASS = THREADS / COLS;    // rows covered per pass
  static constexpr int TM = BM / ROWS_PASS;           // rows a thread owns
  static_assert(TM >= 1 && TM * ROWS_PASS == BM, "tile layout");
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(Layout<BM, BN>::THREADS)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int M, int N, int K, long long lda,
                  long long ldb, long long ldc) {
  using L = Layout<BM, BN>;
  extern __shared__ float smem[];
  float* Bs = smem;                 // [BK][BN]
  float* As = Bs + BK * BN;         // [BK][BM + 1], k-major
  const int tid = threadIdx.x;
  const int tc = tid % L::COLS, tr = tid / L::COLS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[L::TM][L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += L::THREADS) {
      const int r = i / BK, c = i % BK;             // c fastest: coalesced
      const int m = m0 + r, k = k0 + c;
      As[c * (BM + 1) + r] =
          (m < M && k < K) ? to_f(A[(long long)m * lda + k]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += L::THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r * BN + c] =
          (k < K && n < N) ? to_f(B[(long long)k * ldb + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k * BN + tc * 4]);
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const float a = As[k * (BM + 1) + tr + i * L::ROWS_PASS];
        acc[i][0] += a * b.x;
        acc[i][1] += a * b.y;
        acc[i][2] += a * b.z;
        acc[i][3] += a * b.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + tr + i * L::ROWS_PASS;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int n = n0 + tc * 4 + j;
      if (n < N) store(&C[(long long)m * ldc + n], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           long long lda, long long ldb, long long ldc, cudaStream_t s) {
  constexpr int smem = (BK * BN + BK * (BM + 1)) * (int)sizeof(float);
  auto kern = matmul_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, Layout<BM, BN>::THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, lda, ldb, ldc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int bm, int bn, int bk, const void* a, const void* b, void* c,
             int M, int N, int K, long long lda, long long ldb, long long ldc,
             cudaStream_t s) {
#define TILE(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_)                               \
    return launch<T, BM_, BN_, BK_>(a, b, c, M, N, K, lda, ldb, ldc, s);
#define BM_ROW(BM_) \
  TILE(BM_, 64, 32) TILE(BM_, 64, 64) TILE(BM_, 128, 32) TILE(BM_, 128, 64)
  BM_ROW(8) BM_ROW(16) BM_ROW(32) BM_ROW(64) BM_ROW(128)
#undef BM_ROW
#undef TILE
  return -1;
}

}  // namespace

// bf16 A (M, K) and B (K, N) with 16-byte row strides and bases; tile
// (bm, bn) of {64, 128} x {64, 128, 256}.
extern "C" int matmul_wgmma(const void* a, const void* b, void* c, int M,
                            int N, int K, long long lda, long long ldb,
                            int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  const uint64_t adims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t astr[1] = {(uint64_t)lda * 2};
  const uint32_t abox[2] = {64, (uint32_t)bm};
  const uint64_t bdims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t bstr[1] = {(uint64_t)ldb * 2};
  const uint32_t bbox[2] = {64, 64};
  if (bm != 64 && bm != 128) return -1;
  if (hopper_host::encode_bf16(&ta, 2, a, adims, astr, abox) != 0 ||
      hopper_host::encode_bf16(&tb, 2, b, bdims, bstr, bbox) != 0)
    return -2;
#define WG(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch_wgmma<BM_, BN_>(ta, tb, c, M, N, K, s);
  WG(64, 64) WG(64, 128) WG(64, 256) WG(128, 64) WG(128, 128) WG(128, 256)
#undef WG
  return -1;
}

// bf16 A (M, K), M < 64, and B (K, N) with a 16-byte row stride and base;
// part: f32 scratch of splits x M x N; split s covers k in
// [s * kchunk, (s + 1) * kchunk).
extern "C" int matmul_gemv(const void* a, const void* b, void* c, void* part,
                           int M, int N, int K, long long lda, long long ldb,
                           int splits, int kchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS a, b, c, part, M, N, K, lda, ldb, splits, kchunk, s
  if (M <= 1) return launch_gemv<1>(ARGS);
  if (M <= 2) return launch_gemv<2>(ARGS);
  if (M <= 4) return launch_gemv<4>(ARGS);
  return launch_gemv<8>(ARGS);
#undef ARGS
}

// dtype: 0 = bf16, 1 = f32 (A, B and C share it).
extern "C" int matmul_simt(const void* a, const void* b, void* c, int dtype,
                           int M, int N, int K, long long lda, long long ldb,
                           long long ldc, int bm, int bn, int bk,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(bm, bn, bk, a, b, c, M, N, K, lda, ldb,
                                   ldc, s);
  if (dtype == 1)
    return dispatch<float>(bm, bn, bk, a, b, c, M, N, K, lda, ldb, ldc, s);
  return -1;
}
