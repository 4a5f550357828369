// Output-stationary tiled GEMM for Hopper (sm_90a): C = A @ B with A (M, K),
// B (K, N), C (M, N), f32 accumulation, C in the inputs' dtype.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/matmul.py:21,
// entry `matmul_pallas`).
//
// What bounds it on the H100: operations for a square GEMM (GEMM_1K does
// 2 x 1024^3 flops on 6 MB: ~340 flop/byte, above the card's ~295), bytes
// for a GEMV (GEMM_FC, M = 1, reads its 75 MB weight once).  This first
// version computes on the CUDA cores in f32; `wgmma` with TMA-fed stages is
// the later step.  Its design:
//   * the TPU kernel's sequential `k` grid axis and its VMEM accumulator
//     become one CTA per (bm, bn) output tile that loops over k itself and
//     keeps the f32 accumulator in registers (TM x 4 values a thread);
//   * A and B tiles are staged in shared memory as f32 (A k-major and
//     padded by one column, so its transposed stores hit distinct banks);
//   * the ragged M, N and K edges are masked in the loads and the store:
//     nothing is padded by a copy, so GEMM_FC runs an 8-row tile whose rows
//     past M = 1 are zeros in shared memory and never stored;
//   * the tiles are exactly those `core/cuda_bridge.matmul_block_shapes`
//     can return (bm 8..128, bn 64 or 128, bk 32 or 64); the entry point
//     returns -1 for any other, and the wrapper raises before that.
//
// Launch contract (checked by the Python wrapper): A and B row-major with
// unit column stride, row strides lda / ldb; C contiguous (ldc = N).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// dtype: 0 = bf16, 1 = f32 (A, B and C share it).  Returns
// cudaGetLastError(), or -1 for a tile or dtype this file does not build.
extern "C" int matmul(const void* a, const void* b, void* c, int dtype, int M,
                      int N, int K, long long lda, long long ldb,
                      long long ldc, int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(bm, bn, bk, a, b, c, M, N, K, lda, ldb,
                                   ldc, s);
  if (dtype == 1)
    return dispatch<float>(bm, bn, bk, a, b, c, M, N, K, lda, ldb, ldc, s);
  return -1;
}
