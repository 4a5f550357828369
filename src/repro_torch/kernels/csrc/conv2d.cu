// Direct 2-D convolution for Hopper (sm_90a): NHWC x HWIO -> NHWC, VALID
// padding, with stride and dilation; f32 accumulation, output in the
// input's dtype.
//
// Replaces the TPU kernel `_conv_kernel` (src/repro/kernels/conv2d.py:25,
// entry `conv2d_pallas`).
//
// What bounds it on the H100: operations for most of the paper's layers
// (2 x KH x KW x CI flops per output element against a few bytes each), bytes
// for the thin ones (CI 3 first layers, 1x1 layers with few channels).  The
// TPU kernel holds a halo of `block_oh` input rows by the whole width and a
// (KH, KW, CI, block_co) weight block in VMEM; at the catalog's shapes
// neither fits the 227 KB a CTA may hold (DL_ATROUS4 at block_oh 8: a 598 KB
// halo and a 590 KB weight block).  So this kernel is an implicit GEMM over
// smaller pieces:
//   * one CTA per (image, block of `block_oh` output rows, strip of output
//     columns, block of `block_co` output channels).  The CTA's 64 output
//     pixels are `block_oh` rows (rounded up to a power of two, rows past
//     `block_oh` idle) by 64 / that many columns;
//   * the (kh, kw, ci) reduction runs inside the CTA, tap by tap, with CI
//     streamed through shared memory in chunks of 32 channels: the input
//     pixels a tap reads (stride and dilation applied in the addresses) and
//     the tap's (32, block_co) weight slice are staged as f32;
//   * the f32 accumulator stays in registers (TM x 4 values a thread) and
//     is written once, at the end: the output is stationary as on the TPU;
//   * ragged OH, OW and CO edges (CO 27 and 125 in the catalog) and CI
//     chunks past CI are masked, not padded by a copy.
// Each input pixel is re-read from L2 by every tap that needs it; keeping
// the halo in shared memory across taps is the later, faster design.
//
// Launch contract (checked by the Python wrapper): x (N, IH, IW, CI) and
// w (KH, KW, CI, CO) contiguous; out (N, OH, OW, CO) contiguous;
// 1 <= block_oh <= 64, 1 <= block_co <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PIX = 64;      // output pixels a CTA computes
constexpr int CK = 32;       // input channels staged per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int CO_T>
__global__ void __launch_bounds__(THREADS)
    conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int IH, int IW, int CI, int OH, int OW,
                  int CO, int KH, int KW, int stride, int dilation,
                  int block_oh, int block_co, int log2_tw, int n_ohb) {
  constexpr int TN = 4;
  constexpr int COLS = CO_T / TN;
  constexpr int ROWS_PASS = THREADS / COLS;
  constexpr int TM = PIX / ROWS_PASS;
  static_assert(TM * ROWS_PASS == PIX, "tile layout");
  __shared__ __align__(16) float Bs[CK][CO_T];      // weight slice
  __shared__ float As[CK][PIX + 1];                 // input pixels, c-major

  const int tid = threadIdx.x;
  const int tc = tid % COLS, tr = tid / COLS;
  const int tw = 1 << log2_tw;
  const int n = blockIdx.y / n_ohb;
  const int oh0 = (blockIdx.y % n_ohb) * block_oh;
  const int ow0 = blockIdx.x * tw;
  const int co0 = blockIdx.z * block_co;
  const int co_end = min(co0 + block_co, CO);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const T* xn = x + (long long)n * IH * IW * CI;
  for (int kh = 0; kh < KH; ++kh) {
    for (int kw = 0; kw < KW; ++kw) {
      const T* wt = w + (long long)(kh * KW + kw) * CI * CO;
      for (int ci0 = 0; ci0 < CI; ci0 += CK) {
        const int kc = min(CK, CI - ci0);
        for (int i = tid; i < PIX * CK; i += THREADS) {
          const int p = i / CK, c = i % CK;     // c fastest: coalesced
          const int r = p >> log2_tw, q = p & (tw - 1);
          const int oh = oh0 + r, ow = ow0 + q;
          float v = 0.f;
          if (c < kc && r < block_oh && oh < OH && ow < OW) {
            const int ih = oh * stride + kh * dilation;
            const int iw = ow * stride + kw * dilation;
            v = to_f(xn[((long long)ih * IW + iw) * CI + ci0 + c]);
          }
          As[c][p] = v;
        }
        for (int i = tid; i < CK * CO_T; i += THREADS) {
          const int c = i / CO_T, j = i % CO_T;
          const int co = co0 + j;
          Bs[c][j] = (c < kc && co < co_end)
                         ? to_f(wt[(long long)(ci0 + c) * CO + co])
                         : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kc; ++k) {
          const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tc * 4]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float a = As[k][tr + i * ROWS_PASS];
            acc[i][0] += a * b.x;
            acc[i][1] += a * b.y;
            acc[i][2] += a * b.z;
            acc[i][3] += a * b.w;
          }
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = tr + i * ROWS_PASS;
    const int r = p >> log2_tw, q = p & (tw - 1);
    const int oh = oh0 + r, ow = ow0 + q;
    if (r >= block_oh || oh >= OH || ow >= OW) continue;
    T* o = out + (((long long)n * OH + oh) * OW + ow) * CO;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tc * 4 + j;
      if (co < co_end) store(&o[co], acc[i][j]);
    }
  }
}

template <typename T, int CO_T>
int launch(const void* x, const void* w, void* out, int N, int IH, int IW,
           int CI, int OH, int OW, int CO, int KH, int KW, int stride,
           int dilation, int block_oh, int block_co, cudaStream_t s) {
  int log2_rows = 0;
  while ((1 << log2_rows) < block_oh) ++log2_rows;   // rows rounded to 2^n
  const int log2_tw = 6 - log2_rows;                 // 64 pixels a CTA
  const int n_ohb = (OH + block_oh - 1) / block_oh;
  dim3 grid((OW + (1 << log2_tw) - 1) >> log2_tw, N * n_ohb,
            (CO + block_co - 1) / block_co);
  conv2d_kernel<T, CO_T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      IH, IW, CI, OH, OW, CO, KH, KW, stride, dilation, block_oh, block_co,
      log2_tw, n_ohb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int N, int IH, int IW,
             int CI, int OH, int OW, int CO, int KH, int KW, int stride,
             int dilation, int block_oh, int block_co, cudaStream_t s) {
#define ARGS \
  x, w, out, N, IH, IW, CI, OH, OW, CO, KH, KW, stride, dilation, block_oh, \
      block_co, s
  if (block_co <= 32) return launch<T, 32>(ARGS);
  if (block_co <= 64) return launch<T, 64>(ARGS);
  return launch<T, 128>(ARGS);
#undef ARGS
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (x, w and out share it).  Returns
// cudaGetLastError(), or -1 for blocks or a dtype this file does not build.
extern "C" int conv2d(const void* x, const void* w, void* out, int dtype,
                      int N, int IH, int IW, int CI, int OH, int OW, int CO,
                      int KH, int KW, int stride, int dilation, int block_oh,
                      int block_co, void* stream) {
  if (block_oh < 1 || block_oh > 64 || block_co < 1 || block_co > 128)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(x, w, out, N, IH, IW, CI, OH, OW, CO, KH,
                                   KW, stride, dilation, block_oh, block_co,
                                   s);
  if (dtype == 1)
    return dispatch<float>(x, w, out, N, IH, IW, CI, OH, OW, CO, KH, KW,
                           stride, dilation, block_oh, block_co, s);
  return -1;
}
