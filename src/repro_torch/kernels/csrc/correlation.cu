// FlowNet correlation (cost volume) for Hopper (sm_90a):
//   out[y, x, dy, dx] = sum_c I1[y, x, c] * I2[y + dy - R, x + dx - R, c]
// with I1, I2 (H, W, C), D = 2R + 1 displacements a side, I2 read as zero
// outside the image; f32 sums, output (H, W, D, D) in I1's dtype.
//
// Replaces the TPU kernel `_corr_kernel` (src/repro/kernels/correlation.py:25,
// entry `correlation_pallas`).
//
// What bounds it on the H100: bytes.  FLOWNET_CORR does 2 x 48 x 64 x 441
// x 256 = 0.69 Gflop on 3.1 MB of input and 2.7 MB of output, ~120 flop/byte,
// under the ~295 the card needs before its arithmetic is the limit.  The TPU
// kernel keeps a block_y x W x C block of I1 in VMEM across all D^2
// displacement steps; for FLOWNET_CORR that block is 256 KB, which does not
// fit the 227 KB a CTA may hold, and D^2 = 441 accumulators an output pixel
// do not fit in registers.  So:
//   * one CTA per (strip of 32 x columns, block of `block_y` rows, dy): it
//     computes all D dx values of its 32 pixels for one dy, so a thread
//     holds at most 8 accumulators (D <= 63);
//   * C is streamed through shared memory in chunks of 32 channels: the
//     chunk of I1 for the strip and of I2's row y + dy - R for the strip
//     widened by R on each side, both staged as f32, c-major so that a
//     warp (32 consecutive x, one dx) reads consecutive words;
//   * I2 is read in place: a row or column outside the image stages zeros,
//     so no padded copy of I2 exists (the JAX wrapper pads it);
//   * the strip's (32, D) results are transposed through shared memory and
//     written as runs of D contiguous dx values.
//
// Launch contract (checked by the Python wrapper): I1, I2 (H, W, C)
// contiguous; out (H, W, D, D) contiguous; 0 <= R <= 31; block_y >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;        // output columns a CTA computes
constexpr int CC = 32;        // channels staged per step
constexpr int MAX_R = 31;
constexpr int THREADS = 256;
constexpr int NACC = 8;       // ceil(TX * (2 MAX_R + 1) / THREADS)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    correlation_kernel(const T* __restrict__ i1, const T* __restrict__ i2,
                       T* __restrict__ out, int H, int W, int C, int R,
                       int block_y) {
  __shared__ float s1[CC][TX + 1];       // + 1: transposed stores spread
  __shared__ float s2[CC][TX + 2 * MAX_R];
  __shared__ float so[TX * (2 * MAX_R + 1)];
  const int D = 2 * R + 1;
  const int span = TX + 2 * R;             // I2 columns the strip reads
  const int tid = threadIdx.x;
  const int x = tid % TX;                  // this thread's column ...
  const int w0 = tid / TX;                 // ... and dx = w0 + 8 k
  const int x0 = blockIdx.x * TX;
  const int dy = blockIdx.z;

  for (int yi = 0; yi < block_y; ++yi) {
    const int y = blockIdx.y * block_y + yi;
    if (y >= H) break;
    const int y2 = y + dy - R;
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    if (y2 >= 0 && y2 < H) {
      for (int c0 = 0; c0 < C; c0 += CC) {
        const int kc = min(CC, C - c0);
        for (int i = tid; i < TX * CC; i += THREADS) {
          const int c = i % CC, j = i / CC;  // c fastest: coalesced
          const int xx = x0 + j;
          s1[c][j] = (c < kc && xx < W)
                         ? to_f(i1[((long long)y * W + xx) * C + c0 + c])
                         : 0.f;
        }
        for (int i = tid; i < span * CC; i += THREADS) {
          const int c = i % CC, j = i / CC;
          const int xx = x0 - R + j;
          s2[c][j] = (c < kc && xx >= 0 && xx < W)
                         ? to_f(i2[((long long)y2 * W + xx) * C + c0 + c])
                         : 0.f;
        }
        __syncthreads();
        for (int c = 0; c < kc; ++c) {
          const float a = s1[c][x];
#pragma unroll
          for (int k = 0; k < NACC; ++k) {
            const int dx = w0 + 8 * k;
            if (dx < D) acc[k] += a * s2[c][x + dx];
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int dx = w0 + 8 * k;
      if (dx < D) so[x * D + dx] = acc[k];
    }
    __syncthreads();
    for (int i = tid; i < TX * D; i += THREADS) {
      const int j = i / D, dx = i % D;
      const int xx = x0 + j;
      if (xx < W)
        store(&out[(((long long)y * W + xx) * D + dy) * D + dx], so[i]);
    }
    __syncthreads();
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (I1, I2 and out share it).  Returns
// cudaGetLastError(), or -1 for a radius or dtype this file does not build.
extern "C" int correlation(const void* i1, const void* i2, void* out,
                           int dtype, int H, int W, int C, int R, int block_y,
                           void* stream) {
  if (R < 0 || R > MAX_R || block_y < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = 2 * R + 1;
  dim3 grid((W + TX - 1) / TX, (H + block_y - 1) / block_y, D);
  if (dtype == 0)
    correlation_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(i1),
        static_cast<const __nv_bfloat16*>(i2),
        static_cast<__nv_bfloat16*>(out), H, W, C, R, block_y);
  else if (dtype == 1)
    correlation_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(i1), static_cast<const float*>(i2),
        static_cast<float*>(out), H, W, C, R, block_y);
  else
    return -1;
  return (int)cudaGetLastError();
}
