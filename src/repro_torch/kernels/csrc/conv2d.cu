// Direct 2-D convolution for Hopper (sm_90a): NHWC x HWIO -> NHWC, VALID
// padding, with stride and dilation; f32 accumulation, output in the
// input's dtype.  Two kernels, one per route; the wrapper
// (kernels/conv2d.py, `conv2d_route`) picks one before the launch:
//
//   * `conv_wgmma_kernel` (route "conv2d"): bf16 x and w with 16-byte
//     aligned bases.  An implicit GEMM on the tensor cores:
//     M = a tile of BM output pixels (`block_oh` rows x `block_ow` columns
//     of one image), N = BN output channels, K = the (kh, kw, ci)
//     reduction in 64-wide steps (one 128-byte swizzle row of bf16).  One
//     CTA per (pixel tile, channel tile, K split): BM / 64 consumer
//     warpgroups issue `wgmma` with the f32 accumulator in registers (the
//     output stays stationary, as in the TPU kernel) while a producer
//     warpgroup keeps a ring of STAGES (A, B) stages in shared memory
//     filled, each stage handed over on an mbarrier:
//       - A, for CI % 8 == 0 (and stride x block_ow <= 256): walked tap by
//         tap in 64-channel chunks, one 4-D TMA box of (64 channels,
//         block_ow columns, 1 row, 1 image) per output row of the tile at
//         (ci0, ow0 s + kw d, oh s + kh d, n); the box steps the W axis by
//         the stride (TMA's element stride), and TMA's zero fill covers the
//         ragged right and bottom edges and the channels past CI;
//       - A, otherwise (CI = 3 first layers): the flattened (kh, kw, ci)
//         reduction, K = KH KW CI packed into 64-wide steps, gathered by
//         the producer threads into the same swizzled layout (8 elements,
//         16 bytes, a store);
//       - B: w (KH, KW, CI, CO) is the row-major (KH KW CI, CO) matrix the
//         GEMM reads N-major, by 2-D TMA boxes of 64 x 64 (CO % 8 == 0), or
//         gathered by the producer threads (CO 27, 125: rows TMA cannot
//         stride).  Where a step's 64 rows run into the next tap (CI not a
//         multiple of 64), A's channels there are zero and add nothing.
//     Where the pixel x channel tiles leave SMs idle (the 13 x 13 layers),
//     the K steps are split over CTAs: each writes its f32 partial to a
//     workspace the wrapper allocates, and `conv_reduce_kernel` sums the
//     splits in split order and rounds to bf16 (no atomics: deterministic).
//     Ragged OH, OW and CO are masked at the store; nothing is padded by a
//     copy.  Tiles: BM 64 or 128, BN 64 or 128, block_ow 8..64.
//   * `conv2d_kernel` (route "conv2d_simt"): f32, or operands TMA cannot
//     take.  The first port's CUDA-core kernel, described below.
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
// halo and a 590 KB weight block).  So both kernels are implicit GEMMs over
// smaller pieces, and each input pixel is re-read from L2 by every tap that
// needs it (keeping the halo in shared memory across taps is not done).
//
// The CUDA-core kernel (route "conv2d_simt"):
//   * one CTA per (image, block of `block_oh` output rows, strip of output
//     columns, block of `block_co` output channels).  The CTA's 64 output
//     pixels are `block_oh` rows (rounded up to a power of two, rows past
//     `block_oh` idle) by 64 / that many columns;
//   * the (kh, kw, ci) reduction runs inside the CTA, tap by tap, with CI
//     streamed through shared memory in chunks of 32 channels: the input
//     pixels a tap reads (stride and dilation applied in the addresses) and
//     the tap's (32, block_co) weight slice are staged as f32;
//   * the f32 accumulator stays in registers (TM x 4 values a thread) and
//     is written once, at the end;
//   * ragged OH, OW and CO edges and CI chunks past CI are masked.
//
// Launch contract (checked by the Python wrapper): x (N, IH, IW, CI) and
// w (KH, KW, CI, CO) contiguous; out (N, OH, OW, CO) contiguous.  Route
// "conv2d_simt": 1 <= block_oh <= 64, 1 <= block_co <= 128.  Route
// "conv2d": the tiles above, 16-byte aligned bases, and `splits` equal to
// ceil(k_steps / ceil(k_steps / splits)), with an f32 workspace of splits x
// N OH OW x CO when splits > 1.  Each entry returns cudaGetLastError(), -1
// for a tile or dtype this file does not build, or -2 when a TMA
// descriptor cannot be encoded.
#include <string.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// route "conv2d": wgmma implicit GEMM
// ---------------------------------------------------------------------------

constexpr int CV_STAGES = 4;

template <int BM, int BN>
struct CvTile {
  static constexpr int CONSUMERS = BM / 64;              // warpgroups
  static constexpr int THREADS = CONSUMERS * 128 + 128;  // + the producers
  static constexpr int A_BYTES = BM * 128;               // BM rows x 64 bf16
  static constexpr int B_BYTES = BN * 128;  // BN / 64 atoms x 64 k rows
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = CV_STAGES * STAGE + 2 * CV_STAGES * 8 + 1024;
};

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* out;
  float* part;          // splits x P x CO f32 partials (splits > 1)
  int IH, IW, CI, OH, OW, CO, KW, stride, dil;
  int log2_tw;          // block_ow = 1 << log2_tw
  int n_ohb, n_owb;     // row and column tiles of an image
  int K;                // KH KW CI: rows of the weight matrix
  int cchunks;          // 64-channel chunks of a tap (A by TMA)
  int k_steps, per_split;
  int a_tma, b_tma;
  long long P;          // N OH OW output pixels
};

// 8 bf16 packed in 16 bytes
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 r;
  r.x = hopper::pack_bf16(f[0], f[1]);
  r.y = hopper::pack_bf16(f[2], f[3]);
  r.z = hopper::pack_bf16(f[4], f[5]);
  r.w = hopper::pack_bf16(f[6], f[7]);
  return r;
}

// Rows [m0, m0 + BM) x k step `kt` of the flattened (kh, kw, ci) reduction
// into a swizzled A stage: row m's 16-byte chunk g lands at chunk g ^ (m % 8)
// (the 128-byte swizzle TMA writes).  Elements past K, past OH or OW, are 0.
template <int BM>
__device__ __forceinline__ void gather_a(unsigned char* a_s,
                                         const ConvArgs& p, int n, int oh0,
                                         int ow0, int kt, int pt) {
  const int tw = 1 << p.log2_tw;
  for (int idx = pt; idx < BM * 8; idx += 128) {
    const int m = idx >> 3, g = idx & 7;
    const int oh = oh0 + (m >> p.log2_tw), ow = ow0 + (m & (tw - 1));
    const int k0 = kt * 64 + g * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (oh < p.OH && ow < p.OW && k0 < p.K) {
      const __nv_bfloat16* xn = p.x + (long long)n * p.IH * p.IW * p.CI;
      if (p.CI % 8 == 0) {   // the 8 elements are 8 channels of one tap
        const int tap = k0 / p.CI, ci = k0 - tap * p.CI;
        const int kh = tap / p.KW, kw = tap - kh * p.KW;
        const int ih = oh * p.stride + kh * p.dil;
        const int iw = ow * p.stride + kw * p.dil;
        val = __ldg(reinterpret_cast<const uint4*>(
            xn + ((long long)ih * p.IW + iw) * p.CI + ci));
      } else {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + e;
          f[e] = 0.f;
          if (k < p.K) {
            const int tap = k / p.CI, ci = k - tap * p.CI;
            const int kh = tap / p.KW, kw = tap - kh * p.KW;
            const int ih = oh * p.stride + kh * p.dil;
            const int iw = ow * p.stride + kw * p.dil;
            f[e] = __bfloat162float(
                xn[((long long)ih * p.IW + iw) * p.CI + ci]);
          }
        }
        val = pack8(f);
      }
    }
    *reinterpret_cast<uint4*>(a_s + m * 128 + ((g ^ (m & 7)) << 4)) = val;
  }
}

// Weight rows [krow, krow + 64) x channels [n0, n0 + BN) into a swizzled,
// N-major B stage (the layout of the 64 x 64 TMA boxes): atom column c at
// c x 8192 bytes, k row kk at kk x 128, chunk j at j ^ (kk % 8).  Rows past
// K and channels past CO are 0.
template <int BN>
__device__ __forceinline__ void gather_b(unsigned char* b_s,
                                         const ConvArgs& p, int krow, int n0,
                                         int pt) {
  for (int idx = pt; idx < BN * 8; idx += 128) {
    const int c = idx / 512, kk = (idx / 8) % 64, j = idx % 8;
    const int k = krow + kk, nb = n0 + c * 64 + j * 8;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = (k < p.K && nb + e < p.CO)
                 ? __bfloat162float(p.w[(long long)k * p.CO + nb + e])
                 : 0.f;
    *reinterpret_cast<uint4*>(b_s + c * 8192 + kk * 128 + ((j ^ (kk & 7)) << 4)) =
        pack8(f);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(CvTile<BM, BN>::THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const ConvArgs p) {
  using T = CvTile<BM, BN>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + CV_STAGES * T::STAGE);
  uint64_t* empty = full + CV_STAGES;
  const int tw = 1 << p.log2_tw;
  const int tiles = p.n_ohb * p.n_owb;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int oh0 = (tile / p.n_owb) * (BM >> p.log2_tw);
  const int ow0 = (tile % p.n_owb) * tw;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int kt0 = split * p.per_split;
  const int nk = min(p.k_steps, kt0 + p.per_split) - kt0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < CV_STAGES; ++s) {
      // the producers' 128 arrivals after their stores, plus one that
      // announces the stage's TMA bytes
      mbar_init(&full[s], 129);
      mbar_init(&empty[s], T::CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == T::CONSUMERS) {  // the producer warpgroup
    const int pt = threadIdx.x % 128;
    const uint32_t tx = (p.a_tma ? T::A_BYTES : 0) + (p.b_tma ? T::B_BYTES : 0);
    for (int i = 0; i < nk; ++i) {
      const int kt = kt0 + i, s = i % CV_STAGES;
      mbar_wait(&empty[s], ((i / CV_STAGES) & 1) ^ 1);
      unsigned char* a_s = smem + s * T::STAGE;
      unsigned char* b_s = a_s + T::A_BYTES;
      int krow = kt * 64, kh = 0, kw = 0, ci0 = 0;
      if (p.a_tma) {
        const int tap = kt / p.cchunks;
        ci0 = (kt - tap * p.cchunks) * 64;
        kh = tap / p.KW;
        kw = tap - kh * p.KW;
        krow = tap * p.CI + ci0;
      }
      if (pt == 0) {
        if (tx > 0) {
          mbar_expect_tx(&full[s], tx);
        } else {
          mbar_arrive(&full[s]);
        }
        if (p.a_tma)
          for (int r = 0; r < (BM >> p.log2_tw); ++r)
            tma_load_4d(a_s + r * tw * 128, &ta, &full[s], ci0,
                        ow0 * p.stride + kw * p.dil,
                        (oh0 + r) * p.stride + kh * p.dil, n);
        if (p.b_tma)
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(b_s + c * 8192, &tb, &full[s], n0 + 64 * c, krow);
      }
      if (!p.a_tma) gather_a<BM>(a_s, p, n, oh0, ow0, kt, pt);
      if (!p.b_tma) gather_b<BN>(b_s, p, krow, n0, pt);
      if (!p.a_tma || !p.b_tma) fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % CV_STAGES;
    mbar_wait(&full[s], (i / CV_STAGES) & 1);
    const unsigned char* a_s = smem + s * T::STAGE + wg * 64 * 128;
    const unsigned char* b_s = smem + s * T::STAGE + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<BN>::template ss<1>(acc, desc_sw128(a_s + 32 * kk, 16, 1024),
                              desc_sw128(b_s + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    // keep this step's wgmma in flight; the previous one has finished
    // reading its stage, which goes back to the producers
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0) mbar_arrive(&empty[(i - 1) % CV_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // row r of the warpgroup's 64 is pixel (oh0 + m / tw, ow0 + m % tw) of
  // the tile, m = 64 wg + r; splits > 1 write f32 partials
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int col0 = n0 + 2 * (lane % 4);
  const bool pairs = (p.CO % 2) == 0;
  const bool partial = gridDim.z > 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const int oh = oh0 + (m >> p.log2_tw), ow = ow0 + (m & (tw - 1));
    if (oh >= p.OH || ow >= p.OW) continue;
    const long long pix = ((long long)n * p.OH + oh) * p.OW + ow;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.CO) continue;
      const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (partial) {
        float* q = p.part + (split * p.P + pix) * p.CO + col;
        if (pairs) {
          *reinterpret_cast<float2*>(q) = make_float2(x0, x1);
        } else {
          q[0] = x0;
          if (col + 1 < p.CO) q[1] = x1;
        }
      } else {
        __nv_bfloat16* q = p.out + pix * p.CO + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(x0, x1);
        } else {
          q[0] = __float2bfloat16(x0);
          if (col + 1 < p.CO) q[1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// out = sum over splits of part[split], in split order, rounded to bf16.
__global__ void __launch_bounds__(256)
    conv_reduce_kernel(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ out, long long PC,
                       int splits) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= PC) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * PC + i];
  out[i] = __float2bfloat16(s);
}

template <int BM, int BN>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                 const ConvArgs& p, int N, int splits, cudaStream_t s) {
  using T = CvTile<BM, BN>;
  auto kern = conv_wgmma_kernel<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N * p.n_ohb * p.n_owb, (p.CO + BN - 1) / BN, splits);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(ta, tb, p);
  cudaError_t r = cudaGetLastError();
  if (r != cudaSuccess || splits == 1) return (int)r;
  const long long PC = p.P * p.CO;
  conv_reduce_kernel<<<(unsigned)((PC + 255) / 256), 256, 0, s>>>(
      p.part, p.out, PC, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "conv2d_simt": the CUDA-core kernel
// ---------------------------------------------------------------------------

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

// Route "conv2d_simt".  dtype: 0 = bf16, 1 = f32 (x, w and out share it).
extern "C" int conv2d_simt(const void* x, const void* w, void* out,
                           int dtype, int N, int IH, int IW, int CI, int OH,
                           int OW, int CO, int KH, int KW, int stride,
                           int dilation, int block_oh, int block_co,
                           void* stream) {
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

// Route "conv2d": bf16 x (N, IH, IW, CI) and w (KH, KW, CI, CO) with
// 16-byte aligned bases; a tile of block_oh x block_ow output pixels (64 or
// 128 of them, block_ow 8, 16, 32 or 64) by block_co (64 or 128) channels;
// the K steps cut into `splits` (part: the f32 workspace of splits x
// N OH OW x CO when splits > 1).
extern "C" int conv2d_wgmma(const void* x, const void* w, void* out,
                            void* part, int N, int IH, int IW, int CI,
                            int OH, int OW, int CO, int KH, int KW,
                            int stride, int dilation, int block_oh,
                            int block_ow, int block_co, int splits,
                            void* stream) {
  const int bm = block_oh * block_ow;
  int log2_tw = 3;
  while (log2_tw < 6 && (1 << log2_tw) < block_ow) ++log2_tw;
  if ((1 << log2_tw) != block_ow || (bm != 64 && bm != 128) ||
      (block_co != 64 && block_co != 128) || splits < 1)
    return -1;
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.IH = IH; p.IW = IW; p.CI = CI; p.OH = OH; p.OW = OW; p.CO = CO;
  p.KW = KW; p.stride = stride; p.dil = dilation;
  p.log2_tw = log2_tw;
  p.n_ohb = (OH + block_oh - 1) / block_oh;
  p.n_owb = (OW + block_ow - 1) / block_ow;
  p.K = KH * KW * CI;
  p.cchunks = (CI + 63) / 64;
  p.a_tma = CI % 8 == 0 && stride <= 8 && block_ow * stride <= 256;
  p.b_tma = CO % 8 == 0;
  p.k_steps = p.a_tma ? KH * KW * p.cchunks : (p.K + 63) / 64;
  p.per_split = (p.k_steps + splits - 1) / splits;
  p.P = (long long)N * OH * OW;
  if ((p.k_steps + p.per_split - 1) / p.per_split != splits ||
      (splits > 1 && part == nullptr))
    return -1;
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  if (p.a_tma) {
    const uint64_t dims[4] = {(uint64_t)CI, (uint64_t)IW, (uint64_t)IH,
                              (uint64_t)N};
    const uint64_t str[3] = {(uint64_t)CI * 2, (uint64_t)IW * CI * 2,
                             (uint64_t)IH * IW * CI * 2};
    const uint32_t box[4] = {64, (uint32_t)(block_ow * stride), 1, 1};
    const uint32_t es[4] = {1, (uint32_t)stride, 1, 1};
    if (hopper_host::encode_bf16(&ta, 4, x, dims, str, box, es) != 0)
      return -2;
  }
  if (p.b_tma) {
    const uint64_t dims[2] = {(uint64_t)CO, (uint64_t)p.K};
    const uint64_t str[1] = {(uint64_t)CO * 2};
    const uint32_t box[2] = {64, 64};
    if (hopper_host::encode_bf16(&tb, 2, w, dims, str, box) != 0) return -2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG(BM_, BN_) \
  if (bm == BM_ && block_co == BN_) \
    return launch_wgmma<BM_, BN_>(ta, tb, p, N, splits, s);
  WG(64, 64) WG(64, 128) WG(128, 64) WG(128, 128)
#undef WG
  return -1;
}
