// FlowNet correlation (cost volume) for Hopper (sm_90a):
//   out[y, x, dy, dx] = sum_c I1[y, x, c] * I2[y + dy - R, x + dx - R, c]
// with I1, I2 (H, W, C), D = 2R + 1 displacements a side, I2 read as zero
// outside the image; f32 sums, output (H, W, D, D) in I1's dtype.  Two
// kernels, one per route; the wrapper (kernels/correlation.py,
// `correlation_route`) picks one before the launch:
//
//   * `corr_wgmma_kernel` (route "correlation"): bf16, C % 8 == 0 (rows
//     TMA can stride), 16-byte aligned bases.  For one output row y and
//     one dy, the D dx values of a tile of 64 columns x0.. are a band of
//     one product: the I1 row tile (64 x C) times the I2 row
//     y2 = y + dy - R over the window of N = 64 + 2R (rounded up to 8)
//     columns x0 - R.., transposed.  Output (x, dx) is the accumulator
//     element (x, n = x + dx).  That product is a `wgmma` m64nNk16 with
//     both operands K-major (C contiguous), as Q K^T in the flash forward.
//     One CTA per (64-column tile, block of `rows` output rows, group of
//     `g` dy values), from `cuda_bridge.correlation_plan`:
//       - the CTA's I1 rows stay in shared memory (one 3-D TMA box of 64
//         channels x 64 columns a row and chunk); consumer warpgroup w
//         owns I1 row y0 + w;
//       - the I2 rows its (row, dy) pairs need, rows + g - 1 of them, are
//         streamed once each, in 64-channel chunks of N columns, through a
//         ring of `stages` TMA stages fed by one producer warp, so the next
//         chunks are in flight while one is multiplied.  Each staged row is
//         multiplied by every resident I1 row it pairs with (both
//         warpgroups read the same stage), so an I2 row read once serves up
//         to `rows` products and an I1 row `g`.  I1 arrives chunk by chunk,
//         each chunk behind the first I2 row's, so the first product starts
//         on the first chunks;
//       - a warpgroup keeps up to TC_GROUPS wgmma commit groups (one a
//         chunk) in flight and hands a stage back as soon as its group is
//         done; products alternate between two accumulators, so one
//         product's band epilogue runs while the next one's first chunks
//         are on the tensor cores;
//       - I2 is read in place through a tensor map over (H, W, C): TMA
//         fills the columns and rows outside the image, negative
//         coordinates included, with zeros, as the reference pads.  An I2
//         row wholly outside the image is not loaded; its pairs' outputs
//         are written as zeros;
//       - the band of each product goes from the accumulator to an f32
//         staging block in shared memory laid out as the output is
//         ([row][x][dy][dx] for the CTA's dy group); once a warpgroup's
//         products are done, each pixel of its row has its g x D
//         contiguous outputs written as one run (8 lanes a run, 16-byte
//         stores between single values at the ends) while the other
//         warpgroup may still compute; ragged columns (W not a multiple of
//         64) and rows are masked there.  Where I1 rows and a ring of full-C
//         chunks do
//         not fit, the channels are walked in passes of `chunks` 64-channel
//         chunks, each pass adding its band into the staging block.
//   * `corr_simt_kernel` (route "correlation_simt"): f32, or C not a
//     multiple of 8.  The first CUDA-core kernel, described below.
//
// Replaces the TPU kernel `_corr_kernel` (src/repro/kernels/correlation.py:25,
// entry `correlation_pallas`).
//
// What bounds it on the H100: bytes.  FLOWNET_CORR needs 2 x 48 x 64 x 441
// x 256 = 0.69 Gflop on 3.1 MB of input and 2.7 MB of output, ~120
// flop/byte, under the ~295 the card needs before its arithmetic is the
// limit.  On the tensor cores the band wastes the columns outside it: at
// N = 88 the products are 4.2x the useful flops (~2.9 us at 989 TFLOP/s),
// still near the 1.7 us the bytes take.  The TPU kernel keeps a block_y x
// W x C block of I1 in VMEM across all D^2 displacement steps and re-reads
// I2 at each; here each I1 row is staged once for g displacements and each
// I2 row once for up to `rows` products, the re-reads coming from L2.
// What a CTA waits on at FLOWNET_CORR (scripts/probe_correlation_torch.py,
// one H100 80GB HBM3 at 700 W, cold L2): the ring's TMA boxes (8-11 KB)
// arrive about one per 1,550 cycles, each ~3,800 cycles after its issue;
// the CTAs span 22.9 us, and 16.8 us built without the wgmma instructions
// and the band epilogue (--no-math), so most of a CTA streams its 7 rows.
// Neither the ring's depth nor the CTAs on the card moves the time
// (scripts/sweep_correlation_torch.py).
//
// The CUDA-core kernel (route "correlation_simt"):
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
// contiguous; out (H, W, D, D) contiguous; 0 <= R <= 31.  Route
// "correlation": bf16, C % 8 == 0, 16-byte aligned bases, a plan whose
// block_n is a multiple of 8 in [64 + 2R, 128], rows 1 or 2, at least 3
// ring stages (a warpgroup holds the stages of the wgmma groups it keeps
// in flight), and shared memory within what a CTA may hold.  Route "correlation_simt": block_y
// >= 1.  Each entry returns cudaGetLastError(), -1 for a plan, radius or
// dtype this file does not build, or -2 when a TMA descriptor cannot be
// encoded.
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_R = 31;

// ---------------------------------------------------------------------------
// route "correlation": wgmma row-pair products, band epilogue
// ---------------------------------------------------------------------------

constexpr int TC_TX = 64;              // output columns of a tile (wgmma M)
constexpr int TC_CK = 64;              // channels of a chunk (128 bytes)
constexpr int TC_A_BYTES = TC_TX * 128;  // one I1 row's chunk
constexpr int TC_MAX_THREADS = 2 * 128 + 32;
// wgmma commit groups (one a 64-channel chunk) a warpgroup keeps in
// flight; each holds its ring stage, so the ring needs at least as many
constexpr int TC_GROUPS = 3;
constexpr int SMEM_MAX = 227 * 1024;

// Shared memory of a CTA, from the tile base (1024-aligned): the I1 rows'
// chunks, the ring of I2 chunks, the f32 staging block, the mbarriers (a
// full and an empty one a stage, one a chunk of I1, one for I1's release);
// plus 1024 bytes to align the base.  `cuda_bridge.correlation_smem`
// computes the same sum.
struct CorrLayout {
  int ring, out, bars, total;
};

__host__ __device__ inline CorrLayout corr_layout(int N, int rows, int g,
                                                  int D, int chunks,
                                                  int stages) {
  CorrLayout L;
  L.ring = rows * chunks * TC_A_BYTES;
  L.out = L.ring + stages * N * 128;
  L.bars = (L.out + rows * TC_TX * g * D * 4 + 7) & ~7;
  L.total = L.bars + (2 * stages + chunks + 1) * 8 + 1024;
  return L;
}

// The band of one product into the staging block: accumulator element
// (x, n) of this thread (rows xr0 and xr0 + 8, columns 8 jj + 2 t4 (+1))
// is dx = n - x.  `o_d` is the block of the product's dy; a pixel's
// outputs are `pix` floats apart.  Warp w's rows 16 w .. 16 w + 15 reach
// columns 16 w .. 16 w + 15 + 2R only, so the other column groups are
// skipped (warp-uniform).  ADD: a later channel pass adds to the first's.
template <int N, bool ADD>
__device__ __forceinline__ void band_to_smem(const float (&acc)[N / 2],
                                             float* o_d, int pix, int D,
                                             int R, int warp, int lane) {
  const int t4 = lane % 4, xr0 = 16 * warp + lane / 4;
  float* q0 = o_d + xr0 * (pix - 1) + 2 * t4;  // row xr0: column n at q0 + n
  float* q1 = q0 + 8 * (pix - 1);              // row xr0 + 8
  const int d0 = 2 * t4 - xr0;                 // dx of column 0, row xr0
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    if (8 * jj + 7 < 16 * warp || 8 * jj > 16 * warp + 15 + 2 * R) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * jj + (e & 1);
      const int dx = n + d0 - (e & 2) * 4;
      if (dx >= 0 && dx < D) {
        float* q = (e & 2 ? q1 : q0) + n;
        if (ADD)
          *q += acc[4 * jj + e];
        else
          *q = acc[4 * jj + e];
      }
    }
  }
}

// One pixel's run of `len` staged outputs to its contiguous bf16 outputs,
// by 8 lanes (l8 = 0..7): 16-byte stores of 8 values from the first
// 16-byte boundary of `dst` on, single values before it and after the last
// full 8.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const float* src, int len,
                                          int l8) {
  const int head =
      min(len, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 2);
  const int body = (len - head) / 8, tail = head + 8 * body;
  if (l8 < head) dst[l8] = __float2bfloat16(src[l8]);
  if (l8 < len - tail) dst[tail + l8] = __float2bfloat16(src[tail + l8]);
#pragma unroll 2
  for (int c = l8; c < body; c += 8) {
    const float* s = src + head + 8 * c;
    uint4 v;
    v.x = hopper::pack_bf16(s[0], s[1]);
    v.y = hopper::pack_bf16(s[2], s[3]);
    v.z = hopper::pack_bf16(s[4], s[5]);
    v.w = hopper::pack_bf16(s[6], s[7]);
    *reinterpret_cast<uint4*>(dst + head + 8 * c) = v;
  }
}

template <int N>
__global__ void __launch_bounds__(TC_MAX_THREADS, 1)
    corr_wgmma_kernel(const __grid_constant__ CUtensorMap t1,
                      const __grid_constant__ CUtensorMap t2,
                      __nv_bfloat16* __restrict__ out, int H, int W, int R,
                      int rows, int g, int kc, int chunks, int stages) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int D = 2 * R + 1;
  const CorrLayout L = corr_layout(N, rows, g, D, chunks, stages);
  unsigned char* a_s = smem;                       // [row][chunk]
  unsigned char* b_s = smem + L.ring;              // [stage]
  float* o_s = reinterpret_cast<float*>(smem + L.out);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* a_full = empty + stages;               // [chunk]
  uint64_t* a_empty = a_full + chunks;

  const int x0 = blockIdx.x * TC_TX;
  const int y0 = blockIdx.y * rows;
  const int dy0 = blockIdx.z * g;
  const int gl = min(g, D - dy0);            // dy values of this group
  const int y_last = min(y0 + rows, H) - 1;  // last output row in the image
  // the I2 rows the CTA's pairs read, clipped to the image
  const int j_lo = max(0, y0 + dy0 - R);
  const int j_hi = min(H - 1, y_last + dy0 + gl - 1 - R);
  const int n_b = max(0, j_hi - j_lo + 1);
  const int passes = (kc + chunks - 1) / chunks;
  const int consumers = rows * 128;
  if (threadIdx.x == 0) {
    tma_prefetch_desc(&t1);
    tma_prefetch_desc(&t2);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    for (int k = 0; k < chunks; ++k) mbar_init(&a_full[k], 1);
    mbar_init(a_empty, consumers);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {  // the producer warp: one lane issues
    // no I2 row in the image: nothing to multiply, no I1 to load (a
    // consumer waits on I1's chunks only for a product)
    if (threadIdx.x == consumers && n_b > 0) {
      int u = 0;
      auto load_b = [&](int j, int c) {  // ring use u: I2 row j, chunk c
        const int s = u % stages;
        mbar_wait(&empty[s], ((u / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], N * 128);
        tma_load_3d(b_s + s * N * 128, &t2, &full[s], c * TC_CK, x0 - R,
                    j_lo + j);
        ++u;
      };
      for (int p = 0; p < passes; ++p) {
        const int c0 = p * chunks, nk = min(chunks, kc - c0);
        if (p > 0) mbar_wait(a_empty, (p - 1) & 1);
        // I1 chunk by chunk, each followed by the first I2 row's chunk, so
        // the first product starts on the first chunks to arrive
        for (int k = 0; k < nk; ++k) {
          mbar_expect_tx(&a_full[k], (y_last - y0 + 1) * TC_A_BYTES);
          for (int r = 0; r <= y_last - y0; ++r)
            tma_load_3d(a_s + (r * chunks + k) * TC_A_BYTES, &t1, &a_full[k],
                        (c0 + k) * TC_CK, x0, y0 + r);
          load_b(0, c0 + k);
        }
        for (int j = 1; j < n_b; ++j)
          for (int k = 0; k < nk; ++k) load_b(j, c0 + k);
      }
    }
    return;
  }

  // consumer warpgroup w: I1 row y
  const int w = threadIdx.x / 128;
  const int y = y0 + w;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int pix = g * D;                     // staged floats a pixel
  float* o_w = o_s + w * TC_TX * pix;
  if (y < H) {  // pairs whose I2 row lies outside the image read zeros
    for (int dyl = 0; dyl < gl; ++dyl) {
      const int y2 = y + dy0 + dyl - R;
      if (y2 < 0 || y2 >= H)
        for (int e = threadIdx.x % 128; e < TC_TX * D; e += 128)
          o_w[(e / D) * pix + dyl * D + e % D] = 0.f;
    }
  }
  const unsigned char* a_w = a_s + w * chunks * TC_A_BYTES;
  // this warpgroup's pairs are the staged I2 rows [jp_lo, jp_lo + np)
  const int jp_lo = y < H ? min(n_b, max(0, y - R + dy0 - j_lo)) : n_b;
  const int np =
      y < H ? max(0, min(n_b, y - R + dy0 + gl - j_lo) - jp_lo) : 0;
  float acc0[N / 2], acc1[N / 2];  // products alternate between the two
  int u = 0;                       // the next ring use
  int rel = 0;                     // the oldest ring use not handed back
  for (int p = 0; p < passes; ++p) {
    const int nk = min(chunks, kc - p * chunks);
    // rows another warpgroup multiplies: wait for each chunk, hand it back
    auto pass_through = [&](int n_rows) {
      for (int i = 0; i < n_rows * nk; ++i, ++u, ++rel) {
        mbar_wait(&full[u % stages], (u / stages) & 1);
        mbar_arrive(&empty[u % stages]);
      }
    };
    // issue chunks [k0, k1) of a product into `a`, one commit group each.
    // Up to TC_GROUPS groups stay in flight: once one is issued, the older
    // ones are waited for and their stages handed back.  Every staged I2
    // row pairs with an I1 row of the image, whose warpgroup waits here on
    // every I1 chunk of the pass before I1's release: no I1 load is left
    // in flight.
    auto issue = [&](float (&a)[N / 2], int k0, int k1) {
      for (int k = k0; k < k1; ++k, ++u) {
        const int s = u % stages;
        mbar_wait(&a_full[k], p & 1);
        mbar_wait(&full[s], (u / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<N>::template ss<0>(
              a, desc_sw128(a_w + k * TC_A_BYTES + kk * 32, 16, 1024),
              desc_sw128(b_s + s * N * 128 + kk * 32, 16, 1024),
              (k > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<TC_GROUPS - 1>();
        for (; rel + TC_GROUPS - 1 <= u; ++rel)
          mbar_arrive(&empty[rel % stages]);
      }
    };
    // product r is done once the next one's first chunks are issued: its
    // band goes to the staging block while they run, then the next
    // product's other chunks are issued
    auto step = [&](float (&cur)[N / 2], float (&nxt)[N / 2], int r) {
      const bool more = r + 1 < np;
      const int first = more ? min(nk, TC_GROUPS - 1) : 0;
      if (more) issue(nxt, 0, first);
      if (first == 1)  // the next product's one chunk may be all in flight
        wgmma_wait<1>();
      else if (!more)
        wgmma_wait<0>();
      for (; rel < u - first; ++rel) mbar_arrive(&empty[rel % stages]);
      fence_regs(cur);
      float* o_d = o_w + (j_lo + jp_lo + r - y + R - dy0) * D;
      if (p == 0)
        band_to_smem<N, false>(cur, o_d, pix, D, R, warp, lane);
      else
        band_to_smem<N, true>(cur, o_d, pix, D, R, warp, lane);
      if (more) issue(nxt, first, nk);
    };
    pass_through(jp_lo);
    if (np > 0) issue(acc0, 0, nk);
    for (int r = 0; r < np; ++r) {
      if (r & 1)
        step(acc1, acc0, r);
      else
        step(acc0, acc1, r);
    }
    pass_through(n_b - jp_lo - np);
    mbar_arrive(a_empty);
  }

  // this row's pixels: each one's gl x D outputs as one run of contiguous
  // values, 8 lanes a run, while the other warpgroup may still compute
  named_bar_sync(1 + w, 128);
  if (y < H) {
    const int l8 = lane % 8;
    for (int x = threadIdx.x % 128 / 8; x < TC_TX && x0 + x < W; x += 16)
      store_run(out + (((long long)y * W + x0 + x) * D + dy0) * D,
                o_w + x * pix, gl * D, l8);
  }
}

template <int N>
int launch_wgmma(const CUtensorMap& t1, const CUtensorMap& t2, void* out,
                 int H, int W, int R, int rows, int g, int kc, int chunks,
                 int stages, int smem, cudaStream_t stream) {
  auto kern = corr_wgmma_kernel<N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int D = 2 * R + 1;
  dim3 grid((W + TC_TX - 1) / TC_TX, (H + rows - 1) / rows,
            (D + g - 1) / g);
  kern<<<grid, rows * 128 + 32, smem, stream>>>(
      t1, t2, static_cast<__nv_bfloat16*>(out), H, W, R, rows, g, kc, chunks,
      stages);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "correlation_simt": the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int TX = 32;        // output columns a CTA computes
constexpr int CC = 32;        // channels staged per step
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
    corr_simt_kernel(const T* __restrict__ i1, const T* __restrict__ i2,
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

// Route "correlation": bf16 I1, I2 and out; the plan's rows (1 or 2), dy
// group g, band width block_n, 64-channel chunks a pass and ring stages.
extern "C" int correlation_wgmma(const void* i1, const void* i2, void* out,
                                 int H, int W, int C, int R, int rows, int g,
                                 int block_n, int chunks, int stages,
                                 void* stream) {
  const int D = 2 * R + 1;
  const int kc = (C + TC_CK - 1) / TC_CK;
  if (R < 0 || R > MAX_R || C % 8 != 0 || rows < 1 || rows > 2 || g < 1 ||
      g > D || block_n % 8 != 0 || block_n < TC_TX + 2 * R ||
      block_n > 128 || chunks < 1 || chunks > kc || stages < TC_GROUPS)
    return -1;
  const int smem = corr_layout(block_n, rows, g, D, chunks, stages).total;
  if (smem > SMEM_MAX) return -1;
  CUtensorMap t1, t2;
  memset(&t1, 0, sizeof(t1));
  memset(&t2, 0, sizeof(t2));
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)W, (uint64_t)H};
  const uint64_t str[2] = {(uint64_t)C * 2, (uint64_t)W * C * 2};
  const uint32_t box1[3] = {TC_CK, TC_TX, 1};
  const uint32_t box2[3] = {TC_CK, (uint32_t)block_n, 1};
  if (hopper_host::encode_bf16(&t1, 3, i1, dims, str, box1) != 0 ||
      hopper_host::encode_bf16(&t2, 3, i2, dims, str, box2) != 0)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CORR(N_)                                                          \
  if (block_n == N_)                                                      \
    return launch_wgmma<N_>(t1, t2, out, H, W, R, rows, g, kc, chunks,    \
                            stages, smem, s);
  CORR(64) CORR(72) CORR(80) CORR(88) CORR(96) CORR(104) CORR(112)
  CORR(120) CORR(128)
#undef CORR
  return -1;
}

// Route "correlation_simt".  dtype: 0 = bf16, 1 = f32 (I1, I2 and out
// share it).
extern "C" int correlation_simt(const void* i1, const void* i2, void* out,
                                int dtype, int H, int W, int C, int R,
                                int block_y, void* stream) {
  if (R < 0 || R > MAX_R || block_y < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = 2 * R + 1;
  dim3 grid((W + TX - 1) / TX, (H + block_y - 1) / block_y, D);
  if (dtype == 0)
    corr_simt_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(i1),
        static_cast<const __nv_bfloat16*>(i2),
        static_cast<__nv_bfloat16*>(out), H, W, C, R, block_y);
  else if (dtype == 1)
    corr_simt_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(i1), static_cast<const float*>(i2),
        static_cast<float*>(out), H, W, C, R, block_y);
  else
    return -1;
  return (int)cudaGetLastError();
}
