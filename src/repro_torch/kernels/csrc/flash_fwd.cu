// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA,
// emitting the output `o` and the f32 row log-sum-exp `lse`.
//
// Replaces the TPU kernel `_fa_fwd_kernel`
// (src/repro/kernels/attention.py:153, entry `flash_attention_fwd_pallas`).
//
// What bounds it on the H100: operations.  At the prefill lengths that take
// this path (S >= 1024) a causal head does 2 x S^2 x D flops for 4 x S x D x 2
// bytes, hundreds of flops per byte.  Three kernels, one per route; the
// wrapper (kernels/attention.py, `flash_fwd_route`) picks one before the
// launch:
//
//   * `flash_fwd_wgmma` (route "flash_fwd"): bf16, head_dim 64 or 128, the
//     strides and bases TMA can take.  One CTA per (128-row q block,
//     b * H + h): two consumer warpgroups of 64 q rows each and one producer
//     warp.  The producer loads the Q block once and then K and V blocks of
//     128 keys by TMA (4-D descriptors over the (B, S, H, D) layout, read
//     through strides; a D-128 row is two 64-column boxes of the 128-byte
//     swizzle) into a ring of 2 stages, so the next block's loads run under
//     this block's math.  S = Q K^T is a `wgmma` from shared memory (K in
//     its (S, D) layout is K-major); the online softmax runs in registers
//     on the accumulator fragments, in the log2 domain (`ex2.approx`); P
//     is rounded to bf16 in registers and is the register A operand of the
//     PV `wgmma`, whose V is N-major (wgmma's transpose bit).  The two
//     consumer warpgroups run side by side, so one's softmax can overlap
//     the other's products.  Only the blocks a mask can reach (the
//     diagonal, the window edge, the ragged last key block) are masked.
//     The CTAs of the longest rows start first.
//   * `flash_fwd_d256` (route "flash_fwd_d256"): bf16, head_dim 256
//     (recurrentgemma's local MQA), the strides TMA can take.  The D-128
//     design does not fit: a 2-stage ring of 128-key K and V blocks at
//     D 256 needs 256 KB of shared memory, and a 64-row O accumulator is
//     128 f32 registers a thread, above the 168 a thread may hold in a CTA
//     of nine warps (three warps then share one of the SM's four register
//     files).  So the CTA is the two consumer warpgroups alone (256
//     threads, up to 255 registers: O 128, S 32, P in bf16 16), and its
//     first warp also feeds the ring, as the dk/dv backward kernel does:
//     at the start of block i it waits until both warpgroups released
//     block i - 1's stage and issues block i + 1's TMA.  Blocks are 64
//     keys: Q 128 x 256 (64 KB, four 64-column boxes) stays resident, K and
//     V take 32 KB each a stage, 192 KB in all.  S = Q K^T is 16 k-steps
//     of m64n64k16 from shared memory, O += P V four k-steps of
//     m64n256k16 with P from registers.  One CTA per (b * H + h, q block):
//     blockIdx.x walks the heads, so the CTAs that run side by side share
//     a q block and (MQA: all 16 heads) a kv head, and read its K / V
//     blocks from L2; blockIdx.y walks the q blocks from the last, so the
//     longest rows start first.
//   * `flash_fwd_simt` (route "flash_fwd_simt"): f32, head_dim 64, 128 or
//     256, or strides TMA cannot take.  The first port's CUDA-core kernel:
//     64 x 64 score tile in f32 from shared memory, 4 x 4 register tile per
//     thread, 16 x 4 threads per row reduction, K then V loaded after each
//     block's math.  A thread holds 4 rows x D / 16 output columns; at D
//     256 that is 64 f32 accumulators, and the Q, K/V and P tiles take
//     4 x (64 x 257 + 64 x 257 + 64 x 65) = 148,224 B of shared memory (of
//     the 227 KB opt-in), one CTA an SM.
//
// All three walk exactly the k-block range [lo, hi] of their q block in the
// pruned pair schedule, which the host builds with the copied
// `_pair_schedule` / `_row_range` at the kernel's block shape (fully masked
// k blocks are never loaded; an empty range drains o = 0, lse = -1e30).
// Positions: the causal and window masks compare global positions
// q_offset + local q and k_offset + local k (the ring's per-hop fold of a
// visiting shard), as the TPU kernel's `offs_ref` does; only their
// difference `shift` enters (flash_band.cuh: each thread forms its rows' key
// intervals once), and the host prunes the band it shifts.  The padding
// tests stay local: keys at or past Sk and rows at or past Sq.
// GQA: the kv head is h / G, so the G heads of a group read the same K/V
// blocks (through L2).  q, k, v and o are read and written in the engine's
// (B, S, H, D) layout through strides: no transposed or padded copy is
// made; rows past Sq and keys past Sk load as zeros and are masked.
// The numerics follow the TPU kernel: the mask guard is applied before exp,
// so a masked score and a fully masked row contribute exactly 0 (the wgmma
// kernels take each row's exps against 0 while the row has no unmasked
// score); p is rounded to v's dtype before the PV product; m, l and acc
// stay in f32; l == 0 drains as 1 and lse = m + log(l).
#include "flash_band.cuh"
#include "hopper.cuh"

namespace {

using flash_band::Span;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// the wgmma routes: shared softmax step and drain
// ---------------------------------------------------------------------------

constexpr int FA_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Whether rows [q0, q0 + BQ) against keys [k0, k0 + BK) need the mask: the
// ragged last key block, a key past a row's causal limit, or a pair at or
// past the window, on global positions (q + shift against k).
template <int BQ, int BK>
__device__ __forceinline__ bool needs_mask(int q0, int k0, int Sk,
                                           int causal, int window,
                                           int shift) {
  return (k0 + BK > Sk) || (causal && k0 + BK - 1 > q0 + shift) ||
         (window > 0 && q0 + shift + BQ - 1 - k0 >= window);
}

// One block's online-softmax step on a warpgroup's 64 x BK score fragment
// (this thread's rows r and r + 8, which attend keys0 and keys1; see
// hopper.cuh for the layout): scale into the log2 domain, mask where
// `edge`, update the running max m and sum l, rescale O, and pack P in
// bf16 as the PV product's A operand.
template <int BK, int D>
__device__ __forceinline__ void softmax_step(
    float (&sacc)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&oacc)[D / 2],
    float& m0, float& m1, float& l0, float& l1, bool edge, int k0, int t4,
    Span keys0, Span keys1, float scale2) {
  using namespace hopper;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sacc[4 * j + e] * scale2;
      if (edge) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        x = (e < 2 ? keys0 : keys1).holds(kpos) ? x : NEG_INF;
      }
      sacc[4 * j + e] = x;
      if (e < 2)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // the mask guard before exp, per row: exps are taken against the new
  // max, or against 0 while the row has no unmasked score, so a masked
  // score (-1e30) gives exactly 0 and a fully masked row adds nothing
  const float r0 = mn0 == NEG_INF ? 0.f : mn0;
  const float r1 = mn1 == NEG_INF ? 0.f : mn1;
  const float al0 = ex2(m0 - r0), al1 = ex2(m1 - r1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = ex2(sacc[4 * j + e] - (e < 2 ? r0 : r1));
    rs0 += p[0] + p[1];
    rs1 += p[2] + p[3];
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    oacc[4 * j] *= al0;
    oacc[4 * j + 1] *= al0;
    oacc[4 * j + 2] *= al1;
    oacc[4 * j + 3] *= al1;
  }
}

// Write this thread's two rows of o (bf16) and their lse: l == 0 drains as
// 1, a row that saw no key keeps lse = -1e30.
template <int D>
__device__ __forceinline__ void drain(const float (&oacc)[D / 2], float m0,
                                      float m1, float l0, float l1,
                                      __nv_bfloat16* ob, long long o_ss,
                                      float* lse_row, int Sq, int qpos0,
                                      int t4) {
  const float sf0 = l0 == 0.f ? 1.f : l0, sf1 = l1 == 0.f ? 1.f : l1;
  const int qpos1 = qpos0 + 8;
  if (qpos0 < Sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos0 * o_ss + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(oacc[4 * j] / sf0, oacc[4 * j + 1] / sf0);
    if (t4 == 0)
      lse_row[qpos0] = (m0 == NEG_INF ? NEG_INF : m0 * LN2) + logf(sf0);
  }
  if (qpos1 < Sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos1 * o_ss + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(oacc[4 * j + 2] / sf1, oacc[4 * j + 3] / sf1);
    if (t4 == 0)
      lse_row[qpos1] = (m1 == NEG_INF ? NEG_INF : m1 * LN2) + logf(sf1);
  }
}

// ---------------------------------------------------------------------------
// route "flash_fwd": wgmma + TMA K/V ring, head_dim 64 or 128
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 128;  // q rows of a CTA: two consumer warpgroups
constexpr int FA_BK = 128;  // keys of a block
constexpr int FA_THREADS = 2 * 128 + 32;

template <int D>
struct FaSmem {
  static constexpr int Q_BYTES = FA_BQ * D * 2;   // D / 64 atom columns
  static constexpr int KV_BYTES = FA_BK * D * 2;  // one K or V block
  static constexpr int SMEM =
      Q_BYTES + 2 * FA_STAGES * KV_BYTES + (1 + 3 * FA_STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ ranges, int H, int G,
    int Sq, int Sk, int nq, int causal, int window, int shift, float scale,
    long long o_sb, long long o_sh, long long o_ss) {
  using L = FaSmem<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + L::Q_BYTES;                 // [stage]
  unsigned char* v_s = k_s + FA_STAGES * L::KV_BYTES;    // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + FA_STAGES * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FA_STAGES;
  uint64_t* kv_empty = v_full + FA_STAGES;

  const int iq = nq - 1 - (int)blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = iq * FA_BQ;
  const int lo = ranges[2 * iq], hi = ranges[2 * iq + 1];
  const int n = hi - lo + 1;  // k blocks of this row; <= 0: empty
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp: one lane issues the TMA
    if (threadIdx.x % 32 == 0 && n > 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(q_s + c * FA_BQ * 128, &tq, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % FA_STAGES;
        mbar_wait(&kv_empty[s], ((i / FA_STAGES) & 1) ^ 1);
        const int k0 = (lo + i) * FA_BK;
        unsigned char* kb = k_s + s * L::KV_BYTES;
        unsigned char* vb = v_s + s * L::KV_BYTES;
        mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(kb + c * FA_BK * 128, &tk, &k_full[s], 64 * c, k0, hk,
                      b);
        mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vb + c * FA_BK * 128, &tv, &v_full[s], 64 * c, k0, hk,
                      b);
      }
    }
    return;
  }

  // consumers: this thread's rows r and r + 8 of the q block (see
  // hopper.cuh for the fragment layout)
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int t4 = lane % 4;
  const int qpos0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const Span keys0 =
      flash_band::key_span(qpos0, Sq, Sk, causal, window, shift);
  const Span keys1 =
      flash_band::key_span(qpos0 + 8, Sq, Sk, causal, window, shift);
  // scores in the log2 domain: x = s * scale * log2(e), m likewise
  const float scale2 = scale * LOG2E;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  if (n > 0) mbar_wait(q_full, 0);
  const unsigned char* q_wg = q_s + wg * 64 * 128;

  for (int i = 0; i < n; ++i) {
    const int s = i % FA_STAGES;
    const uint32_t ph = (i / FA_STAGES) & 1;
    const int k0 = (lo + i) * FA_BK;
    const unsigned char* kb = k_s + s * L::KV_BYTES;
    const unsigned char* vb = v_s + s * L::KV_BYTES;

    // S = Q K^T (64 x 128 per warpgroup)
    float sacc[FA_BK / 2];
    mbar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<FA_BK>::template ss<0>(
          sacc, desc_sw128(q_wg + c * FA_BQ * 128 + off, 16, 1024),
          desc_sw128(kb + c * FA_BK * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // scale, mask (edge blocks only), online softmax
    uint32_t pa[FA_BK / 16][4];  // P in bf16: the PV product's A operand
    softmax_step<FA_BK, D>(
        sacc, pa, oacc, m0, m1, l0, l1,
        needs_mask<FA_BQ, FA_BK>(q0, k0, Sk, causal, window, shift), k0, t4,
        keys0, keys1, scale2);

    // O += P V
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < FA_BK / 16; ++kc)
      Mma<D>::rs_tb(oacc, pa[kc],
                    desc_sw128(vb + kc * 2048, FA_BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    mbar_arrive(&kv_empty[s]);
  }

  drain<D>(oacc, m0, m1, l0, l1, o + b * o_sb + h * o_sh, o_ss,
           lse + (long long)bh * Sq, Sq, qpos0, t4);
}

template <int D>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, void* o, void* lse,
                 const void* ranges, int B, int H, int G, int Sq, int Sk,
                 int nq, int causal, int window, int shift, float scale,
                 long long o_sb, long long o_sh, long long o_ss,
                 cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, FaSmem<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq, B * H);
  kern<<<grid, FA_THREADS, FaSmem<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(ranges), H, G, Sq, Sk, nq, causal, window,
      shift, scale, o_sb, o_sh, o_ss);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "flash_fwd_d256": wgmma + TMA K/V ring, head_dim 256
// ---------------------------------------------------------------------------

constexpr int D2_BQ = 128;           // q rows of a CTA: two warpgroups of 64
constexpr int D2_BK = 64;            // keys of a block
constexpr int D2_THREADS = 2 * 128;  // no producer warp: see the top

struct D2Smem {
  static constexpr int Q_BYTES = D2_BQ * 256 * 2;   // four atom columns
  static constexpr int KV_BYTES = D2_BK * 256 * 2;  // one K or V block
  static constexpr int SMEM =
      Q_BYTES + 2 * FA_STAGES * KV_BYTES + (1 + 3 * FA_STAGES) * 8 + 1024;
};

__global__ void __launch_bounds__(D2_THREADS, 1) flash_fwd_d256_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ ranges, int H, int G,
    int Sq, int Sk, int nq, int causal, int window, int shift, float scale,
    long long o_sb, long long o_sh, long long o_ss) {
  constexpr int D = 256;
  using L = D2Smem;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + L::Q_BYTES;                 // [stage]
  unsigned char* v_s = k_s + FA_STAGES * L::KV_BYTES;    // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + FA_STAGES * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FA_STAGES;
  uint64_t* kv_empty = v_full + FA_STAGES;

  const int bh = blockIdx.x;                // a q block's heads side by side
  const int iq = nq - 1 - (int)blockIdx.y;  // the longest rows first
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = iq * D2_BQ;
  const int lo = ranges[2 * iq], hi = ranges[2 * iq + 1];
  const int n = hi - lo + 1;  // k blocks of this row; <= 0: empty
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], D2_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;

  // The first warp also feeds the ring: block i's K and V by TMA (lane 0)
  // into stage i % 2, once both warpgroups released it (block i - 2).
  const bool feeder = threadIdx.x < 32;
  auto feed = [&](int i) {
    const int s = i % FA_STAGES;
    mbar_wait(&kv_empty[s], ((i / FA_STAGES) & 1) ^ 1);
    if (lane == 0) {
      const int k0 = (lo + i) * D2_BK;
      unsigned char* kb = k_s + s * L::KV_BYTES;
      unsigned char* vb = v_s + s * L::KV_BYTES;
      mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(kb + c * D2_BK * 128, &tk, &k_full[s], 64 * c, k0, hk, b);
      mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(vb + c * D2_BK * 128, &tv, &v_full[s], 64 * c, k0, hk, b);
    }
  };
  if (feeder && n > 0) {
    if (lane == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(q_s + c * D2_BQ * 128, &tq, q_full, 64 * c, q0, h, b);
    }
    feed(0);
  }

  // this thread's rows r and r + 8 of its warpgroup's 64
  const int t4 = lane % 4;
  const int qw0 = q0 + wg * 64;
  const int qpos0 = qw0 + warp * 16 + lane / 4;
  const Span keys0 =
      flash_band::key_span(qpos0, Sq, Sk, causal, window, shift);
  const Span keys1 =
      flash_band::key_span(qpos0 + 8, Sq, Sk, causal, window, shift);
  const float scale2 = scale * LOG2E;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  if (n > 0) mbar_wait(q_full, 0);
  const unsigned char* q_wg = q_s + wg * 64 * 128;

  for (int i = 0; i < n; ++i) {
    if (feeder && i + 1 < n) feed(i + 1);  // loads under this block's math
    const int s = i % FA_STAGES;
    const uint32_t ph = (i / FA_STAGES) & 1;
    const int k0 = (lo + i) * D2_BK;
    const unsigned char* kb = k_s + s * L::KV_BYTES;
    const unsigned char* vb = v_s + s * L::KV_BYTES;

    // S = Q K^T (64 x 64 per warpgroup, 16 k-steps over D 256)
    float sacc[D2_BK / 2];
    mbar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<D2_BK>::template ss<0>(
          sacc, desc_sw128(q_wg + c * D2_BQ * 128 + off, 16, 1024),
          desc_sw128(kb + c * D2_BK * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    uint32_t pa[D2_BK / 16][4];
    softmax_step<D2_BK, D>(
        sacc, pa, oacc, m0, m1, l0, l1,
        needs_mask<64, D2_BK>(qw0, k0, Sk, causal, window, shift), k0, t4,
        keys0, keys1, scale2);

    // O += P V (64 x 256 per warpgroup, 4 k-steps of 16 keys)
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D2_BK / 16; ++kc)
      Mma<D>::rs_tb(oacc, pa[kc],
                    desc_sw128(vb + kc * 2048, D2_BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    mbar_arrive(&kv_empty[s]);
  }

  drain<D>(oacc, m0, m1, l0, l1, o + b * o_sb + h * o_sh, o_ss,
           lse + (long long)bh * Sq, Sq, qpos0, t4);
}

int launch_d256(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, void* o, void* lse,
                const void* ranges, int B, int H, int G, int Sq, int Sk,
                int nq, int causal, int window, int shift, float scale,
                long long o_sb, long long o_sh, long long o_ss,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      D2Smem::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, nq);
  flash_fwd_d256_kernel<<<grid, D2_THREADS, D2Smem::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(ranges), H, G, Sq, Sk, nq, causal, window,
      shift, scale, o_sb, o_sh, o_ss);
  return (int)cudaGetLastError();
}

// The TMA descriptors of q (boxes of 64 columns x bq rows) and of k and v
// (64 x bk), bf16 (B, S, H, D) read through the (batch, head, seq)
// strides in `st` (elements: q, k, v).  False if one cannot be encoded.
bool encode_qkv(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                const void* q, const void* k, const void* v, int B, int H,
                int G, int Sq, int Sk, int D, const long long* st, int bq,
                int bk) {
  const uint32_t qbox[4] = {64, (uint32_t)bq, 1, 1};
  const uint32_t kvbox[4] = {64, (uint32_t)bk, 1, 1};
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)H,
                          (uint64_t)B};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)(H / G),
                          (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2,
                          (uint64_t)st[0] * 2};
  const uint64_t ks[3] = {(uint64_t)st[5] * 2, (uint64_t)st[4] * 2,
                          (uint64_t)st[3] * 2};
  const uint64_t vs[3] = {(uint64_t)st[8] * 2, (uint64_t)st[7] * 2,
                          (uint64_t)st[6] * 2};
  return hopper_host::encode_bf16(tq, 4, q, qd, qs, qbox) == 0 &&
         hopper_host::encode_bf16(tk, 4, k, kd, ks, kvbox) == 0 &&
         hopper_host::encode_bf16(tv, 4, v, kd, vs, kvbox) == 0;
}

// ---------------------------------------------------------------------------
// route "flash_fwd_simt": the CUDA-core kernel
// ---------------------------------------------------------------------------


constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads

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
    int window, int shift, float scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss) {
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
      const Span keys = flash_band::key_span(q0 + ty + 16 * i, Sq, Sk,
                                             causal, window, shift);
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = keys.holds(k0 + tx + 16 * j);
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
           int causal, int window, int shift, long long q_sb, long long q_sh,
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
      static_cast<const int*>(ranges), H, G, Sq, Sk, causal, window, shift,
      scale, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, H, Sq, D), k/v (B, H / G, Sk, D), o like q, all read through
// strides: `st` holds (batch, head, seq) strides in elements of q, k, v
// and o, each a multiple of 8 with 16-byte bases; D 64 or 128; ranges:
// (nq, 2) int32 inclusive k-block range of each 128-row q block over
// 128-key blocks; q_off / k_off: the global positions of q row 0 and key 0
// (the masks compare q_off + q with k_off + k).  Returns
// cudaGetLastError(), -1 for a D this entry does not build, -2 when a TMA
// descriptor cannot be encoded.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* ranges, int B,
                               int H, int G, int Sq, int Sk, int D, int nq,
                               int causal, int window, int q_off, int k_off,
                               const long long* st, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return -1;
  CUtensorMap tq, tk, tv;
  if (!encode_qkv(&tq, &tk, &tv, q, k, v, B, H, G, Sq, Sk, D, st, FA_BQ,
                  FA_BK))
    return -2;
#define ARGS                                                              \
  tq, tk, tv, o, lse, ranges, B, H, G, Sq, Sk, nq, causal, window,       \
      q_off - k_off, scale, st[9], st[10], st[11], s
  if (D == 128) return launch_wgmma<128>(ARGS);
  return launch_wgmma<64>(ARGS);
#undef ARGS
}

// As flash_fwd_wgmma, at D 256 only: ranges over 128-row q blocks and
// 64-key blocks.
extern "C" int flash_fwd_d256(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* ranges, int B,
                              int H, int G, int Sq, int Sk, int D, int nq,
                              int causal, int window, int q_off, int k_off,
                              const long long* st, float scale,
                              void* stream) {
  if (D != 256) return -1;
  CUtensorMap tq, tk, tv;
  if (!encode_qkv(&tq, &tk, &tv, q, k, v, B, H, G, Sq, Sk, D, st, D2_BQ,
                  D2_BK))
    return -2;
  return launch_d256(tq, tk, tv, o, lse, ranges, B, H, G, Sq, Sk, nq,
                     causal, window, q_off - k_off, scale, st[9], st[10],
                     st[11], static_cast<cudaStream_t>(stream));
}


// dtype: 0 = bf16, 1 = f32; D: 64, 128 or 256; window <= 0 means none.
// ranges: (nq, 2) int32 inclusive k-block range of each q block; q_off /
// k_off as flash_fwd_wgmma.  Returns cudaGetLastError(), or -1 for a shape
// this file does not build.
extern "C" int flash_fwd_simt(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* ranges,
                              int dtype, int B, int H, int G, int Sq, int Sk,
                              int D, int nq, int causal, int window,
                              int q_off, int k_off, long long q_sb,
                              long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb,
                              long long v_sh, long long v_ss, long long o_sb,
                              long long o_sh, long long o_ss, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                \
  q, k, v, o, lse, ranges, B, H, G, Sq, Sk, nq, causal, window,            \
      q_off - k_off, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, \
      o_sb, o_sh, o_ss, scale, s
  if (dtype == 0 && D == 256) return launch<__nv_bfloat16, 256>(ARGS);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(ARGS);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(ARGS);
  if (dtype == 1 && D == 256) return launch<float, 256>(ARGS);
  if (dtype == 1 && D == 128) return launch<float, 128>(ARGS);
  if (dtype == 1 && D == 64) return launch<float, 64>(ARGS);
#undef ARGS
  return -1;
}
