// Flash-attention backward for Hopper (sm_90a): causal / sliding-window GQA,
// from the forward's saved residuals lse (f32 row log-sum-exp) and
// delta = rowsum(o * do) (f32, computed by the caller).  Two kernels, each
// with two routes that the wrapper (kernels/attention.py,
// `flash_bwd_route`) picks before the launch:
//
//   dq    replaces `_fa_bwd_dq_kernel`  (src/repro/kernels/attention.py:311)
//   dk/dv replaces `_fa_bwd_dkv_kernel` (src/repro/kernels/attention.py:360)
//
// (entry `flash_attention_bwd_pallas`).  All emit f32 gradients; the
// caller casts them to the inputs' dtypes.
//
// What bounds them on the H100: operations.  Per unmasked (q, k) pair dq
// does 6 x D flops (s = q.k, dp = do.v, dq += ds.k) and dk/dv 8 x D (s, dp,
// dv += p.do, dk += ds.q), for 4 x S x D x 2 bytes of inputs per head: the
// same hundreds of flops per byte as the forward.  Both kernels re-stream
// the forward's pruned schedule and keep the S x S matrices p and ds out
// of device memory; each output element has exactly one writer (no
// atomics), so the result is the same from run to run (the per-layer
// recompute depends on that).  An empty range still drains: the CTA writes
// zeros (the outputs come from torch.empty; the TPU kernels' sentinel
// pairs drain 0 there).  q, k, v and do are read in the engine's
// (B, S, H, D) layout through strides; rows past Sq and keys past Sk load
// as zeros and are masked, never padded by a copy.  The mask guard comes
// before exp: a fully masked row has lse = -1e30 and would otherwise come
// back as exp(0).
//
// Route "flash_bwd" (launch keys flash_bwd_dq, flash_bwd_dkv): bf16,
// head_dim 64 or 128, the strides and bases TMA can take.  Tensor cores
// (`wgmma`), TMA loads through 4-D descriptors over (B, S, H, D) (a D-128
// row is two 64-column boxes of the 128-byte swizzle), mbarrier rings of 2
// stages so the next tile loads under this tile's math, and P and dS fed
// to the second products from registers, rounded to bf16 (as the forward
// feeds P to PV, and as FlashAttention-2/3 do); s, dp, p, ds and the
// accumulators stay in f32.  Two consumer warpgroups a CTA.
//   * dq: one CTA per (b * H + h, 128-row q block), 64 q rows a consumer
//     warpgroup, and a producer warp whose lane 0 issues the TMA.  Q and
//     dO load once; K and V blocks of 64 keys stream through the ring over
//     the row's k-block range [lo, hi] (the row-ordered pair table at
//     128 x 64).  S = Q K^T and dP = dO V^T are
//     `wgmma`s from shared memory (K and V in their (S, D) layout are
//     K-major); P = exp2(S scale log2e - lse log2e) under the mask guard
//     and dS = P (dP - delta) scale in registers on the accumulator
//     fragments; dS in bf16 is the register A operand of dQ += dS K, whose
//     K is N-major (wgmma's transpose bit).  S, dP and dQ take 128 f32
//     registers a thread at D 128.
//   * dk/dv: one CTA per (b * Hkv + hk, 128-key block), 64 keys a consumer
//     warpgroup.  K and V load once; the CTA walks its column's q-block
//     range (the column-ordered pair table at 64 x 128) and, inside it,
//     the G q heads of its GQA group, as the TPU kernel folds the group.  Each (q block, head) step streams Q, dO and the step's lse
//     and delta rows through the ring.  Everything is transposed so the
//     accumulator rows are keys: S^T = K Q^T and dP^T = V dO^T from shared
//     memory; P^T and dS^T in registers, lse and delta read from shared
//     memory by column; dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     register A operands and dO, Q N-major.
//     Registers are the constraint: dK and dV take 128 f32 a thread at
//     D 128, S^T and dP^T 64 more.  A CTA of 9 or more warps puts 3 warps
//     on one of the SM's four register-file partitions, which caps a
//     thread at 168 registers (ptxas spilled ~600 bytes there, with or
//     without `setmaxnreg` handing a producer warpgroup's registers over).
//     So the dk/dv CTA is the two consumer warpgroups alone (256 threads,
//     up to 255 registers; ptxas: 244 at D 128, no spill), and its first
//     warp also feeds the ring: at the start of step i it waits until both
//     warpgroups released step i - 1's stage, then issues step i + 1's
//     TMA and writes its lse and delta rows.  The two warpgroups thus run
//     at most one step apart.  The dq kernel keeps a producer warp (288
//     threads, 160 registers at D 128).
//   Under a causal mask the work of a CTA varies up to 16x (k block 0
//   sees every q block): blockIdx.y walks q blocks from the last (dq) and
//   k blocks from the first (dk/dv), so the longest CTAs start first.
//
// Route "flash_bwd_simt" (launch keys flash_bwd_dq_simt,
// flash_bwd_dkv_simt): f32, other head dims of the build, or strides TMA
// cannot take.  The first port's CUDA-core kernels: f32 from shared
// memory (64 x 64 tiles, 4 x 4 register tile per thread), p and ds
// unrounded, more than 48 KB of dynamic shared memory per CTA.
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// Whether the (q, k) pair is unmasked; rows past Sq and keys past Sk
// never are.
__device__ __forceinline__ bool live(int qpos, int kpos, int Sq, int Sk,
                                     int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// route "flash_bwd": wgmma + TMA rings
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;
constexpr int WG_THREADS = 2 * 128 + 32;
constexpr int DQ_BQ = 128;  // q rows of a dq CTA: two warpgroups of 64
constexpr int DQ_BK = 64;   // keys of a streamed K / V block
constexpr int KV_BK = 128;  // keys of a dk/dv CTA: two warpgroups of 64
constexpr int KV_BQ = 64;   // q rows of a streamed step
// dk/dv: two warpgroups and no producer warp: 9 or more warps would put 3
// on one of the SM's four register-file partitions and cap a thread at 168
// registers, below what dK, dV, S^T and dP^T need
constexpr int KV_THREADS = 2 * 128;

template <int D>
struct DqSmem {
  static constexpr int Q_BYTES = DQ_BQ * D * 2;   // Q or dO
  static constexpr int KV_BYTES = DQ_BK * D * 2;  // one K or V block
  static constexpr int SMEM =
      2 * Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    const int* __restrict__ ranges, int H, int G, int Sq, int Sk, int nq,
    int causal, int window, float scale, long long dq_sb, long long dq_sh,
    long long dq_ss) {
  using L = DqSmem<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + L::Q_BYTES;
  unsigned char* k_s = do_s + L::Q_BYTES;               // [stage]
  unsigned char* v_s = k_s + STAGES * L::KV_BYTES;      // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * L::KV_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int bh = blockIdx.x;
  const int iq = nq - 1 - (int)blockIdx.y;  // the longest causal rows first
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = iq * DQ_BQ;
  const int lo = ranges[2 * iq], hi = ranges[2 * iq + 1];
  const int n = hi - lo + 1;  // k blocks of this row; <= 0: empty
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp: one lane issues the TMA
    if (threadIdx.x % 32 == 0 && n > 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(q_s + c * DQ_BQ * 128, &tq, q_full, 64 * c, q0, h, b);
        tma_load_4d(do_s + c * DQ_BQ * 128, &tdo, q_full, 64 * c, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        mbar_wait(&kv_empty[s], ((i / STAGES) & 1) ^ 1);
        const int k0 = (lo + i) * DQ_BK;
        unsigned char* kb = k_s + s * L::KV_BYTES;
        unsigned char* vb = v_s + s * L::KV_BYTES;
        mbar_expect_tx(&kv_full[s], 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(kb + c * DQ_BK * 128, &tk, &kv_full[s], 64 * c, k0,
                      hk, b);
          tma_load_4d(vb + c * DQ_BK * 128, &tv, &kv_full[s], 64 * c, k0,
                      hk, b);
        }
      }
    }
    return;
  }

  // consumers: this thread's q rows r and r + 8 of its warpgroup's 64 (see
  // hopper.cuh for the fragment layout)
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int t4 = lane % 4;
  const int qw0 = q0 + wg * 64;
  const int qpos0 = qw0 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;
  const float scale2 = scale * LOG2E;
  const long long row = (long long)bh * Sq;
  // rows past Sq: Q and dO load as zeros, so with lse = delta = 0 their
  // p is 1 and their ds 0; they are never written
  const float l0 = qpos0 < Sq ? lse[row + qpos0] * LOG2E : 0.f;
  const float l1 = qpos1 < Sq ? lse[row + qpos1] * LOG2E : 0.f;
  const float dl0 = qpos0 < Sq ? delta[row + qpos0] : 0.f;
  const float dl1 = qpos1 < Sq ? delta[row + qpos1] : 0.f;
  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  if (n > 0) mbar_wait(q_full, 0);
  const unsigned char* q_wg = q_s + wg * 64 * 128;
  const unsigned char* do_wg = do_s + wg * 64 * 128;

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = (lo + i) * DQ_BK;
    const unsigned char* kb = k_s + s * L::KV_BYTES;
    const unsigned char* vb = v_s + s * L::KV_BYTES;

    // S = Q K^T and dP = dO V^T (64 x 64 per warpgroup)
    float sacc[DQ_BK / 2], pacc[DQ_BK / 2];
    mbar_wait(&kv_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<DQ_BK>::template ss<0>(
          sacc, desc_sw128(q_wg + c * DQ_BQ * 128 + off, 16, 1024),
          desc_sw128(kb + c * DQ_BK * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<DQ_BK>::template ss<0>(
          pacc, desc_sw128(do_wg + c * DQ_BQ * 128 + off, 16, 1024),
          desc_sw128(vb + c * DQ_BK * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);

    // P under the mask guard (edge blocks only), dS = P (dP - delta) scale,
    // dS in bf16: the A operand of dQ += dS K
    const bool edge = (k0 + DQ_BK > Sk) ||
                      (causal && k0 + DQ_BK - 1 > qw0) ||
                      (window > 0 && qw0 + 63 - k0 >= window);
    uint32_t dsa[DQ_BK / 16][4];
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sacc[4 * j + e] * scale2 - (e < 2 ? l0 : l1));
        if (edge)
          p = live(e < 2 ? qpos0 : qpos1, k0 + 8 * j + 2 * t4 + (e & 1), Sq,
                   Sk, causal, window)
                  ? p
                  : 0.f;
        d[e] = p * (pacc[4 * j + e] - (e < 2 ? dl0 : dl1)) * scale;
      }
      dsa[j / 2][2 * (j % 2)] = pack_bf16(d[0], d[1]);
      dsa[j / 2][2 * (j % 2) + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DQ_BK / 16; ++kc)
      Mma<D>::rs_tb(dqacc, dsa[kc],
                    desc_sw128(kb + kc * 2048, DQ_BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    mbar_arrive(&kv_empty[s]);
  }

  float* dqb = dq + b * dq_sb + h * dq_sh;
  if (qpos0 < Sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dqb + qpos0 * dq_ss + 8 * j + 2 * t4) =
          make_float2(dqacc[4 * j], dqacc[4 * j + 1]);
  }
  if (qpos1 < Sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dqb + qpos1 * dq_ss + 8 * j + 2 * t4) =
          make_float2(dqacc[4 * j + 2], dqacc[4 * j + 3]);
  }
}

template <int D>
struct DkvSmem {
  static constexpr int KV_BYTES = KV_BK * D * 2;  // K or V
  static constexpr int Q_BYTES = KV_BQ * D * 2;   // one Q or dO stage
  static constexpr int ROW_BYTES = 2 * KV_BQ * 4;  // a step's lse, delta
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * Q_BYTES +
                              STAGES * ROW_BYTES + (1 + 2 * STAGES) * 8 +
                              1024;
};

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, const int* __restrict__ ranges, int H, int G,
    int Sq, int Sk, int causal, int window, float scale, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss) {
  using L = DkvSmem<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + L::KV_BYTES;
  unsigned char* q_s = v_s + L::KV_BYTES;                // [stage]
  unsigned char* do_s = q_s + STAGES * L::Q_BYTES;       // [stage]
  // [stage][lse * log2e of KV_BQ rows, then delta of KV_BQ rows]
  float* rows = reinterpret_cast<float*>(do_s + STAGES * L::Q_BYTES);
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(rows + STAGES * 2 * KV_BQ);
  uint64_t* qd_full = kv_full + 1;
  uint64_t* qd_empty = qd_full + STAGES;

  const int Hkv = H / G;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int ik = blockIdx.y;  // causal: k block 0 sees every q block
  const int k0 = ik * KV_BK;
  const int lo = ranges[2 * ik], hi = ranges[2 * ik + 1];
  const int n = (hi - lo + 1) * G;  // (q block, head) steps; <= 0: empty
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // lane 0's expect_tx arrival and one arrival per lane of the feeding
      // warp after it wrote its lse / delta entries
      mbar_init(&qd_full[s], 1 + 32);
      mbar_init(&qd_empty[s], KV_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;

  // The first warp also feeds the ring: step i's Q and dO by TMA (lane 0)
  // and its lse * log2e and delta rows into shared memory (every lane),
  // once both warpgroups released the stage (step i - 2).  Rows past Sq:
  // Q and dO load as zeros, so with lse = delta = 0 their p^T . dO and
  // ds^T . Q add exactly 0.
  const bool feeder = threadIdx.x < 32;
  auto feed = [&](int i) {
    const int s = i % STAGES;
    const int q0 = (lo + i / G) * KV_BQ, h = hk * G + i % G;
    mbar_wait(&qd_empty[s], ((i / STAGES) & 1) ^ 1);
    if (lane == 0) {
      unsigned char* qb = q_s + s * L::Q_BYTES;
      unsigned char* dob = do_s + s * L::Q_BYTES;
      mbar_expect_tx(&qd_full[s], 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(qb + c * KV_BQ * 128, &tq, &qd_full[s], 64 * c, q0, h, b);
        tma_load_4d(dob + c * KV_BQ * 128, &tdo, &qd_full[s], 64 * c, q0, h,
                    b);
      }
    }
    float* rw = rows + s * 2 * KV_BQ;
    const long long base = ((long long)b * H + h) * Sq;
    for (int r = lane; r < KV_BQ; r += 32) {
      const bool in = q0 + r < Sq;
      rw[r] = in ? lse[base + q0 + r] * LOG2E : 0.f;
      rw[KV_BQ + r] = in ? delta[base + q0 + r] : 0.f;
    }
    mbar_arrive(&qd_full[s]);
  };
  if (feeder && n > 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(k_s + c * KV_BK * 128, &tk, kv_full, 64 * c, k0, hk, b);
        tma_load_4d(v_s + c * KV_BK * 128, &tv, kv_full, 64 * c, k0, hk, b);
      }
    }
    feed(0);
  }

  // this thread's key rows r and r + 8 of its warpgroup's 64
  const int t4 = lane % 4;
  const int kw0 = k0 + wg * 64;
  const int kpos0 = kw0 + warp * 16 + lane / 4, kpos1 = kpos0 + 8;
  const float scale2 = scale * LOG2E;
  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  if (n > 0) mbar_wait(kv_full, 0);
  const unsigned char* k_wg = k_s + wg * 64 * 128;
  const unsigned char* v_wg = v_s + wg * 64 * 128;

  for (int i = 0; i < n; ++i) {
    if (feeder && i + 1 < n) feed(i + 1);  // loads under this step's math
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int q0 = (lo + i / G) * KV_BQ;
    const unsigned char* qb = q_s + s * L::Q_BYTES;
    const unsigned char* dob = do_s + s * L::Q_BYTES;
    const float* rw = rows + s * 2 * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x KV_BQ q rows)
    float st[KV_BQ / 2], dpt[KV_BQ / 2];
    mbar_wait(&qd_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<KV_BQ>::template ss<0>(
          st, desc_sw128(k_wg + c * KV_BK * 128 + off, 16, 1024),
          desc_sw128(qb + c * KV_BQ * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      Mma<KV_BQ>::template ss<0>(
          dpt, desc_sw128(v_wg + c * KV_BK * 128 + off, 16, 1024),
          desc_sw128(dob + c * KV_BQ * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T under the mask guard (edge steps only), dS^T; lse and delta vary
    // along the columns (q rows)
    const bool edge = (kw0 + 64 > Sk) || (causal && kw0 + 63 > q0) ||
                      (window > 0 && q0 + KV_BQ - 1 - kw0 >= window);
    uint32_t pa[KV_BQ / 16][4], dsa[KV_BQ / 16][4];
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(rw + 8 * j + 2 * t4);
      const float2 dl =
          *reinterpret_cast<const float2*>(rw + KV_BQ + 8 * j + 2 * t4);
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ex2(st[4 * j + e] * scale2 - ((e & 1) ? l2.y : l2.x));
        if (edge)
          x = live(q0 + 8 * j + 2 * t4 + (e & 1), e < 2 ? kpos0 : kpos1, Sq,
                   Sk, causal, window)
                  ? x
                  : 0.f;
        p[e] = x;
        d[e] = x * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      dsa[j / 2][2 * (j % 2)] = pack_bf16(d[0], d[1]);
      dsa[j / 2][2 * (j % 2) + 1] = pack_bf16(d[2], d[3]);
    }

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KV_BQ / 16; ++kc)
      Mma<D>::rs_tb(dvacc, pa[kc],
                    desc_sw128(dob + kc * 2048, KV_BQ * 128, 1024), 1);
#pragma unroll
    for (int kc = 0; kc < KV_BQ / 16; ++kc)
      Mma<D>::rs_tb(dkacc, dsa[kc],
                    desc_sw128(qb + kc * 2048, KV_BQ * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    mbar_arrive(&qd_empty[s]);
  }

  float* dkb = dk + b * dk_sb + hk * dk_sh;
  float* dvb = dv + b * dv_sb + hk * dv_sh;
  if (kpos0 < Sk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dkb + kpos0 * dk_ss + 8 * j + 2 * t4) =
          make_float2(dkacc[4 * j], dkacc[4 * j + 1]);
      *reinterpret_cast<float2*>(dvb + kpos0 * dv_ss + 8 * j + 2 * t4) =
          make_float2(dvacc[4 * j], dvacc[4 * j + 1]);
    }
  }
  if (kpos1 < Sk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dkb + kpos1 * dk_ss + 8 * j + 2 * t4) =
          make_float2(dkacc[4 * j + 2], dkacc[4 * j + 3]);
      *reinterpret_cast<float2*>(dvb + kpos1 * dv_ss + 8 * j + 2 * t4) =
          make_float2(dvacc[4 * j + 2], dvacc[4 * j + 3]);
    }
  }
}

template <int D>
int launch_dq_wgmma(const CUtensorMap* maps, const void* lse,
                    const void* delta, void* dq, const void* ranges, int B,
                    int H, int G, int Sq, int Sk, int nq, int causal,
                    int window, float scale, const long long* st,
                    cudaStream_t stream) {
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, nq);
  kern<<<grid, WG_THREADS, DqSmem<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<const int*>(ranges), H, G, Sq, Sk, nq, causal, window,
      scale, st[0], st[1], st[2]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const CUtensorMap* maps, const void* lse,
                     const void* delta, void* dk, void* dv,
                     const void* ranges, int B, int H, int G, int Sq, int Sk,
                     int nk, int causal, int window, float scale,
                     const long long* st, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * (H / G), nk);
  kern<<<grid, KV_THREADS, DkvSmem<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<const int*>(ranges), H, G, Sq, Sk,
      causal, window, scale, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// The four TMA descriptors of q, k, v, do (bf16, (B, S, H, D) read through
// the (batch, head, seq) strides in `st`, elements), q and do in boxes of
// `bq` rows, k and v in boxes of `bk`.  False if one cannot be encoded.
bool encode_maps(CUtensorMap* maps, const void* q, const void* k,
                 const void* v, const void* dout, int B, int H, int G,
                 int Sq, int Sk, int D, const long long* st, int bq,
                 int bk) {
  const uint32_t qbox[4] = {64, (uint32_t)bq, 1, 1};
  const uint32_t kbox[4] = {64, (uint32_t)bk, 1, 1};
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)H,
                          (uint64_t)B};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)(H / G),
                          (uint64_t)B};
  const void* base[4] = {q, k, v, dout};
  for (int t = 0; t < 4; ++t) {
    const long long* s = st + 3 * t;
    const uint64_t bytes[3] = {(uint64_t)s[2] * 2, (uint64_t)s[1] * 2,
                               (uint64_t)s[0] * 2};
    const bool kv = t == 1 || t == 2;
    if (hopper_host::encode_bf16(&maps[t], 4, base[t], kv ? kd : qd, bytes,
                                 kv ? kbox : qbox) != 0)
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// route "flash_bwd_simt": the CUDA-core kernels
// ---------------------------------------------------------------------------

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
extern "C" int flash_bwd_dq_simt(const void* q, const void* k, const void* v,
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

// As flash_bwd_dq_simt, for dk and dv (f32, each written through its strides).
// ranges: (nk, 2) int32 inclusive q-block range of each k block.  strides:
// (batch, head, seq) of q, k, v, do, dk, dv.
extern "C" int flash_bwd_dkv_simt(const void* q, const void* k, const void* v,
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

// bf16 q, do (B, H, Sq, D), k, v (B, H / G, Sk, D), read through strides:
// `st` holds the (batch, head, seq) TMA strides in elements of q, k, v and
// do (12; each a multiple of 8, bases 16-byte aligned), then those of dq
// (3).  D 64 or 128.  lse, delta: f32 (B * H, Sq) contiguous.  dq: f32.
// ranges: (nq, 2) int32 inclusive k-block range of each 128-row q block
// over 64-key blocks.  Returns cudaGetLastError(), -1 for a D this file
// does not build, -2 when a TMA descriptor cannot be encoded.
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const void* ranges, int B, int H,
                                  int G, int Sq, int Sk, int D, int nq,
                                  int causal, int window,
                                  const long long* st, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return -1;
  CUtensorMap maps[4];
  if (!encode_maps(maps, q, k, v, dout, B, H, G, Sq, Sk, D, st, DQ_BQ,
                   DQ_BK))
    return -2;
#define ARGS                                                          \
  maps, lse, delta, dq, ranges, B, H, G, Sq, Sk, nq, causal, window, \
      scale, st + 12, s
  if (D == 128) return launch_dq_wgmma<128>(ARGS);
  return launch_dq_wgmma<64>(ARGS);
#undef ARGS
}

// As flash_bwd_dq_wgmma, for dk and dv (f32).  `st`: the TMA strides of
// q, k, v, do (12), then the (batch, head, seq) strides of dk and of dv.
// ranges: (nk, 2) int32 inclusive q-block range of each 128-key block over
// 64-row q blocks.
extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const void* ranges,
                                   int B, int H, int G, int Sq, int Sk, int D,
                                   int nk, int causal, int window,
                                   const long long* st, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return -1;
  CUtensorMap maps[4];
  if (!encode_maps(maps, q, k, v, dout, B, H, G, Sq, Sk, D, st, KV_BQ,
                   KV_BK))
    return -2;
#define ARGS                                                              \
  maps, lse, delta, dk, dv, ranges, B, H, G, Sq, Sk, nk, causal, window, \
      scale, st + 12, s
  if (D == 128) return launch_dkv_wgmma<128>(ARGS);
  return launch_dkv_wgmma<64>(ARGS);
#undef ARGS
}
