// Paged flash decode for Hopper (sm_90a): one new token per slot attends its
// paged KV history in a global page pool, with the history split over CTAs
// and the partial results combined by their log-sum-exp.
//
// Replaces the TPU kernel `_paged_decode_kernel`
// (src/repro/kernels/paged_attention.py:42, entry `paged_flash_decode_pallas`).
//
// What bounds it on the H100: bytes.  Every live cached token's K and V row
// is read once (bf16: 2 x Hkv x D x 2 B a token; int8: half that plus two
// f32 scales) for 4 x D x G flops per kv head, far below the ~295 flop/byte
// the card needs before its arithmetic is the limit.  So the kernel has to
// keep every SM loading:
//   * One CTA per (split, kv head, slot): a split is `pages_per_split`
//     whole pages of the slot's table, chosen on the host from shapes alone
//     (`paged_attention.paged_decode_plan`), so B x Hkv x nsplit CTAs fill
//     the card.  A split at or past `lengths[b]` reads nothing and writes
//     nothing.  The CTA reads its split's page ids from `page_table[b, :]`
//     once, into shared memory, and resolves each token's row from them.
//   * Inside a CTA the G = H / Hkv query heads of the group stay together,
//     so each live K/V row is read once for all of them.  A row is read by
//     a group of L lanes with 16-byte loads (L = D / 8 in bf16 and D / 16
//     in int8: at D 128 a warp covers 2 or 4 tokens per load instruction;
//     int8 at G 8 takes 8-byte loads, D / 8 lanes, to keep q and the
//     accumulators of eight heads in registers).  Each group walks its own
//     tokens, U at a time, with the next U tokens' raw K/V (and scales) in
//     flight while this step computes.  The G x U score dots reduce over
//     the group's lanes with warp shuffles, one round for all of them.
//   * int8 pages are widened in registers (`decode::int8x4_to_f`: one PRMT
//     and one FADD an element, not the quarter-rate I2F), and each token's
//     k and v scale is one broadcast load per lane group: the k scale
//     multiplies the score and the v scale the token's p, so no element is
//     scaled.  The f32 sums differ from the plain version's
//     dequantize-then-dot by rounding (~1e-7 relative).
//   * The groups of a CTA merge by their maxima (shuffles inside a warp,
//     shared memory across warps).  With one split the CTA writes the
//     output; else its (m, l, acc) goes to the f32 workspace and
//     `decode::decode_combine_kernel` sums the live splits in split order.
//   * The pool is read in the engine's own (P, page, Hkv, D) layout through
//     its strides (a layer's slice of the (L, P, ...) pool in place), so no
//     transposed copy is made.  Pools whose rows or bases are not 16-byte
//     aligned take the same kernel with scalar loads.
//   * The softmax works in the log2 domain with the TPU kernel's -1e30
//     guard: a masked position adds exactly 0, and l == 0 drains as 1.
//
// Launch contract (checked by the Python wrapper): G <= MAX_G, D <= 256;
// q/out (B, H, D), pools (P, page, Hkv, D) and scales (P, page, Hkv) with
// the last dimension contiguous; page_table (B, max_pages) int32 with
// contiguous rows; lengths (B,) int32, each >= 1; nsplit ==
// ceil(max_pages / pages_per_split); for nsplit > 1, part_acc f32
// (B, H, nsplit, D) and part_ml f32 (B, H, nsplit, 2), contiguous.
#include "decode_common.cuh"

namespace {

using namespace decode;

// Element strides: q (b, h), pool (page, token, head), scales (page, token,
// head), table (b), out (b, h).
struct Strides {
  long long q_sb, q_sh, kv_sp, kv_st, kv_sh, sc_sp, sc_st, sc_sh, pt_sb,
      o_sb, o_sh;
};

// One CTA: split `blockIdx.x` of slot `blockIdx.z`, kv head `blockIdx.y`.
// Lane group `grp` (L lanes) takes tokens t0 + grp, t0 + grp + NG, ...;
// lane `lig` of the group holds elements (lig + i L) W .. + W - 1 of a
// row, i < NV.
template <typename QT, typename KVT, bool QUANT, int W, int NV, int GM>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k,
    const KVT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int G, int D,
    int page, int page_shift, int max_pages, int pps, int nsplit, int L,
    float scale2, Strides st) {
  // merge_and_store's, then the split's page ids
  extern __shared__ float red[];
  int* pid_s = reinterpret_cast<int*>(red + merge_floats(GM, D));
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const int len = min(max(lengths[b], 0), max_pages * page);
  const int t0 = sp * pps * page;
  if (t0 >= len && nsplit > 1) return;   // the combine skips this split
  const int t1 = min(t0 + pps * page, len);
  const int tid = threadIdx.x;
  const int grp = tid / L, lig = tid % L, NG = THREADS / L;

  const int* table = page_table + b * st.pt_sb + sp * pps;
  for (int i = tid; i * page < t1 - t0; i += THREADS) pid_s[i] = table[i];

  float qf[GM][NV][W];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int d = (lig + i * L) * W + e;
        qf[g][i][e] = (g < G && d < D)
                          ? to_f(q[b * st.q_sb +
                                   (long long)(h * G + g) * st.q_sh + d])
                          : 0.f;
      }
  float m[GM], l[GM], acc[GM][NV][W];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][i][e] = 0.f;
  }
  __syncthreads();   // pid_s

  constexpr int U = unroll<GM, NV, W>();
  // raw K and V rows (and scales) of this group's next U tokens: fetched
  // one step ahead, so they load while the current step computes
  Vec<KVT, W> kn[U][NV], vn[U][NV];
  float ksn[U], vsn[U];
  auto fetch = [&](int tb) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tu = tb + grp + u * NG;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kn[u][i].zero();
        vn[u][i].zero();
      }
      ksn[u] = vsn[u] = 0.f;
      if (tu < t1) {
        const int lt = tu - t0;
        const int j = page_shift >= 0 ? lt >> page_shift : lt / page;
        const long long phys = pid_s[j];
        const int o = lt - j * page;
        const long long row = phys * st.kv_sp + o * st.kv_st + h * st.kv_sh;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int d = (lig + i * L) * W;
          if (d < D) {
            kn[u][i].load(k + row + d);
            vn[u][i].load(v + row + d);
          }
        }
        if (QUANT) {
          const long long so = phys * st.sc_sp + o * st.sc_st + h * st.sc_sh;
          ksn[u] = __ldg(k_scale + so);
          vsn[u] = __ldg(v_scale + so);
        }
      }
    }
  };
  if (t0 < t1) fetch(t0);
  // the trip count is the CTA's, so a warp's lane groups shuffle together;
  // a group's tokens past t1 are masked
  for (int tb = t0; tb < t1; tb += NG * U) {
    Vec<KVT, W> kc[U][NV], vc[U][NV];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kc[u][i] = kn[u][i];
        vc[u][i] = vn[u][i];
      }
      ksc[u] = ksn[u];
      vsc[u] = vsn[u];
    }
    if (tb + NG * U < t1) fetch(tb + NG * U);
    const int t = tb + grp;
    // the group's partial dots, each K row widened where it is used, then
    // all G x U of them reduced over the group's lanes together
    float s[GM][U];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) s[g][u] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kx[W];
        kc[u][i].get(kx);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < W; ++e) s[g][u] += qf[g][i][e] * kx[e];
      }
#pragma unroll
    for (int r = 4; r >= 0; --r) {
      const int off = 1 << r;
      if (off < L)
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
    }
    // p of each head and token, the v scale folded in for the PV sum
    float pv[GM][U];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float sc = QUANT ? scale2 * ksc[u] : scale2;
        s[g][u] = (t + u * NG < t1) ? s[g][u] * sc : NEG_INF;
        mx = fmaxf(mx, s[g][u]);
      }
      // masked tokens give exactly 0; while the group has seen no live
      // token, m = mx = -1e30 and alpha = 1 rescales zeros
      const float alpha = hopper::ex2(m[g] - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (t + u * NG < t1) ? hopper::ex2(s[g][u] - mx) : 0.f;
        ps += p;
        pv[g][u] = QUANT ? p * vsc[u] : p;
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[g][i][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float vx[W];
        vc[u][i].get(vx);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) continue;
#pragma unroll
          for (int e = 0; e < W; ++e) acc[g][i][e] += pv[g][u] * vx[e];
        }
      }
  }

  merge_and_store<QT, W, NV, GM>(
      m, l, acc, red, G, D, L,
      Dest<QT>{out, part_acc, part_ml, st.o_sb, st.o_sh, b, h, H, sp, nsplit});
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *lens;
  void *out, *part_acc, *part_ml;
  int B, Hkv, G, D, page, max_pages, pps, nsplit;
  float scale;
  Strides st;
};

template <typename QT, typename KVT, bool QUANT, int W, int NV, int GM>
int launch_split(const Args& a, int L, cudaStream_t stream) {
  auto kern = paged_decode_split_kernel<QT, KVT, QUANT, W, NV, GM>;
  const int smem = (int)sizeof(float) * merge_floats(GM, a.D) +
                   (int)sizeof(int) * a.pps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int shift = (a.page & (a.page - 1)) == 0 ? __builtin_ctz(a.page) : -1;
  dim3 grid(a.nsplit, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k),
      static_cast<const KVT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.lens), static_cast<QT*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), a.G,
      a.D, a.page, shift, a.max_pages, a.pps, a.nsplit, L,
      a.scale * LOG2E, a.st);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  return launch_combine<QT>(a.part_acc, a.part_ml, a.lens, a.out, a.B,
                            a.Hkv * a.G, a.D, a.max_pages * a.page,
                            a.pps * a.page, a.nsplit, a.st.o_sb, a.st.o_sh,
                            stream);
}

// The kernel built for the group size, up to GMAX heads.
template <typename QT, typename KVT, bool QUANT, int W, int NV, int GMAX = 8>
int by_group(const Args& a, int L, cudaStream_t s) {
  if (a.G <= 1) return launch_split<QT, KVT, QUANT, W, NV, 1>(a, L, s);
  if (a.G <= 2) return launch_split<QT, KVT, QUANT, W, NV, 2>(a, L, s);
  if (a.G <= 4) return launch_split<QT, KVT, QUANT, W, NV, 4>(a, L, s);
  if constexpr (GMAX >= 8)
    return launch_split<QT, KVT, QUANT, W, NV, 8>(a, L, s);
  else
    return -1;
}

template <typename QT, typename KVT, bool QUANT>
int dispatch(const Args& a, cudaStream_t s) {
  // elements in 16 bytes; int8 at G 8 reads 8 bytes a load (see above)
  const int VW = QUANT && a.G > 4 ? 8 : 16 / (int)sizeof(KVT);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v);
  const bool vec = a.D % VW == 0 && bases % (VW * sizeof(KVT)) == 0 &&
                   a.st.kv_sp % VW == 0 && a.st.kv_st % VW == 0 &&
                   a.st.kv_sh % VW == 0;
  const int nvec = vec ? a.D / VW : a.D;
  const int L = lanes_for(nvec);
  const int nv = (nvec + L - 1) / L;
  if constexpr (QUANT) {   // D <= 256: one vector a lane
    if (vec && VW == 16) return by_group<QT, KVT, QUANT, 16, 1, 4>(a, L, s);
    if (vec) return launch_split<QT, KVT, QUANT, 8, 1, 8>(a, L, s);
  } else {
    constexpr int CW = 16 / (int)sizeof(KVT);
    if (vec && nv == 1) return by_group<QT, KVT, QUANT, CW, 1>(a, L, s);
    if constexpr (CW == 4)   // f32 rows of up to 64 vectors
      if (vec && nv == 2) return by_group<QT, KVT, QUANT, CW, 2>(a, L, s);
  }
  if (!vec && nv <= 8) return by_group<QT, KVT, QUANT, 1, 8>(a, L, s);
  return -1;
}

}  // namespace

// q_dtype: 0 = bf16, 1 = f32 (q, out and an unquantized pool share it);
// quant: 1 = int8 pool with f32 scales.  strides (elements): q (b, h), pool
// (page, token, head), scales (page, token, head), page table (b), out
// (b, h).  pps: pages a split covers; nsplit = ceil(max_pages / pps).
// part_acc / part_ml: the split workspace (unused when nsplit == 1).
// Returns cudaGetLastError(), or -1 for a combination this file does not
// build.
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* pt,
                            const void* lens, void* out, void* part_acc,
                            void* part_ml, int q_dtype, int quant, int B,
                            int Hkv, int G, int D, int page, int max_pages,
                            int pps, int nsplit, const long long* strides,
                            float scale, void* stream) {
  if (G > MAX_G || G < 1 || D < 1 || D > 256 || page < 1 || pps < 1 ||
      max_pages < 1 || nsplit != (max_pages + pps - 1) / pps)
    return -1;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10]};
  const Args a{q,   k,   v, ks, vs,   pt,        lens, out,    part_acc,
               part_ml, B, Hkv, G, D, page, max_pages, pps, nsplit,
               scale, st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !quant)
    return dispatch<__nv_bfloat16, __nv_bfloat16, false>(a, s);
  if (q_dtype == 0 && quant)
    return dispatch<__nv_bfloat16, int8_t, true>(a, s);
  if (q_dtype == 1 && !quant) return dispatch<float, float, false>(a, s);
  if (q_dtype == 1 && quant) return dispatch<float, int8_t, true>(a, s);
  return -1;
}
