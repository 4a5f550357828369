// Dense flash decode for Hopper (sm_90a): one new token per sequence
// attends its (B, Hkv, S, D) KV cache up to its length, GQA grouped, with
// the history split over CTAs and the partial results combined by their
// log-sum-exp.
//
// Replaces the TPU kernel `_decode_kernel` (src/repro/kernels/attention.py:577,
// entry `flash_decode_pallas`).
//
// What bounds it on the H100: bytes.  Each live cached token's K and V rows
// are read once (2 x Hkv x D x 2 B a token in bf16) for 4 x D x G flops per
// kv head, far below the ~295 flop/byte the card needs before its arithmetic
// is the limit.  At qwen3-4b's decode shape the live K/V are ~24 MB, a
// 0.0075 ms bound at 3.35 TB/s: the kernel has to keep every SM loading.
//   * The TPU kernel's sequential `block_k` grid axis becomes the split:
//     one CTA per (split, kv head, sequence), where a split is `block_k`
//     consecutive cache positions (the reference's own `block_k`, after its
//     clamp `decode_block_k`), so B x Hkv x ceil(S / block_k) CTAs fill the
//     card (128 at qwen3-4b's shape with the default 512).  A split at or
//     past `lengths[b]` reads nothing and writes nothing.
//   * Inside a CTA the G = H / Hkv query heads of the group stay together,
//     so each live K/V row is read once for all of them.  A row is read by
//     a group of L lanes with 16-byte loads (L = D / 8 in bf16: half a warp
//     at D 128, so a warp covers two tokens per load instruction); each
//     group walks its own tokens, U at a time, with the next U tokens' K
//     and V loads in flight while this step computes, and keeps its own
//     online softmax (m, l, acc) in f32 registers.  The G x U score dots
//     reduce over the group's lanes with warp shuffles, one round for all
//     of them at a time; max, exp and PV run on every lane at once.
//   * The groups of a CTA merge by their maxima (shuffles inside a warp,
//     shared memory across warps), and the CTA writes its split's (m, l,
//     acc) to an f32 workspace the wrapper allocates; a second kernel
//     (`decode_combine_kernel`, shared with the paged kernel through
//     `decode_common.cuh`) forms sum_i e^(m_i - M) acc_i /
//     sum_i e^(m_i - M) l_i over each sequence's live splits in split
//     order.  With one split the CTA writes the output itself.
//   * The caches are read through their (batch, head, seq) strides in
//     place: no padded or reshaped copy is made (the JAX wrapper pads S to
//     a block multiple and reshapes), and tokens at or past `lengths[b]`
//     are never read.  Operands whose rows or bases are not 16-byte
//     aligned take the same kernel with scalar loads.
//   * The softmax works in the log2 domain with the TPU kernel's -1e30
//     guard: a masked position adds exactly 0, and l == 0 drains as 1, so
//     a length of 0 gives 0.  p stays f32.
//
// Launch contract (checked by the Python wrapper): G <= MAX_G, D <= 256;
// q (B, H, D), caches (B, Hkv, S, D) and out (B, H, D) with the last
// dimension contiguous; lengths (B,) int32; for nsplit > 1, part_acc f32
// (B, H, nsplit, D) and part_ml f32 (B, H, nsplit, 2), contiguous.
#include "decode_common.cuh"

namespace {

using namespace decode;

// One CTA: split `blockIdx.x` of sequence `blockIdx.z`, kv head
// `blockIdx.y`.  Lane group `grp` (L lanes) takes tokens t0 + grp,
// t0 + grp + NG, ...; lane `lig` of the group holds elements
// (lig + i L) W .. + W - 1 of a row, i < NV.
template <typename T, int W, int NV, int GM>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int G, int D,
    int S, int block_k, int nsplit, int L, float scale2, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh) {
  extern __shared__ float red[];   // merge_and_store's
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const int len = min(max(lengths[b], 0), S);
  const int t0 = sp * block_k;
  if (t0 >= len && nsplit > 1) return;   // the combine skips this split
  const int t1 = min(t0 + block_k, len);
  const int tid = threadIdx.x;
  const int grp = tid / L, lig = tid % L, NG = THREADS / L;

  float qf[GM][NV][W];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = (lig + i * L) * W;
      Vec<T, W> qv;
      qv.zero();
      if (g < G && d < D)
        qv.load(q + b * q_sb + (long long)(h * G + g) * q_sh + d);
      qv.get(qf[g][i]);
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

  constexpr int UNROLL = unroll<GM, NV, W>();
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  // K and V rows of this group's next UNROLL tokens, raw: fetched one
  // step ahead, so they load while the current step computes
  Vec<T, W> kn[UNROLL][NV], vn[UNROLL][NV];
  auto fetch = [&](int tb) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int tu = tb + grp + u * NG;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = (lig + i * L) * W;
        kn[u][i].zero();
        vn[u][i].zero();
        if (tu < t1 && d < D) {
          kn[u][i].load(kb + tu * k_ss + d);
          vn[u][i].load(vb + tu * v_ss + d);
        }
      }
    }
  };
  if (t0 < t1) fetch(t0);
  // the trip count is the CTA's, so a warp's lane groups shuffle together;
  // a group's tokens past t1 are masked
  for (int tb = t0; tb < t1; tb += NG * UNROLL) {
    float kx[UNROLL][NV][W], vx[UNROLL][NV][W];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kn[u][i].get(kx[u][i]);
        vn[u][i].get(vx[u][i]);
      }
    if (tb + NG * UNROLL < t1) fetch(tb + NG * UNROLL);
    const int t = tb + grp;
    // the group's partial dots, then all G x UNROLL of them reduced over
    // the group's lanes together, one shuffle round at a time
    float s[GM][UNROLL];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < W; ++e) dot += qf[g][i][e] * kx[u][i][e];
        s[g][u] = dot;
      }
#pragma unroll
    for (int r = 4; r >= 0; --r) {
      const int off = 1 << r;
      if (off < L)
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s[g][u] = (t + u * NG < t1) ? s[g][u] * scale2 : NEG_INF;
        mx = fmaxf(mx, s[g][u]);
      }
      // masked tokens give exactly 0; while the group has seen no live
      // token, m = mx = -1e30 and alpha = 1 rescales zeros
      const float alpha = hopper::ex2(m[g] - mx);
      float p[UNROLL], ps = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = (t + u * NG < t1) ? hopper::ex2(s[g][u] - mx) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          float a = acc[g][i][e] * alpha;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) a += p[u] * vx[u][i][e];
          acc[g][i][e] = a;
        }
    }
  }

  merge_and_store<T, W, NV, GM>(
      m, l, acc, red, G, D, L,
      Dest<T>{out, part_acc, part_ml, o_sb, o_sh, b, h, H, sp, nsplit});
}

template <typename T, int W, int NV, int GM>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lens, void* out, void* part_acc, void* part_ml,
                 int B, int Hkv, int G, int D, int S, int block_k, int nsplit,
                 int L, float scale, const long long* st,
                 cudaStream_t stream) {
  auto kern = decode_split_kernel<T, W, NV, GM>;
  const int smem = (int)sizeof(float) * merge_floats(GM, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nsplit, Hkv, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), G, D, S, block_k, nsplit, L,
      scale * LOG2E, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return launch_combine<T>(part_acc, part_ml, lens, out, B, Hkv * G, D, S,
                           block_k, nsplit, st[8], st[9], stream);
}

template <typename T, int W, int NV>
int by_group(int G, const void* q, const void* k, const void* v,
             const void* lens, void* out, void* pa, void* pm, int B, int Hkv,
             int D, int S, int block_k, int nsplit, int L, float scale,
             const long long* st, cudaStream_t s) {
#define ARGS q, k, v, lens, out, pa, pm, B, Hkv, G, D, S, block_k, nsplit, L, \
             scale, st, s
  if (G <= 1) return launch_split<T, W, NV, 1>(ARGS);
  if (G <= 2) return launch_split<T, W, NV, 2>(ARGS);
  if (G <= 4) return launch_split<T, W, NV, 4>(ARGS);
  return launch_split<T, W, NV, 8>(ARGS);
#undef ARGS
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lens,
             void* out, void* pa, void* pm, int B, int Hkv, int G, int D,
             int S, int block_k, int nsplit, float scale,
             const long long* st, cudaStream_t s) {
  constexpr int VW = 16 / (int)sizeof(T);   // elements in 16 bytes
  bool vec = D % VW == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(out);
  for (int i = 0; i < 10; ++i) vec = vec && st[i] % VW == 0;
  const int nvec = vec ? D / VW : D;
  const int L = lanes_for(nvec);
  const int nv = (nvec + L - 1) / L;
#define ARGS G, q, k, v, lens, out, pa, pm, B, Hkv, D, S, block_k, nsplit, L, \
             scale, st, s
  if (vec && nv == 1) return by_group<T, VW, 1>(ARGS);
  if constexpr (VW == 4)   // f32 rows of up to 64 vectors
    if (vec && nv == 2) return by_group<T, VW, 2>(ARGS);
  if (!vec && nv <= 8) return by_group<T, 1, 8>(ARGS);
#undef ARGS
  return -1;
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (q, caches and out share it).  strides: q (b, h),
// k (b, h, s), v (b, h, s), out (b, h), in elements.  block_k: cache
// positions a split covers; nsplit = ceil(S / block_k).  part_acc /
// part_ml: the split workspace (unused when nsplit == 1).  Returns
// cudaGetLastError(), or -1 for a shape or dtype this file does not build.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* part_acc,
                            void* part_ml, int dtype, int B, int Hkv, int G,
                            int D, int S, int block_k, int nsplit,
                            const long long* strides, float scale,
                            void* stream) {
  if (G > MAX_G || G < 1 || D < 1 || D > 256 || block_k < 1 ||
      nsplit != (S + block_k - 1) / block_k)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(q, k, v, lens, out, part_acc, part_ml, B,
                                   Hkv, G, D, S, block_k, nsplit, scale,
                                   strides, s);
  if (dtype == 1)
    return dispatch<float>(q, k, v, lens, out, part_acc, part_ml, B, Hkv, G,
                           D, S, block_k, nsplit, scale, strides, s);
  return -1;
}
