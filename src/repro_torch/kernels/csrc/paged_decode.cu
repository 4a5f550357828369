// Paged flash decode for Hopper (sm_90a): one new token per slot attends its
// paged KV history in a global page pool.
//
// Replaces the TPU kernel `_paged_decode_kernel`
// (src/repro/kernels/paged_attention.py:42, entry `paged_flash_decode_pallas`).
//
// What bounds it on the H100: bytes.  Every cached token's K and V row is
// read once (bf16: 2 x Hkv x D x 2 B a token; int8: half that plus two f32
// scales) for 4 x D x G flops per kv head, far below the ~295 flop/byte
// the card needs before its arithmetic is the limit.  The design therefore
// reads each live page exactly once and nothing else:
//   * one CTA per (slot b, kv head h) keeps the G = H / Hkv query heads of
//     the group together, so a K/V page is read once for all of them;
//   * the CTA reads its page ids from `page_table[b, :]` itself (the TPU
//     kernel got them by scalar prefetch) and walks only the pages that hold
//     tokens below `lengths[b]`: pages past the length are never read;
//   * the pool is read in the engine's own (P, page, Hkv, D) layout through
//     its strides, so no transposed copy of the pool is ever made;
//   * int8 pages are dequantized with their per-(token, head) f32 scales as
//     they land in shared memory, so no float copy of the pool exists.
// The online softmax (m, l, acc) stays in f32; masked positions contribute
// exactly 0, and l == 0 drains as 1, as in the TPU kernel.
// With one token per slot the grid holds only B x Hkv CTAs, fewer than the
// card's 132 SMs at small batch: splitting the history across CTAs (a
// second reduction pass) is left to a later change.
//
// Launch contract (checked by the Python wrapper before the launch):
//   blockDim.x == D rounded up to a warp, D <= 256, G <= MAX_G;
//   q/out (B, H, D), pools (P, page, Hkv, D) and scales (P, page, Hkv) with
//   the last dimension contiguous; page_table (B, max_pages) int32 with
//   contiguous rows; lengths (B,) int32, each >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_G = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename QT, typename KVT, bool QUANT>
__global__ void paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pages,
    const KVT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, QT* __restrict__ out, int G, int D,
    int page, int max_pages, float scale, long long q_sb, long long q_sh,
    long long kv_sp, long long kv_st, long long kv_sh, long long sc_sp,
    long long sc_st, long long sc_sh, long long pt_sb, long long o_sb,
    long long o_sh) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;  // kv head
  const int d = threadIdx.x;  // head-dim column; threads d >= D only help
  const bool live = d < D;    // with the score products
  float* q_s = smem;                  // [G][D]
  float* k_s = q_s + G * D;           // [page][D + 1]
  float* v_s = k_s + page * (D + 1);  // [page][D]
  float* s_s = v_s + page * D;        // [G][page]: scores, then p
  float* m_s = s_s + G * page;        // [G]
  float* l_s = m_s + G;               // [G]
  float* a_s = l_s + G;               // [G]: this page's rescale alpha

  if (live)
    for (int g = 0; g < G; ++g)
      q_s[g * D + d] = to_f(q[b * q_sb + (long long)(h * G + g) * q_sh + d]);
  if (d < G) {
    m_s[d] = NEG_INF;
    l_s[d] = 0.f;
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  const int len = lengths[b];
  int n_pages = (len + page - 1) / page;
  if (n_pages > max_pages) n_pages = max_pages;
  for (int j = 0; j < n_pages; ++j) {
    const long long phys = page_table[b * pt_sb + j];
    __syncthreads();  // last page's k_s / v_s / s_s reads are done
    for (int t = 0; live && t < page; ++t) {
      const long long off = phys * kv_sp + t * kv_st + h * kv_sh + d;
      float kx = to_f(k_pages[off]);
      float vx = to_f(v_pages[off]);
      if (QUANT) {
        const long long so = phys * sc_sp + t * sc_st + h * sc_sh;
        kx *= k_scale[so];
        vx *= v_scale[so];
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();
    for (int i = d; i < G * page; i += blockDim.x) {
      const int g = i / page, t = i % page;
      float dot = 0.f;
      for (int e = 0; e < D; ++e) dot += q_s[g * D + e] * k_s[t * (D + 1) + e];
      s_s[i] = (j * page + t < len) ? dot * scale : NEG_INF;
    }
    __syncthreads();
    if (d < G) {
      const int g = d;
      const float m_prev = m_s[g];
      float mx = NEG_INF;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, s_s[g * page + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        // mask guard: a masked position adds exactly 0
        const float p =
            (j * page + t < len) ? expf(s_s[g * page + t] - m_new) : 0.f;
        s_s[g * page + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G && live) {
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv += s_s[g * page + t] * v_s[t * D + d];
        acc[g] = acc[g] * a_s[g] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G && live) {
      const float l = l_s[g];
      const float safe = (l == 0.f) ? 1.f : l;
      store(&out[b * o_sb + (long long)(h * G + g) * o_sh + d], acc[g] / safe);
    }
  }
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* lens, void* out, int B,
           int Hkv, int G, int D, int page, int max_pages, float scale,
           long long q_sb, long long q_sh, long long kv_sp, long long kv_st,
           long long kv_sh, long long sc_sp, long long sc_st, long long sc_sh,
           long long pt_sb, long long o_sb, long long o_sh,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (G * D + page * (D + 1) + page * D + G * page + 3 * G);
  dim3 grid(B, Hkv);
  const int threads = (D + 31) / 32 * 32;
  paged_decode_kernel<QT, KVT, QUANT><<<grid, threads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<QT*>(out), G, D, page,
      max_pages, scale, q_sb, q_sh, kv_sp, kv_st, kv_sh, sc_sp, sc_st, sc_sh,
      pt_sb, o_sb, o_sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = bf16, 1 = f32 (q, out and an unquantized pool share it);
// quant: 1 = int8 pool with f32 scales.  Returns cudaGetLastError(), or -1
// for a combination this file does not instantiate.
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* pt,
                            const void* lens, void* out, int q_dtype,
                            int quant, int B, int Hkv, int G, int D, int page,
                            int max_pages, long long q_sb, long long q_sh,
                            long long kv_sp, long long kv_st, long long kv_sh,
                            long long sc_sp, long long sc_st, long long sc_sh,
                            long long pt_sb, long long o_sb, long long o_sh,
                            float scale, void* stream) {
  if (G > MAX_G || G < 1 || D < 1 || D > 256) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                \
  q, k, v, ks, vs, pt, lens, out, B, Hkv, G, D, page, max_pages, scale,    \
      q_sb, q_sh, kv_sp, kv_st, kv_sh, sc_sp, sc_st, sc_sh, pt_sb, o_sb, \
      o_sh, s
  if (q_dtype == 0 && !quant) return launch<__nv_bfloat16, __nv_bfloat16, false>(ARGS);
  if (q_dtype == 0 && quant) return launch<__nv_bfloat16, int8_t, true>(ARGS);
  if (q_dtype == 1 && !quant) return launch<float, float, false>(ARGS);
  if (q_dtype == 1 && quant) return launch<float, int8_t, true>(ARGS);
#undef ARGS
  return -1;
}
