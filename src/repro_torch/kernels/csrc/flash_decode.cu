// Dense flash decode for Hopper (sm_90a): one new token per sequence
// attends its (B, Hkv, S, D) KV cache up to its length, GQA grouped.
//
// Replaces the TPU kernel `_decode_kernel` (src/repro/kernels/attention.py:577,
// entry `flash_decode_pallas`).
//
// What bounds it on the H100: bytes.  Each live cached token's K and V rows
// are read once (2 x Hkv x D x 2 B a token in bf16) for 4 x D x G flops per
// kv head, far below the ~295 flop/byte the card needs before its arithmetic
// is the limit.  The design reads each live token exactly once and nothing
// else, with the structure of csrc/paged_decode.cu over a dense cache:
//   * one CTA per (sequence b, kv head h) keeps the G = H / Hkv query heads
//     of the group together, so a K/V row is read once for all of them (the
//     TPU kernel's (B * Hkv, G, D) grouping, without its reshape);
//   * the cache is read through its (batch, head, seq) strides in place: no
//     padded or reshaped copy is made (the JAX wrapper pads S to a block
//     multiple and reshapes), and tokens at or past `lengths[b]` are never
//     read; the TPU kernel's `block_k` becomes a fixed step of 32 tokens;
//   * the online softmax (m, l, acc) stays in f32 with the TPU kernel's
//     -1e30 guard; a masked position adds exactly 0 (p is zeroed, not taken
//     as exp(-1e30 - m)), and l == 0 drains as 1, so a length of 0 gives 0.
// With one token per sequence the grid holds only B x Hkv CTAs (32 at the
// qwen3-4b decode shape, for 132 SMs): splitting the history across CTAs (a
// second reduction pass) is left to a later change.
//
// Launch contract (checked by the Python wrapper): blockDim.x == D rounded
// up to a warp, D <= 256, G <= MAX_G; q (B, H, D), caches (B, Hkv, S, D) and
// out (B, H, D) with the last dimension contiguous; lengths (B,) int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_G = 8;
constexpr int STEP = 32;            // cached tokens staged per step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, int G, int D, int S,
    float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;   // kv head
  const int d = threadIdx.x;  // head-dim column; threads d >= D only help
  const bool live = d < D;    // with the score products
  float* q_s = smem;                  // [G][D]
  float* k_s = q_s + G * D;           // [STEP][D + 1]
  float* v_s = k_s + STEP * (D + 1);  // [STEP][D]
  float* s_s = v_s + STEP * D;        // [G][STEP]: scores, then p
  float* m_s = s_s + G * STEP;        // [G]
  float* l_s = m_s + G;               // [G]
  float* a_s = l_s + G;               // [G]: this step's rescale alpha

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

  const int len = min(max(lengths[b], 0), S);
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int t0 = 0; t0 < len; t0 += STEP) {
    const int n = min(STEP, len - t0);
    __syncthreads();  // last step's k_s / v_s / s_s reads are done
    for (int t = 0; live && t < n; ++t) {
      k_s[t * (D + 1) + d] = to_f(kb[(t0 + t) * k_ss + d]);
      v_s[t * D + d] = to_f(vb[(t0 + t) * v_ss + d]);
    }
    __syncthreads();
    for (int i = d; i < G * STEP; i += blockDim.x) {
      const int g = i / STEP, t = i % STEP;
      float dot = 0.f;
      if (t < n)
        for (int e = 0; e < D; ++e)
          dot += q_s[g * D + e] * k_s[t * (D + 1) + e];
      s_s[i] = (t < n) ? dot * scale : NEG_INF;
    }
    __syncthreads();
    if (d < G) {
      const int g = d;
      const float m_prev = m_s[g];
      float mx = NEG_INF;
      for (int t = 0; t < n; ++t) mx = fmaxf(mx, s_s[g * STEP + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < STEP; ++t) {
        // mask guard: a masked position adds exactly 0
        const float p = (t < n) ? expf(s_s[g * STEP + t] - m_new) : 0.f;
        s_s[g * STEP + t] = p;
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
        for (int t = 0; t < n; ++t) pv += s_s[g * STEP + t] * v_s[t * D + d];
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int B, int Hkv, int G, int D, int S, float scale,
           const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (G * D + STEP * (D + 1) + STEP * D + G * STEP + 3 * G);
  dim3 grid(B, Hkv);
  const int threads = (D + 31) / 32 * 32;
  flash_decode_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), G, D, S, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (q, caches and out share it).  strides: q (b, h),
// k (b, h, s), v (b, h, s), out (b, h), in elements.  Returns
// cudaGetLastError(), or -1 for a shape or dtype this file does not build.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lens, void* out, int dtype, int B,
                            int Hkv, int G, int D, int S,
                            const long long* strides, float scale,
                            void* stream) {
  if (G > MAX_G || G < 1 || D < 1 || D > 256) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, lens, out, B, Hkv, G, D, S, scale,
                                 strides, s);
  if (dtype == 1)
    return launch<float>(q, k, v, lens, out, B, Hkv, G, D, S, scale, strides,
                         s);
  return -1;
}
