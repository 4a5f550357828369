// Pieces the two one-token decode kernels share (csrc/flash_decode.cu over
// a dense cache, csrc/paged_decode.cu over a paged pool): raw 16-byte row
// loads widened to f32 where they are used, the merge of two softmax
// partials, and the kernel that combines the splits of a history by their
// log-sum-exp.
//
// Both kernels split a sequence's history into `nsplit` runs of `block_k`
// cached tokens (a paged split is `pages_per_split` whole pages), one CTA
// per (split, kv head, sequence).  A split writes its partial softmax
// against its own maximum, in the log2 domain, to an f32 workspace:
//   part_acc (B, H, nsplit, D): sum_t p_t v_t;
//   part_ml  (B, H, nsplit, 2): (m, l = sum_t p_t);
// a split that starts at or past the sequence's length writes nothing, and
// `decode_combine_kernel` reads only the live ones.
#pragma once

#include "hopper.cuh"

namespace decode {

constexpr int MAX_G = 8;
constexpr int THREADS = 256;   // a split's CTA
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Tokens a lane group takes a step: 4, or 2 where a lane holds 64 values
// of q (G 8 at 8 per lane, int8 rows at G 4, the scalar and two-vector
// f32 rows), whose registers would otherwise spill.
template <int GM, int NV, int W>
__host__ __device__ constexpr int unroll() {
  return GM * NV * W >= 64 ? 2 : 4;
}

// Shared memory (floats) of `merge_and_store`: [WARPS][GM][D] acc, then
// [WARPS][GM] m and l.
__host__ __device__ inline int merge_floats(int GM, int D) {
  return WARPS * GM * (D + 2);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four int8 values packed in a word, widened exactly to f32 without the
// quarter-rate I2F: byte j, biased to unsigned u = b + 128, is placed in
// the mantissa of 2^23 (0x4B0000uu = 2^23 + u), and 2^23 + 128 is taken
// off.  One PRMT and one FADD an element.
__device__ __forceinline__ void int8x4_to_f(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           8388736.f;
}

// W consecutive elements of a row (16 bytes' worth, 8 for int8 at a wide
// GQA group, or 1): loaded raw, so a load in flight holds 16 bytes of
// registers, and widened to f32 where they are used.
template <typename T, int W>
struct Vec;
template <typename T>
struct Vec<T, 1> {
  T r;
  __device__ __forceinline__ void load(const T* p) { r = p[0]; }
  __device__ __forceinline__ void zero() { r = T(0.f); }
  __device__ __forceinline__ void get(float (&x)[1]) const { x[0] = to_f(r); }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  }
};
template <>
struct Vec<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_float4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[4]) const {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};
template <>
struct Vec<int8_t, 16> {
  uint4 r;
  __device__ __forceinline__ void load(const int8_t* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[16]) const {
    int8x4_to_f(r.x, x);
    int8x4_to_f(r.y, x + 4);
    int8x4_to_f(r.z, x + 8);
    int8x4_to_f(r.w, x + 12);
  }
};
template <>
struct Vec<int8_t, 8> {
  uint2 r;
  __device__ __forceinline__ void load(const int8_t* p) {
    r = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint2(0, 0); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    int8x4_to_f(r.x, x);
    int8x4_to_f(r.y, x + 4);
  }
};

// Merge (mb, lb, accb) into (ma, la, acca): both softmax partials taken
// against their own maxima (log2 domain).  Two empty partials (m = -1e30)
// stay empty; an empty one adds exactly 0 to a live one.
__device__ __forceinline__ float merge_scale(float& ma, float mb,
                                             float& fb) {
  const float m = fmaxf(ma, mb);
  const float fa = hopper::ex2(ma - m);
  fb = hopper::ex2(mb - m);
  ma = m;
  return fa;
}

// Where a split's CTA puts its result: with one split, the output rows of
// (b, kv head h); else the split's (m, l, acc) of each query head in the
// workspace.
template <typename T>
struct Dest {
  T* out;
  float* part_acc;
  float* part_ml;
  long long o_sb, o_sh;
  int b, h, H, sp, nsplit;
};

// The end of a split's CTA: the lane groups' softmax partials (lane `lig`
// of a group of L holding elements (lig + i L) W .. + W - 1 of each head's
// acc) merge by their maxima, by shuffles inside a warp and through shared
// memory `red` across warps, and the CTA writes its result to `dst`.
template <typename T, int W, int NV, int GM>
__device__ __forceinline__ void merge_and_store(float (&m)[GM], float (&l)[GM],
                                                float (&acc)[GM][NV][W],
                                                float* red, int G, int D,
                                                int L, const Dest<T>& dst) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lig = tid % L;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    for (int off = L; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      float fb;
      const float fa = merge_scale(m[g], mo, fb);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i][e], off);
          acc[g][i][e] = acc[g][i][e] * fa + ao * fb;
        }
    }
  }
  float* red_m = red + WARPS * GM * D;
  float* red_l = red_m + WARPS * GM;
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int d = (lig + i * L) * W + e;
          if (d < D) red[(warp * GM + g) * D + d] = acc[g][i][e];
        }
      if (lane == 0) {
        red_m[warp * GM + g] = m[g];
        red_l[warp * GM + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[w * GM + g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = hopper::ex2(red_m[w * GM + g] - M);
      a += f * red[(w * GM + g) * D + d];
      ls += f * red_l[w * GM + g];
    }
    const int hq = dst.h * G + g;
    if (dst.nsplit == 1) {
      store(&dst.out[dst.b * dst.o_sb + (long long)hq * dst.o_sh + d],
            a / (ls == 0.f ? 1.f : ls));
    } else {
      const long long row =
          ((long long)dst.b * dst.H + hq) * dst.nsplit + dst.sp;
      dst.part_acc[row * D + d] = a;
      if (d == 0) {
        dst.part_ml[2 * row] = M;
        dst.part_ml[2 * row + 1] = ls;
      }
    }
  }
}

// out[b, hq] = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over the
// splits of sequence b that start before its length (clamped to S, the
// tokens the splits cover), in split order; no live split (a length of 0)
// gives 0.  One CTA per (b, hq), one thread per element of the row.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      const int* __restrict__ lengths,
                                      T* __restrict__ out, int H, int D,
                                      int S, int block_k, int nsplit,
                                      long long o_sb, long long o_sh) {
  const int bh = blockIdx.x, b = bh / H, hq = bh % H;
  const int len = min(max(lengths[b], 0), S);
  const int live = min(nsplit, (len + block_k - 1) / block_k);
  const float* ml = part_ml + (long long)bh * nsplit * 2;
  float M = NEG_INF;
  for (int i = 0; i < live; ++i) M = fmaxf(M, ml[2 * i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f, ls = 0.f;
    for (int i = 0; i < live; ++i) {
      const float f = hopper::ex2(ml[2 * i] - M);
      a += f * part_acc[((long long)bh * nsplit + i) * D + d];
      ls += f * ml[2 * i + 1];
    }
    store(&out[b * o_sb + (long long)hq * o_sh + d],
          a / (ls == 0.f ? 1.f : ls));
  }
}

// Launch the combine on `stream`: B x H CTAs.
template <typename T>
int launch_combine(const void* part_acc, const void* part_ml,
                   const void* lens, void* out, int B, int H, int D, int S,
                   int block_k, int nsplit, long long o_sb, long long o_sh,
                   cudaStream_t stream) {
  const int threads = min(256, (D + 31) / 32 * 32);
  decode_combine_kernel<T><<<B * H, threads, 0, stream>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<const int*>(lens),
      static_cast<T*>(out), H, D, S, block_k, nsplit, o_sb, o_sh);
  return (int)cudaGetLastError();
}

// The lanes a row of `nvec` vectors takes: a power of two, at most a warp.
inline int lanes_for(int nvec) {
  int L = 1;
  while (L < nvec && L < 32) L <<= 1;
  return L;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace decode
