// The band of the flash kernels' masks, shared by csrc/flash_fwd.cu and
// csrc/flash_bwd.cu: for one local q row, the local keys it attends, and for
// one local key, the local q rows that attend it.
//
// The band is on global positions, as the TPU kernels' `offs_ref` sets
// them: q row q sits at q_offset + q and key k at k_offset + k, so only
// shift = q_offset - k_offset enters.  Causal keeps q + shift - k >= 0, a
// window keeps q + shift - k < window.  The padding tests stay local: keys
// at or past Sk and rows at or past Sq are never live.  A thread forms the
// interval of each of its rows once per kernel; a masked element then
// costs two compares.
#pragma once

namespace flash_band {

// An inclusive interval [lo, hi] of positions (empty when lo > hi).
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool holds(int x) const {
    return x >= lo && x <= hi;
  }
};

// The local keys that local q row `q` attends.
__device__ __forceinline__ Span key_span(int q, int Sq, int Sk, int causal,
                                         int window, int shift) {
  Span s{0, q < Sq ? Sk - 1 : -1};
  if (causal) s.hi = min(s.hi, q + shift);
  if (window > 0) s.lo = q + shift - window + 1;
  return s;
}

// The local q rows that attend local key `k`.
__device__ __forceinline__ Span q_span(int k, int Sq, int Sk, int causal,
                                       int window, int shift) {
  Span s{0, k < Sk ? Sq - 1 : -1};
  if (causal) s.lo = k - shift;
  if (window > 0) s.hi = min(s.hi, k - shift + window - 1);
  return s;
}

}  // namespace flash_band
