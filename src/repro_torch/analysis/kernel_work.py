"""Each hand-written kernel's work, one definition for the whole port.

A kernel's work is the flops it must do and the bytes it must move for one
call: each input read once and each output written once, whatever the
kernel reads again, and, where the work depends on the data (a decode over
live tokens, a band of attended pairs), what this call's data needs.  The
same numbers serve two readers:

* the op cost counter (``analysis.op_cost``): a kernel entry reports its
  call's :class:`Work`, so a step counts the same on the card, on the CPU
  (the plain versions) and on the meta device;
* the card's bound of each kernel (``roofline.bound``: the larger of the
  bytes over the HBM rate and the flops over the peak of their type), which
  ``chip_smoke.py`` puts beside each kernel's time.

Every function takes shapes (ints), so a bound needs no tensor.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import roofline


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call's work: ``flops`` at the peak of ``dtype``'s
    products and ``bytes`` through HBM."""
    name: str
    flops: float
    bytes: float
    dtype: str = "bfloat16"

    @property
    def peak(self) -> float:
        return roofline.peak_ops(self.dtype)

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" | "operations") on one card."""
        return roofline.bound(self.bytes, self.flops, self.peak)


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


@functools.lru_cache(maxsize=4096)
def attended_pairs(Sq: int, Sk: int, causal: bool, window: int | None,
                   shift: int = 0) -> int:
    """(q, k) pairs one query head attends under the kernels' masks: q row
    i sits at position i + shift against keys 0 .. Sk - 1 (``shift`` =
    q_offset - k_offset), k <= q when causal, q - k < window."""
    q = np.arange(Sq, dtype=np.int64) + shift
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_fwd(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, *,
              itemsize: int, causal: bool, window: int | None,
              shift: int = 0, dtype: str = "bfloat16") -> Work:
    """The forward kernel: q, k, v read and o written in the inputs' dtype,
    the f32 lse written; QK^T and PV over the attended pairs (4 D flops a
    pair)."""
    pairs = B * H * attended_pairs(Sq, Sk, causal, window, shift)
    qn, kn = B * H * Sq * D, B * Hkv * Sk * D
    return Work("flash_fwd", 4 * D * pairs,
                itemsize * (2 * qn + 2 * kn) + 4 * B * H * Sq, dtype)


def _bwd_inputs(B, H, Hkv, Sq, Sk, D, itemsize) -> int:
    """q, k, v, do in the inputs' dtype and the f32 lse and delta."""
    qn, kn = B * H * Sq * D, B * Hkv * Sk * D
    return itemsize * (2 * qn + 2 * kn) + 8 * B * H * Sq


def flash_bwd_dq(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, *,
                 itemsize: int, causal: bool, window: int | None,
                 shift: int = 0, dtype: str = "bfloat16") -> Work:
    """The dq kernel: its inputs read once, f32 dq written; QK^T, dO V^T
    and dS K over the attended pairs (6 D flops a pair)."""
    pairs = B * H * attended_pairs(Sq, Sk, causal, window, shift)
    return Work("flash_bwd_dq", 6 * D * pairs,
                _bwd_inputs(B, H, Hkv, Sq, Sk, D, itemsize)
                + 4 * B * H * Sq * D, dtype)


def flash_bwd_dkv(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int, *,
                  itemsize: int, causal: bool, window: int | None,
                  shift: int = 0, dtype: str = "bfloat16") -> Work:
    """The dk/dv kernel: its inputs read once, f32 dk and dv written; QK^T,
    dO V^T, P^T dO and dS^T Q over the attended pairs (8 D flops a
    pair)."""
    pairs = B * H * attended_pairs(Sq, Sk, causal, window, shift)
    return Work("flash_bwd_dkv", 8 * D * pairs,
                _bwd_inputs(B, H, Hkv, Sq, Sk, D, itemsize)
                + 8 * B * Hkv * Sk * D, dtype)


def paged_decode(B: int, H: int, Hkv: int, D: int, *, live_tokens: int,
                 max_pages: int, kv_itemsize: int, q_itemsize: int,
                 quant: bool) -> Work:
    """Paged decode over ``live_tokens`` (the lengths' sum): each live
    token's K and V rows (and, in an int8 pool, their f32 scales) read
    once, q and the table read and out written once; 4 D H flops a token,
    at the int8 peak for an int8 pool."""
    bytes_ = (2 * live_tokens * Hkv * D * kv_itemsize
              + (2 * live_tokens * Hkv * 4 if quant else 0)
              + 2 * q_itemsize * B * H * D + 4 * (B * max_pages + B))
    return Work("paged_decode", 4 * D * H * live_tokens, bytes_,
                "int8" if quant else "bfloat16")


def flash_decode(B: int, H: int, Hkv: int, D: int, *, live_tokens: int,
                 itemsize: int, dtype: str = "bfloat16") -> Work:
    """Dense decode over ``live_tokens``: the live K/V rows, q and out once
    each and the int32 lengths; 4 D H flops a token."""
    return Work("flash_decode", 4 * H * D * live_tokens,
                itemsize * (2 * live_tokens * Hkv * D + 2 * B * H * D)
                + 4 * B, dtype)


def matmul(M: int, N: int, K: int, *, itemsize: int,
           dtype: str = "bfloat16") -> Work:
    """(M, K) @ (K, N): 2 M N K flops; a, b read and c written once."""
    return Work("matmul", 2 * M * N * K, itemsize * (M * K + K * N + M * N),
                dtype)


def conv2d(N: int, IH: int, IW: int, CI: int, KH: int, KW: int, CO: int,
           OH: int, OW: int, *, itemsize: int,
           dtype: str = "bfloat16") -> Work:
    """NHWC x HWIO VALID conv: 2 flops a MAC; x, w read and out written
    once."""
    macs = N * OH * OW * CO * CI * KH * KW
    return Work("conv2d", 2 * macs,
                itemsize * (N * IH * IW * CI + KH * KW * CI * CO
                            + N * OH * OW * CO), dtype)


def correlation(H: int, W: int, C: int, radius: int, *, itemsize: int,
                dtype: str = "bfloat16") -> Work:
    """FlowNet cost volume at displacement radius R (D = 2R + 1): 2 D^2 H W
    C flops; both feature maps read and the (H, W, D, D) volume written
    once."""
    D = 2 * radius + 1
    return Work("correlation", 2 * D * D * H * W * C,
                itemsize * (2 * H * W * C + H * W * D * D), dtype)


# ---------------------------------------------------------------------------
# the same work from a call's tensors (the kernel entries' reports)
# ---------------------------------------------------------------------------

def flash_fwd_of(q, k, *, causal, window, q_offset=0, k_offset=0) -> Work:
    """:func:`flash_fwd` of (B, H, Sq, D) q and (B, Hkv, Sk, D) k."""
    B, H, Sq, D = q.shape
    return flash_fwd(B, H, k.shape[1], Sq, k.shape[2], D,
                     itemsize=q.element_size(), causal=bool(causal),
                     window=window, shift=q_offset - k_offset,
                     dtype=_dt(q.dtype))


def flash_bwd_of(q, k, *, causal, window, q_offset=0,
                 k_offset=0) -> tuple[Work, Work]:
    """(dq, dk/dv) work of the backward pair on (B, H, Sq, D) q and (B, Hkv,
    Sk, D) k."""
    B, H, Sq, D = q.shape
    args = (B, H, k.shape[1], Sq, k.shape[2], D)
    kw = dict(itemsize=q.element_size(), causal=bool(causal), window=window,
              shift=q_offset - k_offset, dtype=_dt(q.dtype))
    return flash_bwd_dq(*args, **kw), flash_bwd_dkv(*args, **kw)
