"""Flash-attention forward: the pruned pair schedule, the plain PyTorch
version, and the launcher of the hand-written CUDA kernel
(``csrc/flash_fwd.cu``).

Counterpart of ``repro.kernels.attention`` (forward only; the backward
kernels come with the training slice).  The host-side schedule
(``_row_range`` / ``_pair_schedule`` / ``scheduled_block_counts``) is a copy
of the reference's, so the CUDA kernel's per-CTA k-block ranges are the
reference's pruned pair table, row by row.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

NEG_INF = -1e30  # avoid nan from (-inf) - (-inf)

# Block shape of the CUDA kernel: fixed for sm_90a (64 x 64 score tile at
# head_dim 64 or 128; see csrc/flash_fwd.cu).
BLOCK_Q = 64
BLOCK_K = 64


# ---------------------------------------------------------------------------
# Host-side pair-table schedules (the pruned grid)
# ---------------------------------------------------------------------------

def _row_range(iq: int, *, nk: int, block_q: int, block_k: int,
               causal: bool, window: int | None, kv_len: int,
               q_len: int) -> tuple[int, int]:
    """Inclusive [lo, hi] k-block range that q-block ``iq`` touches, or
    (0, -1) when the whole row is masked (padded q rows / empty bands)."""
    q_lo = iq * block_q
    q_hi = min(q_lo + block_q, q_len) - 1
    if q_hi < q_lo:                       # fully-padded q block
        return 0, -1
    lo, hi = 0, nk - 1
    hi = min(hi, (kv_len - 1) // block_k)    # never stream padded k blocks
    if causal:
        hi = min(hi, q_hi // block_k)
    if window is not None:
        # need some kpos with q_lo - kpos < window, i.e. k_hi > q_lo - window
        lo = max(lo, -(-(q_lo - window + 2 - block_k) // block_k))
    return lo, hi


@functools.lru_cache(maxsize=None)
def _pair_schedule(nq: int, nk: int, block_q: int, block_k: int,
                   causal: bool, window: int | None, kv_len: int,
                   q_len: int, order: str) -> tuple[np.ndarray, int]:
    """Static (n_pairs, 4) int32 schedule of surviving (q-block, k-block)
    grid steps: columns are (iq, ik, first, last).

    ``order='row'`` (forward / dq): pairs grouped by q block, so the
    online-softmax state drains exactly once per row.  ``order='col'``
    (dk/dv): grouped by k block.  first/last flag the group boundaries
    (accumulator init / drain).  Rows (and, in 'col' order, columns) with
    an empty band still get one fully-masked sentinel pair so every
    output block is initialized and drained — the mask guard inside the
    kernels zeroes its contribution.

    Returns (table, n_scheduled) where n_scheduled counts the REAL pairs
    (sentinels excluded)."""
    rows: list[list[int]] = []
    n_real = 0
    for iq in range(nq):
        lo, hi = _row_range(iq, nk=nk, block_q=block_q, block_k=block_k,
                            causal=causal, window=window, kv_len=kv_len,
                            q_len=q_len)
        if hi < lo:
            rows.append([iq, 0, -1, -1])  # sentinel: fully masked
        else:
            n_real += hi - lo + 1
            for ik in range(lo, hi + 1):
                rows.append([iq, ik, 0, 0])
    if order == "col":
        by_col: dict[int, list[int]] = {ik: [] for ik in range(nk)}
        for iq, ik, s, _ in rows:
            if s != -1:
                by_col[ik].append(iq)
        rows = []
        for ik in range(nk):
            iqs = by_col[ik] or [nq - 1]   # sentinel for untouched columns
            for j, iq in enumerate(iqs):
                rows.append([iq, ik, int(j == 0), int(j == len(iqs) - 1)])
    else:
        assert order == "row", order
        out = []
        by_row: dict[int, list[list[int]]] = {}
        for r in rows:
            by_row.setdefault(r[0], []).append(r)
        for iq in range(nq):
            group = by_row[iq]
            for j, r in enumerate(group):
                out.append([r[0], max(r[1], 0), int(j == 0),
                            int(j == len(group) - 1)])
        rows = out
    table = np.asarray(rows, dtype=np.int32)
    return table, n_real


def scheduled_block_counts(Sq: int, Sk: int, *, block_q: int, block_k: int,
                           causal: bool, window: int | None
                           ) -> tuple[int, int]:
    """(scheduled, dense) k-block counts for one head's grid (dense =
    nq * nk)."""
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    _, real = _pair_schedule(nq, nk, block_q, block_k, bool(causal),
                             window, Sk, Sq, "row")
    return real, nq * nk


def row_block_ranges(Sq: int, Sk: int, *, block_q: int, block_k: int,
                     causal: bool, window: int | None) -> np.ndarray:
    """(nq, 2) int32 inclusive [lo, hi] k-block range of each q block: the
    span of that q block's pairs in the row-ordered ``_pair_schedule``
    table, both being ``_row_range``.  A fully masked row gets the empty
    range (0, -1), which the kernel skips where the table holds one
    masked sentinel pair."""
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    ranges = np.zeros((nq, 2), np.int32)
    for iq in range(nq):
        lo, hi = _row_range(iq, nk=nk, block_q=block_q, block_k=block_k,
                            causal=bool(causal), window=window, kv_len=Sk,
                            q_len=Sq)
        ranges[iq] = (lo, hi) if hi >= lo else (0, -1)
    return ranges


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the kernel's check on the card)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None,
                              block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                              scale: float | None = None,
                              kv_len: int | None = None,
                              q_len: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, D); k, v: (BHkv, Sk, D), head h of q using kv head
    h // (BH // BHkv).  Returns ``(o, lse)`` with ``lse`` f32 (BH, Sq).

    Walks the same row-ordered pair table as the kernel, one (q block,
    k block) step at a time over all heads at once, with the kernel's
    arithmetic: f32 scores, the mask guard before exp, p rounded to v's
    dtype before PV, l == 0 drained as 1.  ``kv_len`` / ``q_len`` bound the
    valid region when Sk / Sq carry padding."""
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    if BH % BHkv:
        raise ValueError(f"q heads {BH} not a multiple of kv heads {BHkv}")
    group = BH // BHkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    kv_len = Sk if kv_len is None else kv_len
    q_len = Sq if q_len is None else q_len
    nq, nk = -(-Sq // block_q), -(-Sk // block_k)
    sched, _ = _pair_schedule(nq, nk, block_q, block_k, bool(causal),
                              window, kv_len, q_len, "row")
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    dev = q.device
    o = torch.zeros((BH, Sq, Dh), dtype=q.dtype, device=dev)
    lse = torch.zeros((BH, Sq), dtype=torch.float32, device=dev)
    m = l = acc = None
    for iq, ik, first, last in sched.tolist():
        if first:
            m = torch.full((BH, block_q), NEG_INF, device=dev)
            l = torch.zeros((BH, block_q), device=dev)
            acc = torch.zeros((BH, block_q, Dh), device=dev)
        q0, k0 = iq * block_q, ik * block_k
        qb = q[:, q0:q0 + block_q].float()
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k]
        nqr, nkr = qb.shape[1], kb.shape[1]
        if nqr < block_q or nkr < block_k:        # ragged edge: zero rows
            qb = torch.nn.functional.pad(qb, (0, 0, 0, block_q - nqr))
            kb = torch.nn.functional.pad(kb, (0, 0, 0, block_k - nkr))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, block_k - nkr))
        s = torch.einsum("hqd,hkd->hqk", qb, kb) * scale
        loc_k = k0 + torch.arange(block_k, device=dev)[None, :]
        qpos = q0 + torch.arange(block_q, device=dev)[:, None]
        mask = (loc_k < kv_len).expand(block_q, block_k)
        if causal:
            mask = mask & (qpos >= loc_k)
        if window is not None:
            mask = mask & ((qpos - loc_k) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "hqk,hkd->hqd", p.to(v.dtype).float(), vb.float())
        m = m_new
        if last:
            safe = torch.where(l == 0.0, 1.0, l)
            o[:, q0:q0 + nqr] = (acc / safe[..., None])[:, :nqr].to(q.dtype)
            lse[:, q0:q0 + nqr] = (m + torch.log(safe))[:, :nqr]
    return o, lse


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu``.  q: (B, H, Sq, D), k/v: (B, Hkv, Sk,
    D) — any strides with a contiguous last dimension, e.g. the
    ``transpose(1, 2)`` views of the engine's (B, S, H, D) tensors, which
    are read in place.  Returns ``(o, lse)``: o has q's shape and memory
    layout, lse is f32 (B * H, Sq)."""
    B, H, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd_cuda: q, k, v must lie on "
                         "one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd_cuda takes bf16 or f32 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or H % Hkv or \
            D not in (64, 128):
        raise ValueError(f"flash_attention_fwd_cuda: unsupported shapes "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (head_dim 64 or 128)")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_fwd_cuda: the head dim must be "
                         "contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward on CUDA comes with the training "
            "slice of the port; call under torch.no_grad()")
    _build.check_device(q)
    ranges = _ranges_on(q.device, Sq, Sk, bool(causal), window)
    o = torch.empty_like(q)          # keeps q's (B, S, H, D) memory layout
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_fwd", "flash_fwd", *[ctypes.c_void_p] * 6,
                     *[ctypes.c_int] * 10, *[ctypes.c_longlong] * 12,
                     ctypes.c_float)
    nq = ranges.shape[0]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), ranges.data_ptr(), _DTYPE_CODE[q.dtype], B, H,
             H // Hkv, Sq, Sk, D, nq, int(bool(causal)),
             0 if window is None else int(window),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             o.stride(0), o.stride(1), o.stride(2),
             1.0 / math.sqrt(D), _build.stream_ptr(q))
    _build.check(err, "flash_fwd")
    return o, lse


_RANGES: dict[tuple, torch.Tensor] = {}


def _ranges_on(dev: torch.device, Sq: int, Sk: int, causal: bool,
               window: int | None) -> torch.Tensor:
    """The kernel's per-CTA k-block ranges, on the device, built once per
    shape."""
    key = (dev, Sq, Sk, causal, window)
    t = _RANGES.get(key)
    if t is None:
        r = row_block_ranges(Sq, Sk, block_q=BLOCK_Q, block_k=BLOCK_K,
                             causal=causal, window=window)
        t = torch.from_numpy(r).to(dev)
        _RANGES[key] = t
    return t
