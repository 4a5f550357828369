"""Flash attention, forward and backward, and dense flash decode: the
pruned pair schedule, the plain PyTorch versions, the launchers of the
hand-written CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/flash_decode.cu``) and the trainable :class:`FlashAttention` that
binds the first two.

Counterpart of ``repro.kernels.attention`` (flash forward, the dq and dk/dv
backward kernels, ``flash_attention_train`` and the dense decode kernel).
The host-side schedule (``_row_range`` /
``_pair_schedule`` / ``scheduled_block_counts``) is a copy of the
reference's, so the CUDA kernels' per-CTA block ranges are the reference's
pruned pair table at each kernel's block shape, row by row (forward, dq)
and column by column (dk/dv).

The forward has three routes (:func:`flash_fwd_route`): ``"flash_fwd"``,
the tensor-core (``wgmma``) kernel with 128 x 128 blocks, for bf16 at
head_dim 64 or 128 with strides TMA can read; ``"flash_fwd_d256"``, the
wgmma kernel for bf16 at head_dim 256 with such strides, with 128 x 64
blocks; and ``"flash_fwd_simt"``, the CUDA-core kernel with 64 x 64
blocks, for f32 and anything else.  The backward takes head_dim 64, 128
or 256 and has three routes of its own (:func:`flash_bwd_route`), decided
on q, k, v and do: ``"flash_bwd"``, the wgmma dq kernel (128 q rows x
64-key blocks) and dk/dv kernel (64-row q blocks x 128 keys) at head_dim
64 or 128, which round p and ds to bf16 before their second products;
``"flash_bwd_d256"``, the wgmma pair at head_dim 256 with the same
rounding (dq at 128 q rows x 32-key blocks, dk/dv at 64-row q blocks x 64
keys, each GQA group's heads split into the parts of
:func:`flash_bwd_dkv_plan` whose partials a second kernel adds in order);
and ``"flash_bwd_simt"``, the CUDA-core pair at 64 x 64 in f32 (head_dim
256 in either dtype: its streamed operand in two passes of 128 columns).
Each backward route reads only o and the per-row lse, whose layouts do not
depend on the forward's route.  :func:`flash_bwd_term_max` reads, from
the plain version's own rounded p and ds, the largest term of each
output element's sum, which the rounded routes' checks bound a flip by.

Every kernel, plain version and schedule takes ``q_offset`` / ``k_offset``,
the global positions of q row 0 and key 0, as the reference's kernels do
for the ring's per-hop fold: the causal and window masks compare
``q_offset + q`` with ``k_offset + k``, while the padding tests stay local
(keys past ``kv_len``, q blocks past ``q_len``).  The pruned schedule is
the band shifted by ``q_offset - k_offset``; ``prune=False`` walks the
dense grid, whose extra blocks the masks zero.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.cuda_bridge import SM_COUNT, pow2_floor
from . import _build

NEG_INF = -1e30  # avoid nan from (-inf) - (-inf)

# Block shape of the CUDA-core forward and backward kernels (64 x 64 score
# tile at head_dim 64, 128 and 256; see csrc/flash_fwd.cu, flash_bwd.cu).
BLOCK_Q = 64
BLOCK_K = 64
# Block shape of the wgmma forward: 128 q rows (two warpgroups of 64) by
# 128 keys, which keeps a 2-stage K/V ring in shared memory at head_dim 128.
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 128
# Block shape of the wgmma forward at head_dim 256: 128 q rows by 64 keys,
# which keeps Q resident and a 2-stage K/V ring in 192 KB of shared memory.
WGMMA_D256_BLOCKS = (128, 64)
# Block shapes of the wgmma backward (csrc/flash_bwd.cu): dq holds 128 q
# rows (two warpgroups of 64) against 64-key K / V blocks; dk/dv holds 128
# keys (two warpgroups of 64) against 64-row Q / dO steps, which keeps
# dK, dV, S^T and dP^T of a warpgroup in its registers at head_dim 128.
WGMMA_BWD_DQ_BLOCKS = (128, 64)
WGMMA_BWD_DKV_BLOCKS = (64, 128)
# ... and at head_dim 256 (route "flash_bwd_d256"): dq streams 32-key K / V
# blocks past resident 128-row Q and dO (a 64-key ring would not fit in
# shared memory); dk/dv holds 64 keys against 64-row Q / dO steps, its two
# warpgroups splitting dK and dV (64 x 256 f32 each).
WGMMA_D256_BWD_DQ_BLOCKS = (128, 32)
WGMMA_D256_BWD_DKV_BLOCKS = (64, 64)


# ---------------------------------------------------------------------------
# Host-side pair-table schedules (the pruned grid)
# ---------------------------------------------------------------------------

def _row_range(iq: int, *, nk: int, block_q: int, block_k: int,
               causal: bool, window: int | None, kv_len: int,
               q_len: int, q_offset: int = 0,
               k_offset: int = 0) -> tuple[int, int]:
    """Inclusive [lo, hi] k-block range that q-block ``iq`` touches, or
    (0, -1) when the whole row is masked (padded q rows / empty bands).
    The band compares global positions: local q + ``q_offset - k_offset``
    against local k."""
    q_lo = iq * block_q
    q_hi = min(q_lo + block_q, q_len) - 1
    if q_hi < q_lo:                       # fully-padded q block
        return 0, -1
    shift = q_offset - k_offset
    lo, hi = 0, nk - 1
    hi = min(hi, (kv_len - 1) // block_k)    # never stream padded k blocks
    if causal:
        hi = min(hi, (q_hi + shift) // block_k)
    if window is not None:
        # need some kpos with q_lo + shift - kpos < window, i.e.
        # k_hi > q_lo + shift - window
        lo = max(lo, -(-(q_lo + shift - window + 2 - block_k) // block_k))
    return lo, hi


@functools.lru_cache(maxsize=None)
def _pair_schedule(nq: int, nk: int, block_q: int, block_k: int,
                   causal: bool, window: int | None, kv_len: int,
                   q_len: int, order: str, q_offset: int = 0,
                   k_offset: int = 0) -> tuple[np.ndarray, int]:
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
    (sentinels excluded).  The offsets shift the band (``_row_range``)."""
    rows: list[list[int]] = []
    n_real = 0
    for iq in range(nq):
        lo, hi = _row_range(iq, nk=nk, block_q=block_q, block_k=block_k,
                            causal=causal, window=window, kv_len=kv_len,
                            q_len=q_len, q_offset=q_offset,
                            k_offset=k_offset)
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
                           causal: bool, window: int | None,
                           q_offset: int = 0) -> tuple[int, int]:
    """(scheduled, dense) k-block counts for one head's grid (dense =
    nq * nk)."""
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    _, real = _pair_schedule(nq, nk, block_q, block_k, bool(causal),
                             window, Sk, Sq, "row", q_offset)
    return real, nq * nk


def row_block_ranges(Sq: int, Sk: int, *, block_q: int, block_k: int,
                     causal: bool, window: int | None, q_offset: int = 0,
                     k_offset: int = 0) -> np.ndarray:
    """(nq, 2) int32 inclusive [lo, hi] k-block range of each q block: the
    span of that q block's pairs in the row-ordered ``_pair_schedule``
    table, both being ``_row_range`` (at the offsets).  A fully masked row
    gets the empty range (0, -1), which the kernel skips where the table
    holds one masked sentinel pair."""
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    ranges = np.zeros((nq, 2), np.int32)
    for iq in range(nq):
        lo, hi = _row_range(iq, nk=nk, block_q=block_q, block_k=block_k,
                            causal=bool(causal), window=window, kv_len=Sk,
                            q_len=Sq, q_offset=q_offset, k_offset=k_offset)
        ranges[iq] = (lo, hi) if hi >= lo else (0, -1)
    return ranges


def col_block_ranges(Sq: int, Sk: int, *, block_q: int, block_k: int,
                     causal: bool, window: int | None, q_offset: int = 0,
                     k_offset: int = 0) -> np.ndarray:
    """(nk, 2) int32 inclusive [lo, hi] q-block range of each k block: the
    span of that column's real pairs in the column-ordered
    ``_pair_schedule`` table.  A column no q block touches gets the empty
    range (0, -1), which the dk/dv kernel drains as zeros where the table
    holds one masked sentinel pair."""
    rows = row_block_ranges(Sq, Sk, block_q=block_q, block_k=block_k,
                            causal=causal, window=window, q_offset=q_offset,
                            k_offset=k_offset)
    nk = -(-Sk // block_k)
    ranges = np.tile(np.asarray([[0, -1]], np.int32), (nk, 1))
    for ik in range(nk):
        iqs = np.flatnonzero((rows[:, 0] <= ik) & (ik <= rows[:, 1]))
        if len(iqs):
            # the band is convex: a column's q blocks are consecutive
            assert iqs[-1] - iqs[0] + 1 == len(iqs), (ik, iqs)
            ranges[ik] = (iqs[0], iqs[-1])
    return ranges


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' check on the card)
# ---------------------------------------------------------------------------

def _block_mask(q0: int, k0: int, block_q: int, block_k: int, causal: bool,
                window: int | None, kv_len: int, dev, q_offset: int = 0,
                k_offset: int = 0) -> torch.Tensor:
    """(block_q, block_k) mask of one (q block, k block) pair, as the
    kernels build it: keys past ``kv_len`` (local) never attend; the band
    compares the global positions ``q_offset + q`` and ``k_offset + k``."""
    loc_k = k0 + torch.arange(block_k, device=dev)[None, :]
    qpos = q_offset + q0 + torch.arange(block_q, device=dev)[:, None]
    kpos = k_offset + loc_k
    mask = (loc_k < kv_len).expand(block_q, block_k)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return mask


def _schedule(nq: int, nk: int, block_q: int, block_k: int, causal: bool,
              window: int | None, kv_len: int, q_len: int, order: str,
              prune: bool, q_offset: int, k_offset: int) -> list:
    """The plain versions' pair table: the band pruned at the offsets, or
    (``prune=False``) the reference's dense grid (every k block below
    ``kv_len`` of every q block below ``q_len``)."""
    if prune:
        sched, _ = _pair_schedule(nq, nk, block_q, block_k, bool(causal),
                                  window, kv_len, q_len, order, q_offset,
                                  k_offset)
    else:
        sched, _ = _pair_schedule(nq, nk, block_q, block_k, False, None,
                                  kv_len, q_len, order)
    return sched.tolist()


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x along dim 1 in f32, zero-padded to n rows at
    the ragged edge."""
    b = x[:, r0:r0 + n].float()
    if b.shape[1] < n:
        b = torch.nn.functional.pad(
            b, (0, 0) * (b.dim() - 2) + (0, n - b.shape[1]))
    return b


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None,
                              block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                              scale: float | None = None,
                              kv_len: int | None = None,
                              q_len: int | None = None,
                              q_offset: int = 0, k_offset: int = 0,
                              prune: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, D); k, v: (BHkv, Sk, D), head h of q using kv head
    h // (BH // BHkv).  Returns ``(o, lse)`` with ``lse`` f32 (BH, Sq).

    Walks the same row-ordered pair table as the kernel, one (q block,
    k block) step at a time over all heads at once, with the kernel's
    arithmetic: f32 scores, the mask guard before exp, p rounded to v's
    dtype before PV, l == 0 drained as 1.  ``kv_len`` / ``q_len`` bound the
    valid region when Sk / Sq carry padding; ``q_offset`` / ``k_offset``
    shift the band (module docstring); ``prune=False`` walks the dense
    grid."""
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    if BH % BHkv:
        raise ValueError(f"q heads {BH} not a multiple of kv heads {BHkv}")
    group = BH // BHkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    kv_len = Sk if kv_len is None else kv_len
    q_len = Sq if q_len is None else q_len
    nq, nk = -(-Sq // block_q), -(-Sk // block_k)
    sched = _schedule(nq, nk, block_q, block_k, causal, window, kv_len,
                      q_len, "row", prune, q_offset, k_offset)
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    dev = q.device
    o = torch.zeros((BH, Sq, Dh), dtype=q.dtype, device=dev)
    lse = torch.zeros((BH, Sq), dtype=torch.float32, device=dev)
    m = l = acc = None
    for iq, ik, first, last in sched:
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
        mask = _block_mask(q0, k0, block_q, block_k, causal, window, kv_len,
                           dev, q_offset, k_offset)
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


class _BwdPairs:
    """The backward's per-pair arithmetic over all heads at once, shared by
    the plain dq and dk/dv walks: f32 scores, ``p = exp(s - lse)`` under
    the mask guard (a fully masked row has lse == NEG_INF and would
    otherwise come back as exp(0)), ``ds = p * (dp - delta) * scale``.
    ``rounded`` rounds p and ds to bf16 after ds is formed from the f32 p,
    as the wgmma route feeds them to its second products (dv += p^T . do,
    dq += ds . k, dk += ds^T . q).  The offsets shift the band, ``prune``
    picks the pruned or the dense pair table, as in the forward."""

    def __init__(self, q, k, v, do, lse, delta, causal, window, block_q,
                 block_k, scale, kv_len, q_len, rounded=False, q_offset=0,
                 k_offset=0, prune=True):
        BH, Sq, Dh = q.shape
        BHkv, Sk, _ = k.shape
        if BH % BHkv:
            raise ValueError(f"q heads {BH} not a multiple of kv heads "
                             f"{BHkv}")
        self.q, self.k, self.v, self.do = q, k, v, do
        self.lse, self.delta = lse, delta
        self.group = BH // BHkv
        self.causal, self.window = bool(causal), window
        self.block_q, self.block_k = block_q, block_k
        self.scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
        self.kv_len = Sk if kv_len is None else kv_len
        self.q_len = Sq if q_len is None else q_len
        self.nq, self.nk = -(-Sq // block_q), -(-Sk // block_k)
        self.rounded = rounded
        self.q_offset, self.k_offset = q_offset, k_offset
        self.prune = prune

    def schedule(self, order: str) -> list:
        return _schedule(self.nq, self.nk, self.block_q, self.block_k,
                         self.causal, self.window, self.kv_len, self.q_len,
                         order, self.prune, self.q_offset, self.k_offset)

    def pair(self, iq: int, ik: int):
        bq, bk, g = self.block_q, self.block_k, self.group
        q0, k0 = iq * bq, ik * bk
        qb, dob = _rows(self.q, q0, bq), _rows(self.do, q0, bq)
        kb = _rows(self.k, k0, bk).repeat_interleave(g, dim=0)
        vb = _rows(self.v, k0, bk).repeat_interleave(g, dim=0)
        mask = _block_mask(q0, k0, bq, bk, self.causal, self.window,
                           self.kv_len, self.q.device, self.q_offset,
                           self.k_offset)
        s = torch.einsum("hqd,hkd->hqk", qb, kb) * self.scale
        lse = _rows(self.lse, q0, bq)[..., None]
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dp = torch.einsum("hqd,hkd->hqk", dob, vb)
        ds = p * (dp - _rows(self.delta, q0, bq)[..., None]) * self.scale
        if self.rounded:
            p = p.to(torch.bfloat16).float()
            ds = ds.to(torch.bfloat16).float()
        return qb, dob, kb, p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True, window=None,
                       block_q=BLOCK_Q, block_k=BLOCK_K, scale=None,
                       kv_len=None, q_len=None, rounded=False, q_offset=0,
                       k_offset=0, prune=True) -> torch.Tensor:
    """dq (f32, q's shape) of :func:`flash_attention_bwd_plain`: the
    row-ordered pair table, ``dq += ds . k`` per step."""
    w = _BwdPairs(q, k, v, do, lse, delta, causal, window, block_q, block_k,
                  scale, kv_len, q_len, rounded, q_offset, k_offset, prune)
    BH, Sq, Dh = q.shape
    dq = torch.zeros((BH, Sq, Dh), dtype=torch.float32, device=q.device)
    acc = None
    for iq, ik, first, last in w.schedule("row"):
        if first:
            acc = torch.zeros((BH, block_q, Dh), device=q.device)
        _, _, kb, _, ds = w.pair(iq, ik)
        acc += torch.einsum("hqk,hkd->hqd", ds, kb)
        if last:
            q0 = iq * block_q
            dq[:, q0:q0 + block_q] = acc[:, :Sq - q0]
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True,
                        window=None, block_q=BLOCK_Q, block_k=BLOCK_K,
                        scale=None, kv_len=None, q_len=None, rounded=False,
                        q_offset=0, k_offset=0, prune=True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (f32, k's shape) of :func:`flash_attention_bwd_plain`: the
    column-ordered pair table, ``dv += p^T . do`` and ``dk += ds^T . q``
    per step, a GQA group's heads and q rows folded in one sum."""
    w = _BwdPairs(q, k, v, do, lse, delta, causal, window, block_q, block_k,
                  scale, kv_len, q_len, rounded, q_offset, k_offset, prune)
    BHkv, Sk, Dh = k.shape
    g = w.group

    def fold(a, b):
        return torch.einsum("hgqk,hgqd->hkd",
                            a.reshape(BHkv, g, *a.shape[1:]),
                            b.reshape(BHkv, g, *b.shape[1:]))

    dk = torch.zeros((BHkv, Sk, Dh), dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dk_acc = dv_acc = None
    for iq, ik, first, last in w.schedule("col"):
        if first:
            dk_acc = torch.zeros((BHkv, block_k, Dh), device=k.device)
            dv_acc = torch.zeros_like(dk_acc)
        qb, dob, _, p, ds = w.pair(iq, ik)
        dv_acc += fold(p, dob)
        dk_acc += fold(ds, qb)
        if last:
            k0 = ik * block_k
            dk[:, k0:k0 + block_k] = dk_acc[:, :Sk - k0]
            dv[:, k0:k0 + block_k] = dv_acc[:, :Sk - k0]
    return dk, dv


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                              scale: float | None = None,
                              kv_len: int | None = None,
                              q_len: int | None = None,
                              dkv_blocks: tuple[int, int] | None = None,
                              rounded: bool = False, q_offset: int = 0,
                              k_offset: int = 0, prune: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Flash backward from the saved residuals.  q/do: (BH, Sq, D); k/v:
    (BHkv, Sk, D); lse/delta: f32 (BH, Sq) with ``delta = rowsum(o * do)``.
    Returns (dq, dk, dv) in f32.

    Walks the row-ordered pair table at (block_q, block_k) for dq and the
    column-ordered one at ``dkv_blocks`` (default the same) for dk/dv, one
    step at a time over all heads at once, with the kernels' arithmetic
    (:class:`_BwdPairs`; ``rounded``: p and ds in bf16 before their second
    products, as the wgmma route).  :func:`flash_bwd_plain_kw` gives a
    route's blocks and rounding; the offsets and ``prune`` as in the
    forward.  Sentinel pairs are computed like any other, so where they
    are fully masked they drain 0, as in the reference."""
    kw = dict(causal=causal, window=window, scale=scale, kv_len=kv_len,
              q_len=q_len, rounded=rounded, q_offset=q_offset,
              k_offset=k_offset, prune=prune)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, block_q=block_q,
                            block_k=block_k, **kw)
    bq, bk = dkv_blocks or (block_q, block_k)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, block_q=bq,
                                     block_k=bk, **kw))


def _max_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max over k of |a[h, m, k]| |b[h, k, n]|: (H, M, N) from (H, M, K)
    and (H, K, N), 64 columns of b at a time."""
    a, b = a.abs(), b.abs()
    return torch.cat([(a[..., None] * b[:, None, :, c:c + 64]).amax(2)
                      for c in range(0, b.shape[-1], 64)], -1)


def flash_bwd_term_max(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = True,
                       window: int | None = None, block_q: int = BLOCK_Q,
                       block_k: int = BLOCK_K, scale: float | None = None,
                       kv_len: int | None = None, q_len: int | None = None,
                       dkv_blocks: tuple[int, int] | None = None,
                       rounded: bool = False, q_offset: int = 0,
                       k_offset: int = 0, prune: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T of every output element of :func:`flash_attention_bwd_plain` (same
    arguments): the largest magnitude of one term of its sum, exactly, from
    the plain version's own p and ds (rounded where ``rounded``), walked
    block by block as the plain version walks them.  dq[i, d]: max over j
    of |ds_ij| |k_jd|; dk[j, d]: max over the group's heads and rows i of
    |ds_ij| |q_id|; dv[j, d]: the same of |p_ij| |do_id|.  Returns f32
    (tdq, tdk, tdv) of the gradients' shapes."""
    kw = dict(causal=causal, window=window, scale=scale, kv_len=kv_len,
              q_len=q_len, rounded=rounded, q_offset=q_offset,
              k_offset=k_offset, prune=prune)
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    w = _BwdPairs(q, k, v, do, lse, delta, block_q=block_q, block_k=block_k,
                  **kw)
    tdq = torch.zeros((BH, Sq, Dh), dtype=torch.float32, device=q.device)
    for iq, ik, _, _ in w.schedule("row"):
        _, _, kb, _, ds = w.pair(iq, ik)
        rows = tdq[:, iq * block_q:(iq + 1) * block_q]
        torch.maximum(rows, _max_products(ds, kb)[:, :rows.shape[1]],
                      out=rows)
    bq, bk = dkv_blocks or (block_q, block_k)
    w = _BwdPairs(q, k, v, do, lse, delta, block_q=bq, block_k=bk, **kw)
    tdk = torch.zeros((BHkv, Sk, Dh), dtype=torch.float32, device=k.device)
    tdv = torch.zeros_like(tdk)
    for iq, ik, _, _ in w.schedule("col"):
        qb, dob, _, p, ds = w.pair(iq, ik)
        for t, a, b in ((tdk, ds, qb), (tdv, p, dob)):
            rows = t[:, ik * bk:(ik + 1) * bk]
            m = _max_products(a.transpose(1, 2), b)
            m = m.reshape(BHkv, w.group, bk, Dh).amax(1)
            torch.maximum(rows, m[:, :rows.shape[1]], out=rows)
    return tdq, tdk, tdv


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _tma_strides(t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides of a (B, H, S, D) tensor as its TMA
    descriptor takes them: a dim of size 1 is never stepped, so its stride
    is given as the tensor's whole extent rounded to 8 elements."""
    span = max(st * n for st, n in zip(t.stride(), t.shape))
    return [st if n > 1 else -(-span // 8) * 8
            for st, n in zip(t.stride()[:3], t.shape[:3])]


def _tma_readable(t: torch.Tensor) -> bool:
    """bf16 with a contiguous head dim, a 16-byte aligned base and
    (batch, head, seq) strides that are positive multiples of 8 elements:
    what the wgmma kernels' TMA descriptors can read."""
    return (t.dtype == torch.bfloat16 and t.stride(-1) == 1 and
            t.data_ptr() % 16 == 0 and
            all(st > 0 and st % 8 == 0 for st in _tma_strides(t)))


def flash_fwd_route(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> str:
    """The forward kernel's route (module docstring), a pure function of
    the inputs' dtype, head_dim and strides on any device: for bf16 q/k/v
    that TMA can read (:func:`_tma_readable`), ``"flash_fwd"`` (wgmma) at
    head_dim 64 or 128 and ``"flash_fwd_d256"`` (wgmma) at head_dim 256;
    ``"flash_fwd_simt"`` otherwise."""
    if all(_tma_readable(t) for t in (q, k, v)):
        if q.shape[-1] in (64, 128):
            return "flash_fwd"
        if q.shape[-1] == 256:
            return "flash_fwd_d256"
    return "flash_fwd_simt"


def flash_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor) -> str:
    """The backward kernels' route (module docstring), a pure function of
    dtype, head_dim and strides on any device.  For bf16 q, k, v and do
    that TMA can read: ``"flash_bwd"`` (the wgmma pair, launch keys
    ``flash_bwd_dq`` and ``flash_bwd_dkv``) at head_dim 64 or 128,
    ``"flash_bwd_d256"`` (keys ``flash_bwd_dq_d256``,
    ``flash_bwd_dkv_d256``) at head_dim 256; ``"flash_bwd_simt"`` (keys
    ``flash_bwd_dq_simt``, ``flash_bwd_dkv_simt``) otherwise."""
    if all(_tma_readable(t) for t in (q, k, v, do)):
        if q.shape[-1] in (64, 128):
            return "flash_bwd"
        if q.shape[-1] == 256:
            return "flash_bwd_d256"
    return "flash_bwd_simt"


def flash_bwd_plain_kw(route: str) -> dict:
    """The blocks and rounding of a backward route's kernels, as
    :func:`flash_attention_bwd_plain` takes them: the plain version at
    these is the same function as the route's kernels."""
    if route in ("flash_bwd", "flash_bwd_d256"):
        d256 = route == "flash_bwd_d256"
        bq, bk = WGMMA_D256_BWD_DQ_BLOCKS if d256 else WGMMA_BWD_DQ_BLOCKS
        return dict(block_q=bq, block_k=bk,
                    dkv_blocks=(WGMMA_D256_BWD_DKV_BLOCKS if d256
                                else WGMMA_BWD_DKV_BLOCKS),
                    rounded=True)
    return dict(block_q=BLOCK_Q, block_k=BLOCK_K,
                dkv_blocks=(BLOCK_Q, BLOCK_K), rounded=False)


class DkvPlan(NamedTuple):
    """A launch of the head_dim-256 dk/dv kernel (:func:`flash_bwd_dkv_plan`):
    the parts each GQA group's heads split into, its (part, kv head,
    64-key block) CTAs, and the shape of the f32 partials a second kernel
    adds in the parts' order (none at one part, which writes dk / dv
    itself)."""

    parts: int
    ctas: int
    scratch: tuple[int, ...] | None

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch) if self.scratch else 0


def flash_bwd_dkv_plan(B: int, Hkv: int, G: int, Sk: int,
                       parts: int | None = None) -> DkvPlan:
    """The head_dim-256 dk/dv kernel's split of each GQA group's G heads,
    from shapes alone (Python ints: nothing syncs the host).  ``parts``
    None: the fewest, a divisor of G, whose CTAs number at least twice
    ``SM_COUNT`` (one CTA fits an SM: a second wave evens out key blocks of
    unequal work, a window's last keys seeing fewer q rows); G when none
    does.  Otherwise ``parts`` itself, which must divide G.
    recurrentgemma-9b (B 1, one kv head, Sk 4096: 64 key blocks) gets 8
    parts, 512 CTAs: on one H100 its dk/dv took 1.50, 0.79, 0.73, 0.60 and
    0.65 ms at 1, 2, 4, 8 and 16 parts
    (``scripts/sweep_flash_bwd_d256_torch.py``, PERF.md)."""
    blocks = B * Hkv * -(-Sk // WGMMA_D256_BWD_DKV_BLOCKS[1])
    if parts is None:
        parts = next((p for p in range(1, G + 1)
                      if G % p == 0 and blocks * p >= 2 * SM_COUNT), G)
    elif parts < 1 or G % parts:
        raise ValueError(f"flash_bwd_dkv_plan: parts {parts} does not "
                         f"divide the group of {G} heads")
    return DkvPlan(parts, blocks * parts,
                   (2, parts, B * Hkv, Sk, 256) if parts > 1 else None)


def flash_fwd_blocks(route: str) -> tuple[int, int]:
    """(block_q, block_k) of a forward route's kernel."""
    if route == "flash_fwd":
        return WGMMA_BLOCK_Q, WGMMA_BLOCK_K
    if route == "flash_fwd_d256":
        return WGMMA_D256_BLOCKS
    return BLOCK_Q, BLOCK_K


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int | None = None, prune: bool = True,
                             q_offset: int = 0, k_offset: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of ``csrc/flash_fwd.cu`` that
    :func:`flash_fwd_route` names: a wgmma kernel (launch key
    ``flash_fwd``, or ``flash_fwd_d256`` at head_dim 256) or the CUDA-core
    one (``flash_fwd_simt``).  q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D) — any
    strides with a contiguous last dimension, e.g. the ``transpose(1, 2)``
    views of the engine's (B, S, H, D) tensors, which are read in place.
    Returns ``(o, lse)``: o has q's shape and memory layout, lse is f32
    (B * H, Sq).  The launch carries no gradient, so it refuses inputs that
    autograd wants one of: those go through :func:`flash_attention_train`.
    ``prune=False`` walks the dense grid (:func:`_ranges_on`); the offsets
    shift the band (module docstring)."""
    _check_inputs("flash_attention_fwd_cuda", q, k, v, window)
    _check_offsets("flash_attention_fwd_cuda", q_offset, k_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd_cuda is the forward-only launch; for a "
            "gradient call flash_attention_train, or call under "
            "torch.no_grad()")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    route = flash_fwd_route(q, k, v)
    ranges = _ranges_on(q.device, Sq, Sk, bool(causal), window, "row",
                        *flash_fwd_blocks(route), prune, q_offset, k_offset)
    o = torch.empty_like(q)          # keeps q's (B, S, H, D) memory layout
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    nq = ranges.shape[0]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), ranges.data_ptr())
    shape = (B, H, H // Hkv, Sq, Sk, D, nq, int(bool(causal)),
             0 if window is None else int(window), int(q_offset),
             int(k_offset))
    if route in ("flash_fwd", "flash_fwd_d256"):
        entry = "flash_fwd_wgmma" if route == "flash_fwd" else route
        fn = _build.bind("flash_fwd", entry,
                         *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 11,
                         ctypes.POINTER(ctypes.c_longlong), ctypes.c_float)
        st = (ctypes.c_longlong * 12)(
            *[x for t in (q, k, v) for x in _tma_strides(t)],
            *o.stride()[:3])
        err = fn(*head, *shape, st, 1.0 / math.sqrt(D), _build.stream_ptr(q))
    else:
        fn = _build.bind("flash_fwd", "flash_fwd_simt",
                         *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 12,
                         *[ctypes.c_longlong] * 12, ctypes.c_float)
        err = fn(*head, _DTYPE_CODE[q.dtype], *shape,
                 *[x for t in (q, k, v, o) for x in t.stride()[:3]],
                 1.0 / math.sqrt(D), _build.stream_ptr(q))
    _build.check(err, route)
    _build.LAUNCHES[route] += 1
    return o, lse


# head dims each direction's kernels are built for (csrc/flash_fwd.cu and
# csrc/flash_bwd.cu take 256 on a wgmma route of its own and on the
# CUDA-core one)
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)


def _check_inputs(what: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, window: int | None,
                  head_dims: tuple[int, ...] = FWD_HEAD_DIMS) -> None:
    """What the kernels take: q (B, H, Sq, D), k/v (B, Hkv, Sk, D) on one
    sm_90 device, bf16 or f32 of one dtype, a head_dim in ``head_dims``
    (the forward's by default), the head dim contiguous."""
    B, H, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"{what} takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or H % Hkv or \
            D not in head_dims:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"(head_dim one of {head_dims})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: the head dim must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    _build.check_device(q)


def _check_offsets(what: str, q_offset: int, k_offset: int) -> None:
    """The kernels take the offsets as 32-bit ints and form q + shift:
    Python ints within 2^30 of 0 keep that in range for any length."""
    for name, x in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not isinstance(x, int) or not -2 ** 30 < x < 2 ** 30:
            raise ValueError(f"{what}: {name} must be an int within 2^30 "
                             f"of 0, got {x!r}")


def _check_bwd(q, k, v, do, lse, delta, window) -> None:
    _check_inputs("flash_attention_bwd_cuda", q, k, v, window,
                  BWD_HEAD_DIMS)
    B, H, Sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or \
            do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd_cuda: do must match q "
                         f"{tuple(q.shape)} {q.dtype} with a contiguous "
                         f"last dim, got {tuple(do.shape)} {do.dtype} "
                         f"strides {do.stride()}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, Sq) or t.dtype != torch.float32 or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be "
                             f"contiguous f32 {(B * H, Sq)} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def _strides(*ts) -> ctypes.Array:
    """(batch, head, seq) strides of each tensor, as one C array."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[st for t in ts for st in t.stride()[:3]])


def _bwd_call(name: str, q, k, v, do, lse, delta, outs, ranges, causal,
              window, route: str, q_offset: int, k_offset: int,
              plan: DkvPlan | None = None) -> None:
    """Launch kernel ``name`` ('dq' or 'dkv') of ``route`` and count it;
    ``plan``: the split of dk/dv on route "flash_bwd_d256", whose partials
    go to f32 scratch allocated here."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *[o.data_ptr() for o in outs])
    shape = (B, H, H // Hkv, Sq, Sk, D, ranges.shape[0], int(bool(causal)),
             0 if window is None else int(window), int(q_offset),
             int(k_offset))
    tail = (ctypes.POINTER(ctypes.c_longlong), ctypes.c_float)
    if route in ("flash_bwd", "flash_bwd_d256"):
        key = f"flash_bwd_{name}" + ("" if route == "flash_bwd" else "_d256")
        ints = shape
        if name == "dkv" and route == "flash_bwd_d256":
            scratch = outs[0]         # unused at one part
            if plan.scratch:
                scratch = torch.empty(plan.scratch, dtype=torch.float32,
                                      device=q.device)
            ptrs += (scratch.data_ptr(),)
            ints += (plan.parts,)
        ptrs += (ranges.data_ptr(),)
        fn = _build.bind("flash_bwd", f"{key}_wgmma" if route == "flash_bwd"
                         else key, *[ctypes.c_void_p] * len(ptrs),
                         *[ctypes.c_int] * len(ints), *tail)
        st = [x for t in (q, k, v, do) for x in _tma_strides(t)]
        st += [x for o in outs for x in o.stride()[:3]]
        err = fn(*ptrs, *ints, (ctypes.c_longlong * len(st))(*st),
                 1.0 / math.sqrt(D), _build.stream_ptr(q))
    else:
        key = f"flash_bwd_{name}_simt"
        ptrs += (ranges.data_ptr(),)
        fn = _build.bind("flash_bwd", key, *[ctypes.c_void_p] * len(ptrs),
                         *[ctypes.c_int] * 12, *tail)
        err = fn(*ptrs, _DTYPE_CODE[q.dtype], *shape,
                 _strides(q, k, v, do, *outs), 1.0 / math.sqrt(D),
                 _build.stream_ptr(q))
    _build.check(err, key)
    _build.LAUNCHES[key] += 1


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal=True,
                      window=None, prune=True, q_offset=0,
                      k_offset=0) -> torch.Tensor:
    """Launch the dq kernel of ``csrc/flash_bwd.cu`` that
    :func:`flash_bwd_route` names (launch key ``flash_bwd_dq``,
    ``flash_bwd_dq_d256`` or ``flash_bwd_dq_simt``); arguments as
    :func:`flash_attention_bwd_cuda`.  Returns dq in f32 with q's memory
    layout."""
    _check_bwd(q, k, v, do, lse, delta, window)
    _check_offsets("flash_bwd_dq_cuda", q_offset, k_offset)
    route = flash_bwd_route(q, k, v, do)
    kw = flash_bwd_plain_kw(route)
    rows = _ranges_on(q.device, q.shape[2], k.shape[2], bool(causal), window,
                      "row", kw["block_q"], kw["block_k"], prune, q_offset,
                      k_offset)
    dq = torch.empty_like(q, dtype=torch.float32)
    _bwd_call("dq", q, k, v, do, lse, delta, (dq,), rows, causal, window,
              route, q_offset, k_offset)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal=True,
                       window=None, prune=True, q_offset=0, k_offset=0,
                       parts: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of ``csrc/flash_bwd.cu`` that
    :func:`flash_bwd_route` names (launch key ``flash_bwd_dkv``,
    ``flash_bwd_dkv_d256`` or ``flash_bwd_dkv_simt``); arguments as
    :func:`flash_attention_bwd_cuda`.  ``parts`` (route "flash_bwd_d256"
    only, else a ValueError; a divisor of the GQA group) overrides
    :func:`flash_bwd_dkv_plan`'s split.  Returns (dk, dv) in f32 with k's
    and v's memory layouts."""
    route = flash_bwd_route(q, k, v, do)
    if parts is not None and route != "flash_bwd_d256":
        raise ValueError(f"flash_bwd_dkv_cuda: parts splits route "
                         f"flash_bwd_d256 only, not {route}")
    _check_bwd(q, k, v, do, lse, delta, window)
    _check_offsets("flash_bwd_dkv_cuda", q_offset, k_offset)
    B, H, _, _ = q.shape
    plan = (flash_bwd_dkv_plan(B, k.shape[1], H // k.shape[1], k.shape[2],
                               parts) if route == "flash_bwd_d256" else None)
    cols = _ranges_on(q.device, q.shape[2], k.shape[2], bool(causal), window,
                      "col", *flash_bwd_plain_kw(route)["dkv_blocks"], prune,
                      q_offset, k_offset)
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    _bwd_call("dkv", q, k, v, do, lse, delta, (dk, dv), cols, causal, window,
              route, q_offset, k_offset, plan)
    return dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             prune: bool = True, q_offset: int = 0,
                             k_offset: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the two kernels of ``csrc/flash_bwd.cu`` on the route
    :func:`flash_bwd_route` names: dq, then dk/dv.  q/do: (B, H, Sq, D),
    k/v: (B, Hkv, Sk, D) — any strides with a contiguous last dimension
    (``do`` arrives as the gradient of a transposed view); lse/delta: f32
    (B * H, Sq) contiguous.  Returns (dq, dk, dv) in f32, each with its
    input's memory layout."""
    kw = dict(causal=causal, window=window, prune=prune, q_offset=q_offset,
              k_offset=k_offset)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))


_RANGES: dict[tuple, torch.Tensor] = {}


def _ranges_on(dev: torch.device, Sq: int, Sk: int, causal: bool,
               window: int | None, order: str, block_q: int,
               block_k: int, prune: bool = True, q_offset: int = 0,
               k_offset: int = 0) -> torch.Tensor:
    """The kernels' per-CTA block ranges (``order`` 'row': k blocks of each
    q block; 'col': q blocks of each k block) at a kernel's block shape and
    the band shifted by the offsets, on the device, built once per shape.
    ``prune=False`` gives every q block every k block (the dense grid): the
    kernels mask the blocks a pruned range leaves out, so they add exactly
    0."""
    shift = q_offset - k_offset if prune else 0
    key = (dev, Sq, Sk, causal, window, order, block_q, block_k, prune,
           shift)
    t = _RANGES.get(key)
    if t is None:
        build = row_block_ranges if order == "row" else col_block_ranges
        r = build(Sq, Sk, block_q=block_q, block_k=block_k, causal=causal,
                  window=window, q_offset=shift)
        if not prune:       # every block of the other axis
            r[:] = (0, -(-Sk // block_k) - 1 if order == "row"
                    else -(-Sq // block_q) - 1)
        t = torch.from_numpy(r).to(dev)
        _RANGES[key] = t
    return t


# ---------------------------------------------------------------------------
# Trainable entry: forward and backward bound in one autograd Function
# ---------------------------------------------------------------------------

def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        prune: bool = True,
                        blocks: tuple[int, int] | None = None,
                        q_offset: int = 0, k_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :class:`FlashAttention` from its residuals, before
    the cast to the inputs' dtypes.  q/o/do: (B, H, Sq, D), k/v: (B, Hkv,
    Sk, D), lse: f32 (B * H, Sq) from the forward.  Forms ``delta =
    rowsum(o * do)`` in f32 with torch ops, as the reference does outside
    its kernels, then launches the dq and dk/dv kernels of
    :func:`flash_bwd_route` on CUDA tensors (or raises) and runs the plain
    versions at that route's blocks and rounding on CPU tensors (at
    ``blocks`` for both kernels, where given).  ``prune=False`` hands the
    kernels the dense grid; the offsets shift the band.  Returns (dq, dk,
    dv) in f32 with q's, k's and v's shapes."""
    B, H, Sq, D = q.shape
    if do.stride(-1) != 1:                 # e.g. an expanded gradient
        do = do.contiguous()
    delta = (o.float() * do.float()).sum(-1).reshape(B * H, Sq) \
        .contiguous()
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              k_offset=k_offset)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, do, lse, delta, **kw,
                                        prune=prune)
    plain_kw = flash_bwd_plain_kw(flash_bwd_route(q, k, v, do))
    if blocks is not None:
        plain_kw.update(block_q=blocks[0], block_k=blocks[1],
                        dkv_blocks=tuple(blocks))
    dq, dk, dv = flash_attention_bwd_plain(
        q.reshape(B * H, Sq, D), *_kv_rows(k, v), do.reshape(B * H, Sq, D),
        lse, delta, **kw, **plain_kw, prune=prune)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    custom VJP ``flash_attention_train``.  q: (B, H, Sq, D), k/v: (B, Hkv,
    Sk, D).  The forward saves (q, k, v, o, lse) and the offsets; the
    backward is :func:`flash_attention_bwd`, cast to the inputs' dtypes.
    On CUDA tensors each half launches its kernels (or raises) on the
    dense grid when ``prune`` is False; on CPU tensors it runs the plain
    versions, at ``blocks`` where given."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prune=True, blocks=None,
                q_offset=0, k_offset=0):
        offs = dict(q_offset=q_offset, k_offset=k_offset)
        if q.is_cuda:
            o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal,
                                              window=window, prune=prune,
                                              **offs)
        else:
            B, H, Sq, D = q.shape
            bq, bk = blocks or flash_fwd_blocks(flash_fwd_route(q, k, v))
            o, lse = flash_attention_fwd_plain(
                q.reshape(B * H, Sq, D), *_kv_rows(k, v), causal=causal,
                window=window, block_q=bq, block_k=bk, prune=prune, **offs)
            o = o.reshape(q.shape)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.prune, ctx.blocks, ctx.offs = prune, blocks, offs
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window, prune=ctx.prune,
                                         blocks=ctx.blocks, **ctx.offs)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def _kv_rows(k: torch.Tensor, v: torch.Tensor):
    B, Hkv, Sk, D = k.shape
    return k.reshape(B * Hkv, Sk, D), v.reshape(B * Hkv, Sk, D)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None, prune: bool = True,
                          blocks: tuple[int, int] | None = None,
                          q_offset: int = 0, k_offset: int = 0
                          ) -> torch.Tensor:
    """Trainable flash attention on (B, H, S, D) q and (B, Hkv, Sk, D) k/v
    (see :class:`FlashAttention`); the offsets shift the band."""
    return FlashAttention.apply(q, k, v, causal, window, prune, blocks,
                                q_offset, k_offset)


# ---------------------------------------------------------------------------
# Dense decode: one new token against a (B, Hkv, S, D) KV cache
# ---------------------------------------------------------------------------

def decode_block_k(S: int, block_k: int) -> int:
    """The reference's ``block_k`` for a cache of S tokens: clamped to S,
    and to the pow2 floor of S when S is not a multiple (the last block is
    then ragged; the length mask drops what lies past S)."""
    block_k = min(block_k, S)
    if S % block_k:
        block_k = min(block_k, pow2_floor(S))
    return block_k


def decode_splits(S: int, block_k: int) -> int:
    """Splits of the history the decode kernel runs for a cache of S tokens
    at the reference's ``block_k``: ceil(S / decode_block_k(S, block_k)),
    each one CTA per (sequence, kv head)."""
    return -(-S // decode_block_k(S, block_k))


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor, *,
                       block_k: int = 512) -> torch.Tensor:
    """q (B, H, D) one token; caches (B, Hkv, S, D); lengths (B,) valid
    tokens.  Returns (B, H, D) in q's dtype.

    The kernel's arithmetic: the history is cut into splits of
    ``block_k`` cached tokens (after the reference's clamp,
    :func:`decode_block_k`); each split, for every sequence and head at
    once, forms its f32 softmax partial against its own maximum, m (with
    the -1e30 guard: masked positions add exactly 0, a split with no live
    token keeps m = -1e30, l = 0, acc = 0), l = sum p and acc = sum p v;
    the splits combine as sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i
    with l == 0 drained as 1 (so a length of 0 gives 0)."""
    B, H, Dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = H // Hkv
    block_k = decode_block_k(S, block_k)
    dev = q.device
    qg = q.reshape(B, Hkv, G, Dh).float()
    lens = lengths.long().to(dev)
    scale = 1.0 / math.sqrt(Dh)
    ms, ls, accs = [], [], []
    for k0 in range(0, S, block_k):
        k = k_cache[:, :, k0:k0 + block_k].float()      # (B, Hkv, t, D)
        v = v_cache[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bkgd,bktd->bkgt", qg, k) * scale
        kpos = k0 + torch.arange(k.shape[2], device=dev)
        mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,bktd->bkgd", p, v))
    m_all = torch.stack(ms)                              # (splits, B, Hkv, G)
    M = m_all.amax(0)
    f = torch.exp(m_all - M)
    l = (f * torch.stack(ls)).sum(0)
    acc = (f[..., None] * torch.stack(accs)).sum(0)
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, H, Dh).to(q.dtype)


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      lengths: torch.Tensor, *,
                      block_k: int = 512) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu`` on the shapes of
    :func:`flash_decode_plain`: one CTA per (split of ``block_k`` cached
    tokens, kv head, sequence), then the kernel that combines the splits
    (none when the history is one split).  The caches are read through
    their (batch, head, seq) strides in place; q, caches need a contiguous
    last dimension, one dtype (bf16 or f32); lengths int32."""
    tensors = (q, k_cache, v_cache, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_decode_cuda: every operand must lie on q's "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode_cuda takes bf16 or f32 q and caches "
                        f"of one dtype, got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode_cuda: lengths must be int32")
    B, H, Dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = H // Hkv
    if (k_cache.shape != (B, Hkv, S, Dh) or v_cache.shape != k_cache.shape
            or H % Hkv or not 1 <= G <= 8 or Dh > 256 or
            lengths.shape != (B,)):
        raise ValueError(f"flash_decode_cuda: unsupported shapes q "
                         f"{tuple(q.shape)} caches {tuple(k_cache.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    if (q.stride(-1) != 1 or k_cache.stride(-1) != 1 or
            v_cache.stride(-1) != 1 or lengths.stride(0) != 1):
        raise ValueError("flash_decode_cuda: unsupported strides")
    if block_k < 1:
        raise ValueError(f"flash_decode_cuda: block_k {block_k} < 1")
    _build.check_device(q)
    bk, nsplit = decode_block_k(S, block_k), decode_splits(S, block_k)
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    # the split workspace: each split's (m, l) and acc, f32
    part_acc = part_ml = out
    if nsplit > 1:
        part_acc = torch.empty((B, H, nsplit, Dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                              device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], out.stride(0), out.stride(1))
    fn = _build.bind("flash_decode", "flash_decode", *[ctypes.c_void_p] * 7,
                     *[ctypes.c_int] * 8, ctypes.POINTER(ctypes.c_longlong),
                     ctypes.c_float)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), _DTYPE_CODE[q.dtype], B, Hkv, G, Dh, S, bk,
             nsplit, strides, 1.0 / math.sqrt(Dh), _build.stream_ptr(q))
    _build.check(err, "flash_decode")
    _build.LAUNCHES["flash_decode"] += 1
    return out
