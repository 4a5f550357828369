"""Paged flash decode: the plain PyTorch version and the launcher of the
hand-written CUDA kernel (``csrc/paged_decode.cu``).

Counterpart of ``repro.kernels.paged_attention``.  K/V live in a global
POOL of fixed-size pages in the engine's own layout (P, page, Hkv, D), and a
per-slot page table names the physical pages of each slot's history (page
0 is the trash page, always masked by the length).  The int8 form keeps the
pool quantized with per-(token, head) f32 scales (P, page, Hkv) and
dequantizes page by page.  The history is cut into splits of whole pages
(:func:`paged_decode_plan`), one CTA each on the card, and the splits'
softmax partials combine by their log-sum-exp.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

# The split plan's rule (:func:`paged_decode_plan`), read off an H100 by
# ``scripts/sweep_paged_decode_torch.py`` (PERF.md §6): as many splits
# as keep B x Hkv x nsplit CTAs within PLAN_CTAS, and no split shorter
# than PLAN_MIN_TOKENS cached tokens.  A CTA holds ~216-255 registers a
# thread, so one runs on an SM: the time is that of the longest CTA times
# the waves of live CTAs.  A split that starts past its slot's length is
# not live, and PLAN_CTAS lets the grid exceed the 132 SMs by the part of
# it that typically is not (4 slots x 8 kv heads: 5 splits, the fastest at
# ``chip_smoke.py``'s shape and within 4% of the fastest at the serving
# run's 64-page view); splits of 64 tokens and less lose to the CTA's
# fixed cost.
PLAN_CTAS = 160
PLAN_MIN_TOKENS = 64


def paged_decode_plan(B: int, Hkv: int, max_pages: int, page: int
                      ) -> tuple[int, int]:
    """(pages_per_split, nsplit) of the paged decode kernel for a table of
    ``max_pages`` pages of ``page`` tokens, over B slots and Hkv kv heads.

    Shapes only, never the lengths (reading them would sync the host with
    the card at every launch): in serving ``max_pages`` is the engine's
    power-of-two view of the table, which covers the longest active slot,
    so it bounds the work.  A split is a whole number of pages; splits that
    start past a slot's length cost one CTA that returns at once.  Takes
    Python ints only."""
    if not all(type(x) is int for x in (B, Hkv, max_pages, page)):
        raise TypeError("paged_decode_plan takes shape ints, not device "
                        "values")
    want = max(1, PLAN_CTAS // max(1, B * Hkv))
    pps = max(-(-max_pages // want), -(-PLAN_MIN_TOKENS // page))
    pps = min(pps, max_pages)
    return pps, -(-max_pages // pps)


def _partial(qg, k_pages, v_pages, pt, lens, k_scale, v_scale, pages,
             page, scale):
    """One split's softmax partial over table columns ``pages``: today's
    page-by-page online softmax from (m, l, acc) = (-1e30, 0, 0), pages
    dequantized to f32, masked positions adding exactly 0."""
    B, Hkv, G, Dh = qg.shape
    dev = qg.device
    m = torch.full((B, Hkv, G), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G), device=dev)
    acc = torch.zeros((B, Hkv, G, Dh), device=dev)
    for j in pages:
        phys = pt[:, j]
        k = k_pages[phys].float()                      # (B, page, Hkv, D)
        v = v_pages[phys].float()
        if k_scale is not None:
            k = k * k_scale[phys][..., None]
            v = v * v_scale[phys][..., None]
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
        kpos = j * page + torch.arange(page, device=dev)
        mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, v)
        m = m_new
    return m, l, acc


def paged_flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None, *,
                             pages_per_split: int | None = None
                             ) -> torch.Tensor:
    """q: (B, H, D) one token per slot; pools (P, page, Hkv, D); page_table
    (B, max_pages) physical ids; lengths (B,) valid cached tokens, each
    >= 1; scales (P, page, Hkv) for int8 pools.  Returns (B, H, D) in q's
    dtype.

    The kernel's arithmetic, for every slot and head at once: the table is
    cut into splits of ``pages_per_split`` pages (default: the kernel's
    :func:`paged_decode_plan`); each split forms its f32 softmax partial
    page by page (pages dequantized to f32, masked positions adding exactly
    0; a split with no live token keeps m = -1e30, l = 0, acc = 0), and the
    splits combine as sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i in
    split order, l == 0 drained as 1.  One split is the single page-by-page
    pass, bit for bit."""
    B, H, Dh = q.shape
    _, page, Hkv, _ = k_pages.shape
    MP = page_table.shape[1]
    if pages_per_split is None:
        pages_per_split, _ = paged_decode_plan(B, Hkv, MP, page)
    qg = q.reshape(B, Hkv, H // Hkv, Dh).float()
    pt = page_table.long()
    lens = lengths.long()
    parts = [_partial(qg, k_pages, v_pages, pt, lens, k_scale, v_scale,
                      range(p0, min(p0 + pages_per_split, MP)), page,
                      1.0 / math.sqrt(Dh))
             for p0 in range(0, MP, pages_per_split)]
    m_all = torch.stack([p[0] for p in parts])        # (splits, B, Hkv, G)
    f = torch.exp(m_all - m_all.amax(0))
    l = (f * torch.stack([p[1] for p in parts])).sum(0)
    acc = (f[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, H, Dh).to(q.dtype)


_Q_DTYPE = {torch.bfloat16: 0, torch.float32: 1}


def paged_flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            lengths: torch.Tensor,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None, *,
                            pages_per_split: int | None = None
                            ) -> torch.Tensor:
    """Launch ``csrc/paged_decode.cu`` on the shapes of
    :func:`paged_flash_decode_plain`: one CTA per (split of
    ``pages_per_split`` pages, kv head, slot), default
    :func:`paged_decode_plan`, then the kernel that combines the splits
    (none for one split).  The pool is read through its strides in place
    (a layer's slice of the engine's (L, P, page, Hkv, D) pool is fine); q,
    pools and scales need a contiguous last dimension.  q is bf16 or f32;
    the pool has q's dtype, or int8 with scales.  Nothing here waits for
    the card."""
    B, H, Dh = q.shape
    P, page, Hkv, Dk = k_pages.shape
    quant = k_scale is not None
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_flash_decode_cuda: every operand must lie on "
                         "q's CUDA device")
    if q.dtype not in _Q_DTYPE:
        raise TypeError(f"paged_flash_decode_cuda takes bf16 or f32 q, got "
                        f"{q.dtype}")
    want_kv = torch.int8 if quant else q.dtype
    if k_pages.dtype != want_kv or v_pages.dtype != want_kv:
        raise TypeError(f"paged_flash_decode_cuda: pool dtype "
                        f"{k_pages.dtype}/{v_pages.dtype}, wanted {want_kv}")
    if quant and (k_scale.dtype != torch.float32 or
                  v_scale.dtype != torch.float32 or
                  k_scale.shape != (P, page, Hkv) or
                  v_scale.stride() != k_scale.stride()):
        raise ValueError("paged_flash_decode_cuda: scales must be f32 "
                         "(P, page, Hkv) with one layout")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_flash_decode_cuda: page_table and lengths "
                        "must be int32")
    G = H // Hkv
    if (Dk != Dh or H % Hkv or v_pages.shape != k_pages.shape or
            Dh > 256 or G > 8 or page_table.shape[0] != B or
            lengths.shape != (B,)):
        raise ValueError(f"paged_flash_decode_cuda: unsupported shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pages.shape)} "
                         f"table {tuple(page_table.shape)}")
    if (q.stride(-1) != 1 or k_pages.stride(-1) != 1 or
            v_pages.stride() != k_pages.stride() or
            page_table.stride(-1) != 1 or lengths.stride(0) != 1 or
            (quant and k_scale.stride(-1) != 1)):
        raise ValueError("paged_flash_decode_cuda: unsupported strides")
    MP = page_table.shape[1]
    if pages_per_split is None:
        pages_per_split, nsplit = paged_decode_plan(B, Hkv, MP, page)
    elif pages_per_split < 1:
        raise ValueError(f"paged_flash_decode_cuda: pages_per_split "
                         f"{pages_per_split} < 1")
    else:
        nsplit = -(-MP // pages_per_split)
    _build.check_device(q)
    out = torch.empty_like(q)
    # the split workspace: each split's (m, l) and acc, f32
    part_acc = part_ml = out
    if nsplit > 1:
        part_acc = torch.empty((B, H, nsplit, Dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                              device=q.device)
    sc = k_scale.stride() if quant else (0, 0, 0)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(1), *k_pages.stride()[:3], *sc,
        page_table.stride(0), out.stride(0), out.stride(1))
    fn = _build.bind("paged_decode", "paged_decode", *[ctypes.c_void_p] * 10,
                     *[ctypes.c_int] * 10, ctypes.POINTER(ctypes.c_longlong),
                     ctypes.c_float)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(),
             _Q_DTYPE[q.dtype], int(quant), B, Hkv, G, Dh, page, MP,
             pages_per_split, nsplit, strides, 1.0 / math.sqrt(Dh),
             _build.stream_ptr(q))
    _build.check(err, "paged_decode")
    _build.LAUNCHES["paged_decode_int8" if quant else
                    "paged_decode_bf16"] += 1
    return out
