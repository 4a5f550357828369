"""Paged flash decode: the plain PyTorch version and the launcher of the
hand-written CUDA kernel (``csrc/paged_decode.cu``).

Counterpart of ``repro.kernels.paged_attention``.  K/V live in a global
POOL of fixed-size pages in the engine's own layout (P, page, Hkv, D), and a
per-slot page table names the physical pages of each slot's history (page
0 is the trash page, always masked by the length).  The int8 form keeps the
pool quantized with per-(token, head) f32 scales (P, page, Hkv) and
dequantizes page by page.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30


def paged_flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """q: (B, H, D) one token per slot; pools (P, page, Hkv, D); page_table
    (B, max_pages) physical ids; lengths (B,) valid cached tokens, each
    >= 1; scales (P, page, Hkv) for int8 pools.  Returns (B, H, D) in q's
    dtype.

    The kernel's arithmetic, one page step at a time over every slot and
    head at once: pages dequantized to f32, f32 scores and online softmax,
    masked positions adding exactly 0, l == 0 drained as 1."""
    B, H, Dh = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    qg = q.reshape(B, Hkv, G, Dh).float()
    m = torch.full((B, Hkv, G), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G), device=dev)
    acc = torch.zeros((B, Hkv, G, Dh), device=dev)
    pt = page_table.long()
    lens = lengths.long()
    for j in range(pt.shape[1]):
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
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(B, H, Dh).to(q.dtype)


_Q_DTYPE = {torch.bfloat16: 0, torch.float32: 1}


def paged_flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            lengths: torch.Tensor,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Launch ``csrc/paged_decode.cu`` on the shapes of
    :func:`paged_flash_decode_plain`.  The pool is read through its
    strides in place (a layer's slice of the engine's (L, P, page, Hkv, D)
    pool is fine); q, pools and scales need a contiguous last dimension.
    q is bf16 or f32; the pool has q's dtype, or int8 with scales."""
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
    smem = 4 * (G * Dh + page * (Dh + 1) + page * Dh + G * page + 3 * G)
    if smem > 48 * 1024:
        raise ValueError(f"paged_flash_decode_cuda: page {page} needs "
                         f"{smem} B of shared memory (> 48 KB)")
    _build.check_device(q)
    out = torch.empty_like(q)
    sc = k_scale.stride() if quant else (0, 0, 0)
    fn = _build.bind("paged_decode", "paged_decode", *[ctypes.c_void_p] * 8,
                     *[ctypes.c_int] * 8, *[ctypes.c_longlong] * 11,
                     ctypes.c_float)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             _Q_DTYPE[q.dtype], int(quant), B, Hkv, G, Dh, page,
             page_table.shape[1], q.stride(0), q.stride(1),
             k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
             sc[0], sc[1], sc[2], page_table.stride(0),
             out.stride(0), out.stride(1),
             1.0 / math.sqrt(Dh), _build.stream_ptr(q))
    _build.check(err, "paged_decode")
    _build.LAUNCHES["paged_decode_int8" if quant else
                    "paged_decode_bf16"] += 1
    return out
