"""Tiled matmul: the route choice, the plain PyTorch versions and the
launchers of the hand-written CUDA kernels (``csrc/matmul.cu``).

Counterpart of ``repro.kernels.matmul`` (the paper's TEU GEMM,
output-stationary: an f32 accumulator per output tile that the reduction
over k streams through).  :func:`matmul_route` picks one of three kernels
from the operands alone, before any launch:

* ``"matmul"`` — bf16, M > ``GEMV_MAX_M`` (1), operands TMA can read: the
  ``wgmma`` kernel, tiles from ``core.cuda_bridge.matmul_block_shapes``;
* ``"matmul_gemv"`` — bf16, M <= ``GEMV_MAX_M``, B readable with 16-byte
  loads, no tile named by the caller: the split-K GEMV and its fixed-order
  reduction, split by ``core.cuda_bridge.gemv_plan``.  Its kernel takes
  any M < 64, but only at M = 1 did it beat the wgmma tile on the card;
* ``"matmul_simt"`` — everything else (f32; row strides or bases that are
  not 16-byte multiples): the CUDA-core kernel, tiles from the same search
  on its own lattice.

Each route has its launcher and its ``LAUNCHES`` key (the route's name).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.cuda_bridge import (GEMV_MAX_M, MATMUL_TILES, WGMMA_TILES,
                                 gemv_plan)
from ..device import card_like
from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}


def _tma_ok(t: torch.Tensor) -> bool:
    """A 2-D bf16 operand TMA (and 16-byte vector loads) can read: unit
    column stride, a row stride of a multiple of 8 elements (16 bytes)
    where there is more than one row, and a 16-byte-aligned base."""
    return (t.stride(1) == 1 and t.data_ptr() % 16 == 0 and
            (t.shape[0] == 1 or t.stride(0) % 8 == 0))


def matmul_route(a: torch.Tensor, b: torch.Tensor, *,
                 tiled: bool = False) -> str:
    """The kernel route of ``a @ b`` (module docstring): a pure function of
    the operands' dtype, M and alignment, on any device.  ``tiled``: the
    caller names a tile, which the GEMV does not take, so bf16 at any M
    goes to the wgmma kernel (its TMA loads zero-fill the rows past M)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            not _tma_ok(b):
        return "matmul_simt"
    if a.shape[0] <= GEMV_MAX_M and not tiled:
        return "matmul_gemv"          # reads A with scalar loads
    return "matmul" if _tma_ok(a) else "matmul_simt"


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 block_k: int) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype: the tiled kernels'
    schedule, an f32 accumulator that each block of ``block_k`` reduction
    steps adds into, drained once at the end."""
    M, K = a.shape
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, block_k):
        acc += a[:, k0:k0 + block_k].float() @ b[k0:k0 + block_k].float()
    return acc.to(a.dtype)


def matmul_gemv_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype on the GEMV kernel's
    schedule (``gemv_plan``): one f32 partial per K split, the partials
    summed in split order, then rounded once."""
    M, K = a.shape
    _, kchunk = gemv_plan(M, b.shape[1], K)
    out = None
    for k0 in range(0, K, kchunk):
        p = a[:, k0:k0 + kchunk].float() @ b[k0:k0 + kchunk].float()
        out = p if out is None else out + p
    return out.to(a.dtype)


def _check(what: str, a: torch.Tensor, b: torch.Tensor, *,
           bf16_only: bool, aligned: tuple = ()) -> None:
    """What a kernel takes: a and b on one sm_90 device, one dtype (bf16,
    or also f32), (M, K) @ (K, N) with unit column strides, and the
    operands named in ``aligned`` readable by TMA (``_tma_ok``)."""
    if not (card_like(a) and card_like(b) and a.device == b.device):
        raise ValueError(f"{what}: a and b must lie on one CUDA (or the meta) device")
    dtypes = (torch.bfloat16,) if bf16_only else tuple(_DTYPE)
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"{what} takes {'/'.join(map(str, dtypes))} of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError(f"{what}: unsupported shapes or strides "
                         f"{tuple(a.shape)}@{tuple(b.shape)}")
    for name in aligned:
        t = a if name == "a" else b
        if not _tma_ok(t):
            raise ValueError(f"{what}: {name} (strides {t.stride()}) needs a "
                             f"16-byte row stride and base; its route is "
                             f"{matmul_route(a, b)!r}")
    _build.check_device(a)


def _row_stride(t: torch.Tensor) -> int:
    """The row stride handed to TMA: a one-row operand's stride is never
    read, so it is given as its row length rounded to 16 bytes."""
    return t.stride(0) if t.shape[0] > 1 else -(-t.shape[1] // 8) * 8


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                block_n: int, block_k: int = 64) -> torch.Tensor:
    """Launch the ``wgmma`` kernel of ``csrc/matmul.cu`` (route
    ``"matmul"``) on the shapes of :func:`matmul_plain` with one of the
    tiles it is built for (``cuda_bridge.WGMMA_TILES``); any other tile,
    or operands TMA cannot read, raise."""
    tile = (block_m, block_n, block_k)
    if tile not in WGMMA_TILES:
        raise ValueError(f"matmul_cuda: tile {tile} is not one csrc/matmul.cu "
                         f"is built for ({sorted(WGMMA_TILES)})")
    _check("matmul_cuda", a, b, bf16_only=True, aligned=("a", "b"))
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if a.is_meta:        # the meta route: the checks and outputs only
        return out
    fn = _build.bind("matmul", "matmul_wgmma", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 3, *[ctypes.c_longlong] * 2,
                     *[ctypes.c_int] * 2)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
             _row_stride(a), _row_stride(b), block_m, block_n,
             _build.stream_ptr(a))
    _build.check(err, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return out


def matmul_gemv_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the split-K GEMV of ``csrc/matmul.cu`` (route
    ``"matmul_gemv"``; the kernel takes bf16 at any M < 64, B read with
    16-byte loads) and its
    reduction, on the schedule of :func:`matmul_gemv_plain`.  The f32
    partials go to a scratch allocated here."""
    _check("matmul_gemv_cuda", a, b, bf16_only=True, aligned=("b",))
    M, K = a.shape
    N = b.shape[1]
    splits, kchunk = gemv_plan(M, N, K)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if a.is_meta:        # the meta route: the checks and outputs only
        return out
    fn = _build.bind("matmul", "matmul_gemv", *[ctypes.c_void_p] * 4,
                     *[ctypes.c_int] * 3, *[ctypes.c_longlong] * 2,
                     *[ctypes.c_int] * 2)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), M,
             N, K, a.stride(0), _row_stride(b), splits, kchunk,
             _build.stream_ptr(a))
    _build.check(err, "matmul_gemv")
    _build.LAUNCHES["matmul_gemv"] += 1
    return out


def matmul_simt_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                     block_n: int, block_k: int) -> torch.Tensor:
    """Launch the CUDA-core kernel of ``csrc/matmul.cu`` (route
    ``"matmul_simt"``) with one of the tiles it is built for
    (``cuda_bridge.MATMUL_TILES``); any other tile raises.  a and b are
    bf16 or f32, one dtype, with unit column stride; the ragged edges are
    masked in the kernel."""
    tile = (block_m, block_n, block_k)
    if tile not in MATMUL_TILES:
        raise ValueError(f"matmul_simt_cuda: tile {tile} is not one "
                         f"csrc/matmul.cu is built for "
                         f"({sorted(MATMUL_TILES)})")
    _check("matmul_simt_cuda", a, b, bf16_only=False)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if a.is_meta:        # the meta route: the checks and outputs only
        return out
    fn = _build.bind("matmul", "matmul_simt", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 4, *[ctypes.c_longlong] * 3,
                     *[ctypes.c_int] * 3)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPE[a.dtype],
             M, N, K, a.stride(0), b.stride(0), out.stride(0), *tile,
             _build.stream_ptr(a))
    _build.check(err, "matmul_simt")
    _build.LAUNCHES["matmul_simt"] += 1
    return out
