"""Tiled matmul: the plain PyTorch version and the launcher of the
hand-written CUDA kernel (``csrc/matmul.cu``).

Counterpart of ``repro.kernels.matmul`` (the paper's TEU GEMM,
output-stationary: an f32 accumulator per output tile that the reduction
over k streams through).  Blocks come from
``repro_torch.core.cuda_bridge.matmul_block_shapes``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.cuda_bridge import MATMUL_TILES
from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 block_k: int) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype: the kernel's schedule,
    an f32 accumulator that each block of ``block_k`` reduction steps adds
    into, drained once at the end."""
    M, K = a.shape
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, block_k):
        acc += a[:, k0:k0 + block_k].float() @ b[k0:k0 + block_k].float()
    return acc.to(a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                block_n: int, block_k: int) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on the shapes of :func:`matmul_plain`
    with one of the tiles it is built for (``cuda_bridge.MATMUL_TILES``);
    any other tile raises.  a and b are bf16 or f32, one dtype, with unit
    column stride; the ragged edges are masked in the kernel."""
    tile = (block_m, block_n, block_k)
    if tile not in MATMUL_TILES:
        raise ValueError(f"matmul_cuda: tile {tile} is not one csrc/matmul.cu "
                         f"is built for ({sorted(MATMUL_TILES)})")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul_cuda: a and b must lie on one CUDA device")
    if a.dtype not in _DTYPE or b.dtype != a.dtype:
        raise TypeError(f"matmul_cuda takes bf16 or f32 of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    M, K = a.shape
    K2, N = b.shape
    if K2 != K or a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError(f"matmul_cuda: unsupported shapes or strides "
                         f"{tuple(a.shape)}@{tuple(b.shape)}")
    _build.check_device(a)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = _build.bind("matmul", "matmul", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 4, *[ctypes.c_longlong] * 3,
                     *[ctypes.c_int] * 3)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPE[a.dtype],
             M, N, K, a.stride(0), b.stride(0), out.stride(0), *tile,
             _build.stream_ptr(a))
    _build.check(err, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return out
