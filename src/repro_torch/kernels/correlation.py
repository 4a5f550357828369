"""FlowNet correlation (cost volume): the plain PyTorch version and the
launcher of the hand-written CUDA kernel (``csrc/correlation.cu``).

Counterpart of ``repro.kernels.correlation`` (paper Eq. 3):
``C[y, x, dy, dx] = sum_c I1[y, x, c] * I2[y + dy - R, x + dx - R, c]`` with
I2 zero outside the image, D = 2R + 1 displacements a side.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
MAX_RADIUS = 31          # the kernel holds D <= 63 dx values a pixel


def correlation_plain(i1: torch.Tensor, i2: torch.Tensor, *,
                      radius: int) -> torch.Tensor:
    """i1, i2 (H, W, C) -> (H, W, D, D) in i1's dtype: the kernel's
    schedule, one (dy, dx) window at a time, each an f32 sum over C of I1
    times I2 shifted by the displacement (zero padded by ``radius``)."""
    H, W, _ = i1.shape
    D = 2 * radius + 1
    a = i1.float()
    i2p = F.pad(i2.float(), (0, 0, radius, radius, radius, radius))
    out = torch.empty((H, W, D, D), dtype=torch.float32, device=i1.device)
    for dy in range(D):
        for dx in range(D):
            out[:, :, dy, dx] = (a * i2p[dy:dy + H, dx:dx + W]).sum(-1)
    return out.to(i1.dtype)


def correlation_cuda(i1: torch.Tensor, i2: torch.Tensor, *, radius: int,
                     block_y: int) -> torch.Tensor:
    """Launch ``csrc/correlation.cu`` on the shapes of
    :func:`correlation_plain`: ``block_y`` rows a CTA, radius 0..31.  i1
    and i2 contiguous, bf16 or f32 of one dtype; I2 is read in place."""
    if not (0 <= radius <= MAX_RADIUS and block_y >= 1):
        raise ValueError(f"correlation_cuda: radius {radius} / block_y "
                         f"{block_y} not built (radius 0..{MAX_RADIUS})")
    if not (i1.is_cuda and i2.is_cuda and i1.device == i2.device):
        raise ValueError("correlation_cuda: i1 and i2 must lie on one CUDA "
                         "device")
    if i1.dtype not in _DTYPE or i2.dtype != i1.dtype:
        raise TypeError(f"correlation_cuda takes bf16 or f32 of one dtype, "
                        f"got {i1.dtype} and {i2.dtype}")
    if (i1.dim() != 3 or i2.shape != i1.shape or not i1.is_contiguous() or
            not i2.is_contiguous()):
        raise ValueError(f"correlation_cuda: unsupported i1 "
                         f"{tuple(i1.shape)}, i2 {tuple(i2.shape)} (both "
                         f"(H, W, C), contiguous)")
    _build.check_device(i1)
    H, W, C = i1.shape
    D = 2 * radius + 1
    out = torch.empty((H, W, D, D), dtype=i1.dtype, device=i1.device)
    fn = _build.bind("correlation", "correlation", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 6)
    err = fn(i1.data_ptr(), i2.data_ptr(), out.data_ptr(), _DTYPE[i1.dtype],
             H, W, C, radius, block_y, _build.stream_ptr(i1))
    _build.check(err, "correlation")
    _build.LAUNCHES["correlation"] += 1
    return out
