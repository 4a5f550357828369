"""FlowNet correlation (cost volume): the plain PyTorch versions and the
launchers of the hand-written CUDA kernels (``csrc/correlation.cu``).

Counterpart of ``repro.kernels.correlation`` (paper Eq. 3):
``C[y, x, dy, dx] = sum_c I1[y, x, c] * I2[y + dy - R, x + dx - R, c]`` with
I2 zero outside the image, D = 2R + 1 displacements a side.  Two routes
(:func:`correlation_route`): ``"correlation"``, the tensor-core
(``wgmma``) kernel whose row-pair products are tiled by
``core.cuda_bridge.correlation_plan``, and ``"correlation_simt"``, the
CUDA-core kernel, for f32 and for rows TMA cannot stride.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.cuda_bridge import (CORR_MAX_RADIUS, CORR_TX, CorrPlan,
                                correlation_block_n, correlation_plan)
from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
MAX_RADIUS = CORR_MAX_RADIUS   # both kernels hold D <= 63 dx values a pixel


def correlation_route(i1: torch.Tensor, i2: torch.Tensor,
                      radius: int) -> str:
    """The kernel route of a correlation, a pure function of the operands'
    dtype, channels, alignment and the radius on any device:
    ``"correlation"`` (wgmma) for bf16 maps whose C is a multiple of 8
    (16-byte rows, what TMA strides), with 16-byte aligned bases and
    0 <= radius <= 31; ``"correlation_simt"`` otherwise."""
    ok = (0 <= radius <= MAX_RADIUS and i1.shape[-1] % 8 == 0 and
          all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
              for t in (i1, i2)))
    return "correlation" if ok else "correlation_simt"


def correlation_plain(i1: torch.Tensor, i2: torch.Tensor, *,
                      radius: int) -> torch.Tensor:
    """i1, i2 (H, W, C) -> (H, W, D, D) in i1's dtype: one (dy, dx) window
    at a time, each an f32 sum over C of I1 times I2 shifted by the
    displacement (zero padded by ``radius``).  The CUDA-core kernel's
    schedule, and the version the kernels are held against."""
    H, W, _ = i1.shape
    D = 2 * radius + 1
    a = i1.float()
    i2p = F.pad(i2.float(), (0, 0, radius, radius, radius, radius))
    out = torch.empty((H, W, D, D), dtype=torch.float32, device=i1.device)
    for dy in range(D):
        for dx in range(D):
            out[:, :, dy, dx] = (a * i2p[dy:dy + H, dx:dx + W]).sum(-1)
    return out.to(i1.dtype)


def correlation_band_plain(i1: torch.Tensor, i2: torch.Tensor, *,
                           radius: int, block_n: int | None = None
                           ) -> torch.Tensor:
    """The wgmma kernel's schedule in f32: for every 64-column tile x0, output
    row y and dy, the full row-pair product of the I1 row tile (64 x C,
    zero past W) and the I2 row y + dy - R over ``block_n`` columns from
    x0 - R (zero outside the image), a (64, block_n) matrix whose band
    0 <= n - x < D is out[y, x0 + x, dy, n - x].  ``block_n`` defaults to
    the plan's (``correlation_block_n``)."""
    H, W, C = i1.shape
    R, D = radius, 2 * radius + 1
    N = block_n or correlation_block_n(R)
    if N < CORR_TX + 2 * R:
        raise ValueError(f"correlation_band_plain: block_n {N} misses the "
                         f"band (needs >= {CORR_TX + 2 * R})")
    tiles = -(-W // CORR_TX)
    a = F.pad(i1.float(), (0, 0, 0, tiles * CORR_TX - W))
    # I2 column x0 - R + n lands at padded column x0 + n; row y + dy - R at
    # padded row y + dy
    wp = (tiles - 1) * CORR_TX + N
    b = F.pad(i2.float(), (0, 0, R, wp - R - W, R, R))
    band = (torch.arange(CORR_TX, device=i1.device)[:, None] +
            torch.arange(D, device=i1.device)[None, :]).expand(H, -1, -1)
    out = torch.empty((H, tiles * CORR_TX, D, D), dtype=torch.float32,
                      device=i1.device)
    for t in range(tiles):
        x0 = t * CORR_TX
        rows1 = a[:, x0:x0 + CORR_TX]                       # (H, 64, C)
        for dy in range(D):
            rows2 = b[dy:dy + H, x0:x0 + N]                 # (H, N, C)
            prod = rows1 @ rows2.transpose(1, 2)            # (H, 64, N)
            out[:, x0:x0 + CORR_TX, dy] = prod.gather(2, band)
    return out[:, :W].to(i1.dtype)


def _check(what: str, i1: torch.Tensor, i2: torch.Tensor, radius: int,
           dtypes) -> tuple[int, int, int]:
    """The launch contract both kernels share; returns (H, W, C)."""
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{what}: radius {radius} not built (radius "
                         f"0..{MAX_RADIUS})")
    if not (i1.is_cuda and i2.is_cuda and i1.device == i2.device):
        raise ValueError(f"{what}: i1 and i2 must lie on one CUDA device")
    if i1.dtype not in dtypes or i2.dtype != i1.dtype:
        raise TypeError(f"{what} takes {' or '.join(map(str, dtypes))} of "
                        f"one dtype, got {i1.dtype} and {i2.dtype}")
    if (i1.dim() != 3 or i2.shape != i1.shape or not i1.is_contiguous() or
            not i2.is_contiguous()):
        raise ValueError(f"{what}: unsupported i1 {tuple(i1.shape)}, i2 "
                         f"{tuple(i2.shape)} (both (H, W, C), contiguous)")
    _build.check_device(i1)
    return tuple(i1.shape)


def correlation_cuda(i1: torch.Tensor, i2: torch.Tensor, *, radius: int,
                     plan: CorrPlan | None = None) -> torch.Tensor:
    """Launch the wgmma kernel of ``csrc/correlation.cu`` (route
    ``"correlation"``, launch key ``correlation``) on the shapes of
    :func:`correlation_plain`, tiled by ``plan`` (default
    ``correlation_plan(H, W, C, radius)``).  i1 and i2 contiguous bf16 with
    C % 8 == 0 and 16-byte aligned bases; I2 is read in place."""
    H, W, C = _check("correlation_cuda", i1, i2, radius, (torch.bfloat16,))
    if C % 8 or i1.data_ptr() % 16 or i2.data_ptr() % 16:
        raise ValueError(f"correlation_cuda: C {C} must be a multiple of 8 "
                         f"and the bases 16-byte aligned (route "
                         f"correlation_simt takes the rest)")
    p = plan or correlation_plan(H, W, C, radius)
    D = 2 * radius + 1
    out = torch.empty((H, W, D, D), dtype=i1.dtype, device=i1.device)
    fn = _build.bind("correlation", "correlation_wgmma",
                     *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 9)
    err = fn(i1.data_ptr(), i2.data_ptr(), out.data_ptr(), H, W, C, radius,
             p.rows, p.dy_group, p.block_n, p.chunks, p.stages,
             _build.stream_ptr(i1))
    _build.check(err, "correlation")
    _build.LAUNCHES["correlation"] += 1
    return out


def correlation_simt_cuda(i1: torch.Tensor, i2: torch.Tensor, *,
                          radius: int, block_y: int) -> torch.Tensor:
    """Launch the CUDA-core kernel of ``csrc/correlation.cu`` (route
    ``"correlation_simt"``, launch key ``correlation_simt``) on the shapes
    of :func:`correlation_plain`: ``block_y`` rows a CTA, radius 0..31.  i1
    and i2 contiguous, bf16 or f32 of one dtype; I2 is read in place."""
    if block_y < 1:
        raise ValueError(f"correlation_simt_cuda: block_y {block_y} not "
                         f"built (block_y >= 1)")
    H, W, C = _check("correlation_simt_cuda", i1, i2, radius, tuple(_DTYPE))
    D = 2 * radius + 1
    out = torch.empty((H, W, D, D), dtype=i1.dtype, device=i1.device)
    fn = _build.bind("correlation", "correlation_simt",
                     *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 6)
    err = fn(i1.data_ptr(), i2.data_ptr(), out.data_ptr(), _DTYPE[i1.dtype],
             H, W, C, radius, block_y, _build.stream_ptr(i1))
    _build.check(err, "correlation_simt")
    _build.LAUNCHES["correlation_simt"] += 1
    return out
