"""Direct 2-D convolution (NHWC x HWIO, VALID): the plain PyTorch version
and the launcher of the hand-written CUDA kernel (``csrc/conv2d.cu``).

Counterpart of ``repro.kernels.conv2d`` (paper Eq. 2 with stride and
dilation): the reduction over (kh, kw, ci) runs inside an output tile of
``block_oh`` rows by ``block_co`` channels, whose f32 accumulator stays put.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
# Blocks the kernel is built for: its 64-pixel tile holds up to 64 output
# rows, and its widest channel tile is 128.
MAX_BLOCK_OH = 64
MAX_BLOCK_CO = 128


def out_hw(IH: int, IW: int, KH: int, KW: int, stride: int,
           dilation: int) -> tuple[int, int]:
    """Output rows and columns of a VALID convolution."""
    return ((IH - (KH - 1) * dilation - 1) // stride + 1,
            (IW - (KW - 1) * dilation - 1) // stride + 1)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 dilation: int = 1) -> torch.Tensor:
    """x (N, IH, IW, CI), w (KH, KW, CI, CO) -> (N, OH, OW, CO) in x's
    dtype: the kernel's schedule, one (kh, kw) tap at a time, each tap's
    strided input window times the tap's (CI, CO) weights added into an f32
    accumulator."""
    N, IH, IW, CI = x.shape
    KH, KW, _, CO = w.shape
    OH, OW = out_hw(IH, IW, KH, KW, stride, dilation)
    xf = x.float()
    acc = torch.zeros((N, OH, OW, CO), dtype=torch.float32, device=x.device)
    for kh in range(KH):
        for kw in range(KW):
            h0, w0 = kh * dilation, kw * dilation
            win = xf[:, h0:h0 + (OH - 1) * stride + 1:stride,
                     w0:w0 + (OW - 1) * stride + 1:stride]
            acc += win @ w[kh, kw].float()
    return acc.to(x.dtype)


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                dilation: int = 1, block_oh: int, block_co: int
                ) -> torch.Tensor:
    """Launch ``csrc/conv2d.cu`` on the shapes of :func:`conv2d_plain`.
    ``block_oh`` (1..64) output rows by ``block_co`` (1..128) output
    channels a CTA; other blocks raise.  x and w contiguous, bf16 or f32 of
    one dtype; the ragged OH, OW and CO edges are masked in the kernel."""
    if not (1 <= block_oh <= MAX_BLOCK_OH and 1 <= block_co <= MAX_BLOCK_CO):
        raise ValueError(f"conv2d_cuda: blocks (block_oh {block_oh}, "
                         f"block_co {block_co}) are not ones csrc/conv2d.cu "
                         f"is built for (1..{MAX_BLOCK_OH}, "
                         f"1..{MAX_BLOCK_CO})")
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("conv2d_cuda: x and w must lie on one CUDA device")
    if x.dtype not in _DTYPE or w.dtype != x.dtype:
        raise TypeError(f"conv2d_cuda takes bf16 or f32 of one dtype, got "
                        f"{x.dtype} and {w.dtype}")
    N, IH, IW, CI = x.shape
    KH, KW, CI2, CO = w.shape
    OH, OW = out_hw(IH, IW, KH, KW, stride, dilation)
    if (CI2 != CI or OH < 1 or OW < 1 or stride < 1 or dilation < 1 or
            not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(f"conv2d_cuda: unsupported x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, stride {stride}, dilation "
                         f"{dilation} (x and w must be contiguous)")
    _build.check_device(x)
    out = torch.empty((N, OH, OW, CO), dtype=x.dtype, device=x.device)
    fn = _build.bind("conv2d", "conv2d", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 14)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE[x.dtype],
             N, IH, IW, CI, OH, OW, CO, KH, KW, stride, dilation, block_oh,
             block_co, _build.stream_ptr(x))
    _build.check(err, "conv2d")
    _build.LAUNCHES["conv2d"] += 1
    return out
