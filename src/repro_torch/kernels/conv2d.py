"""Direct 2-D convolution (NHWC x HWIO, VALID): the plain PyTorch version
and the launchers of the hand-written CUDA kernels (``csrc/conv2d.cu``).

Counterpart of ``repro.kernels.conv2d`` (paper Eq. 2 with stride and
dilation): the reduction over (kh, kw, ci) runs inside an output tile whose
f32 accumulator stays put.  Two routes (:func:`conv2d_route`): ``"conv2d"``,
the tensor-core (``wgmma``) implicit GEMM for bf16, with its tile and K
split from ``core.cuda_bridge.conv2d_plan``; and ``"conv2d_simt"``, the
CUDA-core kernel with the reference's ``block_oh`` / ``block_co``, for f32
and for operands TMA cannot read.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.cuda_bridge import CONV_TILES, conv2d_k_steps
from . import _build

_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
# Blocks the CUDA-core kernel is built for: its 64-pixel tile holds up to
# 64 output rows, and its widest channel tile is 128.
MAX_BLOCK_OH = 64
MAX_BLOCK_CO = 128


def out_hw(IH: int, IW: int, KH: int, KW: int, stride: int,
           dilation: int) -> tuple[int, int]:
    """Output rows and columns of a VALID convolution."""
    return ((IH - (KH - 1) * dilation - 1) // stride + 1,
            (IW - (KW - 1) * dilation - 1) // stride + 1)


def conv2d_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route of a convolution, a pure function of the operands'
    dtype and alignment on any device: ``"conv2d"`` (wgmma) for bf16 x and
    w with 16-byte aligned bases (what TMA and 16-byte loads read),
    ``"conv2d_simt"`` otherwise."""
    ok = all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
             for t in (x, w))
    return "conv2d" if ok else "conv2d_simt"


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 dilation: int = 1) -> torch.Tensor:
    """x (N, IH, IW, CI), w (KH, KW, CI, CO) -> (N, OH, OW, CO) in x's
    dtype: the kernels' schedule, one (kh, kw) tap at a time, each tap's
    strided input window times the tap's (CI, CO) weights added into an f32
    accumulator.  Both routes sum the same f32 products of bf16 (or f32)
    values, in other orders."""
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


def _check(what: str, x: torch.Tensor, w: torch.Tensor, stride: int,
           dilation: int, dtypes) -> tuple[int, ...]:
    """The launch contract both kernels share; returns (N, IH, IW, CI, OH,
    OW, CO, KH, KW)."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"{what}: x and w must lie on one CUDA device")
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"{what} takes {' or '.join(map(str, dtypes))} of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    N, IH, IW, CI = x.shape
    KH, KW, CI2, CO = w.shape
    OH, OW = out_hw(IH, IW, KH, KW, stride, dilation)
    if (CI2 != CI or OH < 1 or OW < 1 or stride < 1 or dilation < 1 or
            not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(f"{what}: unsupported x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, stride {stride}, dilation "
                         f"{dilation} (x and w must be contiguous)")
    _build.check_device(x)
    return N, IH, IW, CI, OH, OW, CO, KH, KW


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                dilation: int = 1, block_oh: int, block_ow: int,
                block_co: int, splits: int = 1) -> torch.Tensor:
    """Launch the wgmma kernel of ``csrc/conv2d.cu`` (route ``"conv2d"``,
    launch key ``conv2d``) on the shapes of :func:`conv2d_plain`: a tile of
    ``block_oh`` x ``block_ow`` output pixels by ``block_co`` channels (one
    of ``cuda_bridge.CONV_TILES``; others raise), the K steps cut into
    ``splits`` CTAs whose f32 partials a second kernel sums in split order.
    x and w contiguous bf16 with 16-byte aligned bases; the ragged OH, OW
    and CO edges are masked in the kernel."""
    if (block_oh, block_ow, block_co) not in CONV_TILES:
        raise ValueError(f"conv2d_cuda: blocks (block_oh {block_oh}, "
                         f"block_ow {block_ow}, block_co {block_co}) are not "
                         f"ones csrc/conv2d.cu is built for on route conv2d "
                         f"(cuda_bridge.CONV_TILES)")
    N, IH, IW, CI, OH, OW, CO, KH, KW = _check(
        "conv2d_cuda", x, w, stride, dilation, (torch.bfloat16,))
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv2d_cuda: x and w need 16-byte aligned bases")
    steps = conv2d_k_steps(CI, KH, KW, stride=stride, block_ow=block_ow)
    if not 1 <= splits <= steps or -(-steps // -(-steps // splits)) != splits:
        raise ValueError(f"conv2d_cuda: {splits} splits of {steps} K steps "
                         f"leave a split empty")
    out = torch.empty((N, OH, OW, CO), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, N * OH * OW, CO), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn = _build.bind("conv2d", "conv2d_wgmma", *[ctypes.c_void_p] * 4,
                     *[ctypes.c_int] * 15)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
             part.data_ptr() if part is not None else None, N, IH, IW, CI,
             OH, OW, CO, KH, KW, stride, dilation, block_oh, block_ow,
             block_co, splits, _build.stream_ptr(x))
    _build.check(err, "conv2d")
    _build.LAUNCHES["conv2d"] += 1
    return out


def conv2d_simt_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     dilation: int = 1, block_oh: int, block_co: int
                     ) -> torch.Tensor:
    """Launch the CUDA-core kernel of ``csrc/conv2d.cu`` (route
    ``"conv2d_simt"``, launch key ``conv2d_simt``) on the shapes of
    :func:`conv2d_plain`.  ``block_oh`` (1..64) output rows by ``block_co``
    (1..128) output channels a CTA; other blocks raise.  x and w
    contiguous, bf16 or f32 of one dtype; the ragged OH, OW and CO edges
    are masked in the kernel."""
    if not (1 <= block_oh <= MAX_BLOCK_OH and 1 <= block_co <= MAX_BLOCK_CO):
        raise ValueError(f"conv2d_simt_cuda: blocks (block_oh {block_oh}, "
                         f"block_co {block_co}) are not ones csrc/conv2d.cu "
                         f"is built for on route conv2d_simt "
                         f"(1..{MAX_BLOCK_OH}, 1..{MAX_BLOCK_CO})")
    N, IH, IW, CI, OH, OW, CO, KH, KW = _check(
        "conv2d_simt_cuda", x, w, stride, dilation, tuple(_DTYPE))
    out = torch.empty((N, OH, OW, CO), dtype=x.dtype, device=x.device)
    fn = _build.bind("conv2d", "conv2d_simt", *[ctypes.c_void_p] * 3,
                     *[ctypes.c_int] * 14)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE[x.dtype],
             N, IH, IW, CI, OH, OW, CO, KH, KW, stride, dilation, block_oh,
             block_co, _build.stream_ptr(x))
    _build.check(err, "conv2d_simt")
    _build.LAUNCHES["conv2d_simt"] += 1
    return out
