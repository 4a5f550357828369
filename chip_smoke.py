#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port, run from the repository root
on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/kernels/`` (and prints ``ptxas``'s registers, spills and
shared memory of each), holds each kernel route on a main path against its
plain PyTorch version at the serving, training and paper-workload paths'
full-width shapes (the flash forward's and backward's wgmma routes; the
matmul's wgmma route at GEMM_1K and its split-K GEMV at GEMM_FC; the
conv2d wgmma implicit GEMM at DL_ATROUS4; the correlation's wgmma
row-pair products at FLOWNET_CORR; dense decode split over the
history at qwen3-4b's decode shape), runs
the paper's workload catalog (24 convolution, correlation and GEMM layers
at their own shapes, bf16, batch 1) and qwen3-4b's dense decode shape
through ``repro_torch.kernels.ops``, times both of the matmul's bf16 routes at
GEMM_FC's N and K for M below 64, serves qwen3-4b at full width (bf16,
random weights from a seed) through ``repro_torch.launch.serve`` in the
dense, paged and paged_int8 KV modes, holds one paged decode step through
the paged kernel (history split by ``paged_decode_plan``) against the plain
gather path over bf16 and int8 pools, serves the same weights through a
three-host ``LocalFleet`` (``serve_fleet``: a shared prefix's KV pages
migrate between hosts over the CRC-framed page exchange, bit for bit, in
bf16 and int8 pools, under die, netsplit and pagecorrupt chaos, and
``repro_torch.launch.serve --fleet 2`` restarts a worker killed by chaos
under the process supervisor), serves and checks olmoe-1b-7b in the three
KV modes as qwen3-4b, a top-8-of-64 MoE (``serve_moe``: the flash forward
at MHA, the paged decode at 16 kv heads, the share of expert assignments
the capacity drops; the two kernels are also checked alone at olmoe's and
granite-moe's heads),
serves internvl2-26b (vlm: a 256-token vision prefix, GQA group 6),
recurrentgemma-9b (hybrid: RG-LRU and local MQA at head_dim 256 through the
flash forward's head_dim-256 wgmma route, one prompt past its 2048-token
window),
whisper-medium (audio: a non-causal encoder over 1500 frames and
cross-attention to them) and mamba2-370m (ssm: no kernel) at full width in
the dense KV mode, one family's weights at a time (``serve_families``,
each with its flash-vs-plain ``logits_check``; the flash forward is also
checked alone at their shapes; every flash route, forward and backward,
is also held against its plain version at nonzero q / k position offsets,
and each CUDA-core route, which no main path takes, is timed at its
sibling's shape in f32 beside its library call, the flash forward and
backward also at recurrentgemma-9b's in bf16 through a padded stride),
holds the flash kernels' loss and gradients against the plain attention
path, trains qwen3-4b at full width
for a few AdamW steps through ``repro_torch.launch.train``, runs the
context-parallel ring on a (1, 4) mesh of local rings on the card (``ring``:
``ring_attention`` at qwen3-4b's and recurrentgemma-9b's heads, each hop
the flash kernels at its offsets, against the unsharded kernels, with a
wholly masked hop's zero-write; ``ring_matmul`` at qwen3-4b's MLP width
against ``torch.matmul`` and its peak against the all-gather's; qwen3-4b's
loss and grads through the ring against the unsharded step, and 3 AdamW
steps of qwen3-4b whole through the ring), then the four
families (``train_families``: internvl2-26b and recurrentgemma-9b cut to
8 layers, whisper-medium and mamba2-370m whole, every width the config's
own; recurrentgemma's attention backward at head_dim 256 runs the
head_dim-256 wgmma pair, held end to end against the plain path by its
own ``train_check`` and alone at its shape in bf16), drills a kill
and a restart of that training at full width through the loop's format-v2
checkpoints (``recovery``: the restarted run must resume bit for bit), and
checks what comes out.  Each phase prints JSON lines (``paper_workloads``
one per workload); a failed phase exits non-zero before the result line.  Each
kernel time is given twice: ``ms``, the span a caller waits for (the
wrapper's host work included where it outlasts the flush before it), and
``device_ms``, the device work alone.  The last two lines are the card's
name and power limit (``nvidia-smi``) and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails at once outside a checkout)

# H100 SXM published peaks (dense): bf16 tensor cores, int8 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
ARCH = "qwen3-4b"
MOE_ARCH = "olmoe-1b-7b"
SEED = 0


def _plain(o):
    return o.item() if hasattr(o, "item") else str(o)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=_plain), flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles of the spin kernel queued before each call a covered timing reads
# (~1 ms at the H100's clocks): longer than any wrapper's host work before
# its launch
HOST_COVER_CYCLES = 2_000_000


def time_ms(fn, iters: int, flush: torch.Tensor | None = None, *,
            covered: bool = False) -> tuple[float, list[float]]:
    """Mean time of ``fn`` in ms over ``iters`` calls after two warm-up
    calls, and the [min, max] of the calls, each call timed by CUDA events
    recorded around it; ``flush`` (a buffer larger than the 50 MB L2) is
    overwritten before each call so the inputs come from device memory, as
    they do on the serving path.  Uncovered (each row's ``ms``), the span
    holds whatever of the wrapper's host work before its launch outlasts
    the flush, as a caller waits for it.  ``covered`` queues a spin kernel
    after the flush that keeps the stream busy while the host runs the
    wrapper, so the events time the device work alone (``device_ms``)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        if covered:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sum(times) / iters, [min(times), max(times)]


def device_ms(fn, iters: int, flush: torch.Tensor | None) -> float:
    """The covered reading of :func:`time_ms`: device time alone."""
    return time_ms(fn, iters, flush, covered=True)[0]


def closeness(got: torch.Tensor, want: torch.Tensor, atol: float,
              rel: float = 2.0 ** -7, row: float = 2.0 ** -6) -> dict:
    """How far a kernel output lies from its f32-arithmetic plain version,
    row by row over the last axis.  For a bf16 output each element must
    satisfy |got - want| <= 2^-7 |want| + atol (one bf16 ulp of the value,
    since the two sum in different orders before rounding, plus ``atol``),
    and each row's relative L2 error must stay under 2^-6, which a wrong
    score or PV accumulation in any row exceeds by far.  An f32 output,
    where nothing is rounded, gives its own ``rel`` and ``row``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ratio = (diff / (rel * want.abs() + atol)).max().item()
    row_rel = (diff.norm(dim=-1) /
               want.norm(dim=-1).clamp_min(1e-30)).max().item()
    return dict(max_abs_err=diff.max().item(), worst_tol_ratio=ratio,
                max_row_rel_l2=row_rel, mean_abs_out=want.abs().mean().item(),
                tol=f"|err| <= {rel:g}|want| + {atol:g}; row rel L2 <= "
                    f"{row:g}",
                within_tol=ratio <= 1.0 and row_rel <= row)


def closeness_f32(got: torch.Tensor, want: torch.Tensor) -> dict:
    """An f32 kernel output against its plain version, nothing rounded:
    the two sum f32 products in other orders, so each element within
    2^-10 |want| + 1e-5 max|want| (a floor for sums that cancel) and each
    row's relative L2 error under 2^-10, as the card tests hold the
    CUDA-core backward."""
    atol = 1e-5 * want.abs().max().item()
    return closeness(got, want, atol, rel=2.0 ** -10, row=2.0 ** -10)


def closeness_rounded(got: torch.Tensor, want: torch.Tensor,
                      terms: torch.Tensor) -> dict:
    """How far a rounded backward route's f32 output (dq, dk or dv; rows
    along the last axis) lies from its plain version, which rounds p and
    ds to bf16 as the kernels do (the card tests' check too); ``terms`` is
    that output's ``attention.flash_bwd_term_max``.  The two form p and ds
    in f32 in other orders (the kernels with exp2), so where a value lies
    at a bf16 rounding boundary one rounds up and the other down: that one
    term of the element's sum moves by one bf16 ulp, at most 2^-7 of
    itself, and the sums differ in their f32 order.  Each element within
    2^-7 (|want| + its row's RMS + T) + 1e-5 max|want|, T the element's
    largest rounded term; each row's L2 error within 2^-7 of its norm +
    1e-5 max|want| sqrt(D) (a row dominated by one term moves by up to
    2^-7; a row that cancels to 0 keeps the floor); and the whole tensor's
    relative L2 error under 2^-10, since flips are rare and unbiased: the
    row and tensor bounds catch a systematic error."""
    got, want, terms = got.float(), want.float(), terms.float()
    diff = (got - want).abs()
    atol = 1e-5 * want.abs().max().item()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    tol = 2.0 ** -7 * (want.abs() + rms + terms) + atol
    ratio = (diff / tol.clamp_min(1e-30)).max().item()
    row_tol = 2.0 ** -7 * want.norm(dim=-1) + atol * want.shape[-1] ** 0.5
    row_ratio = (diff.norm(dim=-1) / row_tol.clamp_min(1e-30)).max().item()
    rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    return dict(max_abs_err=diff.max().item(), worst_tol_ratio=ratio,
                worst_row_tol_ratio=row_ratio, tensor_rel_l2=rel,
                mean_abs_out=want.abs().mean().item(),
                tol="|err| <= 2^-7 (|want| + row RMS + T) + 1e-5 max|want|, "
                    "T the element's largest rounded term; row L2 <= 2^-7 "
                    "|want row| + 1e-5 max|want| sqrt(D); tensor rel L2 <= "
                    "2^-10",
                within_tol=ratio <= 1.0 and row_ratio <= 1.0 and
                rel <= 2.0 ** -10)


def peak_ops(dtype: torch.dtype) -> float:
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32


def bound(bytes_: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at full-width shapes
# ---------------------------------------------------------------------------

# the flash forward's shape on the train path (qwen3-4b: 32/8 heads), and
# at the MoE configs' heads (olmoe-1b-7b: MHA 16/16; granite-moe: 24/8,
# head_dim 64), which the card had not run at full width before
FLASH_SHAPE = dict(B=2, S=2048, H=32, Hkv=8, D=128)
FLASH_MOE_SHAPES = {"olmoe-1b-7b": dict(B=2, S=2048, H=16, Hkv=16, D=128),
                    "granite-moe-3b-a800m": dict(B=2, S=2048, H=24, Hkv=8,
                                                 D=64)}
# the model zoo's prefill shapes (serve_families): internvl2-26b's G 6;
# whisper-medium's non-causal encoder over 1500 frames and its
# cross-attention from a prompt to them (Sq != Sk, Sk not a multiple of
# 128); recurrentgemma-9b's local MQA at head_dim 256, the head_dim-256
# wgmma route (its kernels-line row)
FLASH_ZOO_SHAPES = {
    "internvl2-26b": dict(B=2, S=2048, H=48, Hkv=8, D=128),
    "whisper-medium encoder": dict(B=1, S=1500, H=16, Hkv=16, D=64,
                                   causal=False),
    "whisper-medium cross 1024": dict(B=1, S=1024, Sk=1500, H=16, Hkv=16,
                                      D=64, causal=False),
    "whisper-medium cross 16": dict(B=1, S=16, Sk=1500, H=16, Hkv=16, D=64,
                                    causal=False),
}
# (the backward's too: recurrentgemma-9b's train_families batch, where
# bf16 takes the head_dim-256 wgmma pair)
FLASH_D256_SHAPE = dict(B=1, S=4096, H=16, Hkv=1, D=256, window=2048)
# the backward's shape on the train path (qwen3-4b, B 2, S 2048, 32/8)
FLASH_BWD_SHAPE = dict(B=2, S=2048, H=32, Hkv=8, D=128)
# the wgmma backward at the model zoo's train shapes (train_families, B 2):
# internvl2-26b's G 6 over its 2304 positions (256 vision + 2048 text);
# whisper-medium's non-causal encoder over 1500 frames (Sk not a multiple
# of the blocks), its cross-attention (1024 x 1500) and its causal decoder
FLASH_ZOO_BWD_SHAPES = {
    "internvl2-26b": dict(B=2, S=2304, H=48, Hkv=8, D=128),
    "whisper-medium encoder": dict(B=2, S=1500, H=16, Hkv=16, D=64,
                                   causal=False),
    "whisper-medium cross": dict(B=2, S=1024, Sk=1500, H=16, Hkv=16, D=64,
                                 causal=False),
    "whisper-medium decoder": dict(B=2, S=1024, H=16, Hkv=16, D=64),
}


def attended_pairs(Sq: int, Sk: int, causal: bool,
                   window: int | None) -> int:
    """(q, k) pairs a query head attends under the kernels' masks (local
    positions: k <= q when causal, q - k < window)."""
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_inputs(shape: dict, dtype: torch.dtype, seed: int):
    """(B, H, S, D) q and (B, Hkv, Sk, D) k, v views of (B, S, H, D)
    tensors, as the model hands them; ``shape["pad"]`` widens each
    buffer's seq stride by that many elements (4: a stride TMA cannot
    read, so bf16 takes the CUDA-core route)."""
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    Sk, pad = shape.get("Sk", S), shape.get("pad", 0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, n, h * D + pad), generator=g, device="cuda")
                 .to(dtype)[..., :h * D].unflatten(-1, (h, D)).transpose(1, 2)
                 for n, h in ((S, H), (Sk, Hkv), (Sk, Hkv)))


def fwd_route_of(shape: dict, dtype: torch.dtype) -> str:
    """The forward route a shape must take: f32 or a padded seq stride the
    CUDA-core kernel, bf16 a wgmma kernel by head_dim."""
    if dtype != torch.bfloat16 or shape.get("pad", 0) % 8:
        return "flash_fwd_simt"
    return "flash_fwd" if shape["D"] in (64, 128) else "flash_fwd_d256"


def bwd_route_of(shape: dict, dtype: torch.dtype) -> str:
    """The backward route a shape must take: bf16 that TMA can read the
    wgmma pair at head_dim 64 or 128 and the head_dim-256 wgmma pair at
    256, f32 or a padded seq stride the CUDA-core pair."""
    if dtype != torch.bfloat16 or shape.get("pad", 0) % 8:
        return "flash_bwd_simt"
    return "flash_bwd" if shape["D"] in (64, 128) else "flash_bwd_d256"


# the suffix of each backward route's launch keys
BWD_SUFFIX = {"flash_bwd": "", "flash_bwd_d256": "_d256",
              "flash_bwd_simt": "_simt"}


def bwd_closeness(route: str):
    """``(got, want, terms) -> dict``: the rounded routes' check, or the
    CUDA-core pair's f32 one (which takes no terms)."""
    if route == "flash_bwd_simt":
        return lambda got, want, _: closeness_f32(got, want)
    return closeness_rounded


def band_mask(S: int, Sk: int, causal: bool, window: int | None):
    """SDPA's arguments for the kernels' band: ``is_causal`` without a
    window, else a bool mask (True = attend)."""
    if window is None:
        return dict(is_causal=causal)
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    return dict(attn_mask=(qp - kp < window) & ((qp >= kp) if causal
                                                else True))


def check_flash(flush, shape: dict = FLASH_SHAPE, arch: str | None = None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The forward kernel at ``shape`` (default the train phase's: B 2, S
    2048, 32/8 heads, causal), (B, S, H, D) tensors read through transposed
    views; ``shape`` may give ``Sk`` (default S), ``causal`` (default True),
    ``window`` and ``pad`` (:func:`flash_inputs`).  bf16 at head_dim 64 or
    128 must take the wgmma route ``flash_fwd``, at 256 the wgmma route
    ``flash_fwd_d256``; f32 and padded strides the CUDA-core one; the row is
    named by its route.  ``arch`` names the config whose heads an extra
    shape takes."""
    from repro_torch.kernels import attention as katt
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    Sk = shape.get("Sk", S)
    causal, window = shape.get("causal", True), shape.get("window")
    qt, kt, vt = flash_inputs(shape, dtype, SEED)
    route = katt.flash_fwd_route(qt, kt, vt)
    want = fwd_route_of(shape, dtype)
    require(route == want, f"flash forward: {dtype} at {shape} takes route "
            f"{route}, not {want}")
    bq, bk = katt.flash_fwd_blocks(route)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
        o_ref, lse_ref = katt.flash_attention_fwd_plain(
            qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D), **kw, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        # bf16: atol 2e-3 covers p's bf16 rounding before PV flipping where
        # the two score sums differ in their last f32 bits; f32 rounds
        # nothing
        close = (closeness(o.reshape(B * H, S, D), o_ref, atol=2e-3)
                 if dtype == torch.bfloat16 else
                 closeness_f32(o.reshape(B * H, S, D), o_ref))
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = 1e-4
        require(bool(torch.isfinite(o).all()), f"{route}: non-finite out")
        require(close["within_tol"] and lse_err <= lse_tol,
                f"{route} disagrees: {close}, max|lse| err {lse_err} "
                f"(tol {lse_tol})")
        fwd = lambda: katt.flash_attention_fwd_cuda(  # noqa: E731
            qt, kt, vt, **kw)
        ms, ms_spread = time_ms(fwd, 20, flush)
        dev_ms = device_ms(fwd, 20, flush)
        plain_ms, _ = time_ms(lambda: katt.flash_attention_fwd_plain(
            qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D), **kw, block_q=bq, block_k=bk),
            3, flush)
        sdpa_kw = band_mask(S, Sk, causal, window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **sdpa_kw)
        lib_ms, _ = time_ms(sdpa, 20, flush)
        lib_dev_ms = device_ms(sdpa, 20, flush)
    pairs = B * H * attended_pairs(S, Sk, causal, window)
    bytes_ = qt.element_size() * (qt.numel() + kt.numel() + vt.numel() +
                                  o.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(bytes_, 4 * D * pairs, peak_ops(dtype))
    row = dict(name=route, route="cuda",
               source="src/repro_torch/kernels/csrc/flash_fwd.cu",
               replaces="src/repro/kernels/attention.py:153",
               **close, lse_max_abs_err=lse_err, lse_tol=lse_tol,
               ms=ms, ms_spread=ms_spread, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, library_device_ms=lib_dev_ms,
               blocks=[bq, bk], dtype=str(dtype).split(".")[-1],
               shape=dict(B=B, S=S, Sk=Sk, H=H, Hkv=Hkv, D=D,
                          causal=causal, window=window,
                          pad=shape.get("pad", 0)),
               **({} if arch is None else {"arch": arch}))
    emit("kernel_check", **row)
    return row


def check_flash_bwd(flush, dtype: torch.dtype = torch.bfloat16,
                    shape: dict = FLASH_BWD_SHAPE, arch: str | None = None
                    ) -> list[dict]:
    """The dq and dk/dv kernels at ``shape`` (default the train phase's:
    B 2, S 2048, 32/8 heads, causal; ``shape`` may give ``Sk`` (default
    S), ``causal`` (default True), ``window`` and ``pad``, which widens
    each buffer's seq stride as in :func:`flash_inputs`), reached as
    the train path reaches them: the grads that
    ``flash_attention_train``'s backward returns for (B, S, H, D) leaves
    fed a transposed ``do``.  bf16 must take a wgmma route (head_dim 64
    or 128, or the head_dim-256 one), f32 and padded strides the CUDA-core
    one; the rows are named by the route's keys.  That backward is
    ``flash_attention_bwd`` (delta from the strided o and do, then the
    kernels) cast to the inputs' dtype, so its f32 results on the same
    residuals are held against the plain backward at the route's blocks
    and rounding, and the autograd grads must equal them cast, bit for bit
    (no atomics: every run sums in one order).  The head_dim-256 dk/dv row
    carries its split (``plan``)."""
    from repro_torch.kernels import attention as katt
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    Sk, pad = shape.get("Sk", S), shape.get("pad", 0)
    causal, window = shape.get("causal", True), shape.get("window")
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, do = (torch.randn((B, S, H * D + pad), generator=g, device="cuda")
             .to(dtype)[..., :H * D].unflatten(-1, (H, D)) for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv * D + pad), generator=g, device="cuda")
            .to(dtype)[..., :Hkv * D].unflatten(-1, (Hkv, D))
            for _ in range(2))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    route = katt.flash_bwd_route(qt, kt, vt, dot)
    want = bwd_route_of(shape, dtype)
    require(route == want, f"flash backward: {dtype} at {shape} takes "
            f"route {route}, not {want}")
    sfx = BWD_SUFFIX[route]
    close_fn = bwd_closeness(route)
    band = dict(causal=causal, window=window)
    plain_kw = dict(band, **katt.flash_bwd_plain_kw(route))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o_fn = katt.flash_attention_train(*(x.transpose(1, 2) for x in leaves),
                                      **band)
    grads = torch.autograd.grad(o_fn, leaves, dot)
    flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D), dot.reshape(B * H, S, D))
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **band)
        f32 = katt.flash_attention_bwd(qt, kt, vt, o, lse, dot, **band)
        delta = (o.float() * dot.float()).sum(-1).reshape(B * H, S) \
            .contiguous()
        dq_ref, dk_ref, dv_ref = katt.flash_attention_bwd_plain(
            *flat, lse, delta, **plain_kw)
        terms = ((None,) * 3 if route == "flash_bwd_simt" else
                 katt.flash_bwd_term_max(*flat, lse, delta, **plain_kw))
        torch.cuda.synchronize()
        dq, dk, dv = f32
        close = {"flash_bwd_dq": close_fn(dq.reshape(B * H, S, D), dq_ref,
                                          terms[0])}
        ck = close_fn(dk.reshape(B * Hkv, Sk, D), dk_ref, terms[1])
        cv = close_fn(dv.reshape(B * Hkv, Sk, D), dv_ref, terms[2])
        close["flash_bwd_dkv"] = {
            **{key: max(ck[key], cv[key]) for key in ck
               if isinstance(ck[key], float) and key != "mean_abs_out"},
            "mean_abs_out": ck["mean_abs_out"],
            "mean_abs_dv": cv["mean_abs_out"], "tol": ck["tol"],
            "within_tol": ck["within_tol"] and cv["within_tol"]}
        for name, c in close.items():
            require(c["within_tol"], f"{name} disagrees: {c}")
        require(all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)),
                "flash backward: non-finite out")
        # the autograd grads are the f32 results cast, leaf by leaf
        cast_err = [(gr.float() - f.transpose(1, 2).to(dtype)
                     .float()).abs().max().item()
                    for gr, f in zip(grads, f32)]
        require(torch.equal(o_fn, o) and all(e == 0.0 for e in cast_err),
                f"flash_attention_train: o equal {torch.equal(o_fn, o)}, "
                f"grads vs f32 results cast, max|err| {cast_err}")
        args = (qt, kt, vt, dot, lse, delta)
        launch = {"flash_bwd_dq": lambda: katt.flash_bwd_dq_cuda(
            *args, **band), "flash_bwd_dkv": lambda:
            katt.flash_bwd_dkv_cuda(*args, **band)}
        ms = {n: time_ms(f, 20, flush) for n, f in launch.items()}
        dev_ms = {n: device_ms(f, 20, flush) for n, f in launch.items()}
        dq_kw = {k: plain_kw[k] for k in ("causal", "window", "block_q",
                                          "block_k", "rounded")}
        bq, bk = plain_kw["dkv_blocks"]
        dkv_kw = dict(dq_kw, block_q=bq, block_k=bk)
        plain = {"flash_bwd_dq": time_ms(lambda: katt.flash_bwd_dq_plain(
            *flat, lse, delta, **dq_kw), 3, flush)[0],
                 "flash_bwd_dkv": time_ms(lambda: katt.flash_bwd_dkv_plain(
            *flat, lse, delta, **dkv_kw), 3, flush)[0]}
    del grads, o_fn, f32, dq_ref, dk_ref, dv_ref, terms
    # the library's yardstick: SDPA's backward alone, one call for the pair
    # (through a padded stride cuDNN's backward refuses the views: then on
    # contiguous copies of the same values)
    dense = (lambda x: x.contiguous()) if pad else (lambda x: x)
    qs, ks, vs = (dense(x).detach().requires_grad_(True)
                  for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                         **band_mask(S, Sk, causal, window))
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (qs, ks, vs), dense(dot), retain_graph=True)
    lib_ms, _ = time_ms(sdpa_bwd, 20, flush)
    lib_dev_ms = device_ms(sdpa_bwd, 20, flush)
    del out, qs, ks, vs
    pairs = B * H * attended_pairs(S, Sk, causal, window)  # unmasked
    inputs = q.element_size() * (q.numel() + k.numel() + v.numel() +
                                 do.numel()) + \
        4 * (lse.numel() + delta.numel())
    rows = []
    plan = {}
    if route == "flash_bwd_d256":
        p = katt.flash_bwd_dkv_plan(B, Hkv, H // Hkv, Sk)
        plan = dict(plan=dict(parts=p.parts, ctas=p.ctas,
                              scratch_mb=p.scratch_bytes / 2 ** 20))
    for name, flops, out_bytes in (
            ("flash_bwd_dq", 6 * D * pairs, 4 * dq.numel()),
            ("flash_bwd_dkv", 8 * D * pairs, 4 * (dk.numel() + dv.numel()))):
        b_ms, b_by = bound(inputs + out_bytes, flops, peak_ops(dtype))
        row = dict(name=name + sfx, route="cuda",
                   source="src/repro_torch/kernels/csrc/flash_bwd.cu",
                   replaces="src/repro/kernels/attention.py:" +
                   ("311" if name == "flash_bwd_dq" else "360"),
                   **close[name], autograd_cast_max_abs_err=cast_err,
                   ms=ms[name][0], ms_spread=ms[name][1],
                   device_ms=dev_ms[name], plain_ms=plain[name],
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_device_ms=lib_dev_ms,
                   library="SDPA backward (" +
                   ("causal, " if causal else "") + "GQA" +
                   (", bool band mask" if window else "") +
                   "), dq+dk+dv in one call",
                   blocks=(plain_kw["block_q"], plain_kw["block_k"])
                   if name == "flash_bwd_dq" else plain_kw["dkv_blocks"],
                   dtype=str(dtype).split(".")[-1],
                   shape=dict(B=B, S=S, Sk=Sk, H=H, Hkv=Hkv, D=D,
                              causal=causal, window=window, pad=pad),
                   **(plan if name == "flash_bwd_dkv" else {}),
                   **({} if arch is None else {"arch": arch}))
        emit("kernel_check", **row)
        rows.append(row)
    return rows


# every flash route at two q / k offset pairs (a ring's per-hop fold): q
# ahead by 384 inside a window of 768 (an earlier shard's keys), and q
# behind by 512 (its first 512 rows see no key)
OFFSET_PAIRS = ((1408, 1024), (0, 512))
OFFSET_SHAPE = dict(B=1, S=1024, H=16, Hkv=4, D=128)
OFFSET_FWD = {"flash_fwd": (OFFSET_SHAPE, torch.bfloat16),
              "flash_fwd_d256": (dict(OFFSET_SHAPE, Hkv=1, D=256),
                                 torch.bfloat16),
              "flash_fwd_simt": (OFFSET_SHAPE, torch.float32)}
OFFSET_BWD = {"flash_bwd": (OFFSET_SHAPE, torch.bfloat16),
              "flash_bwd_d256": (dict(OFFSET_SHAPE, Hkv=1, D=256),
                                 torch.bfloat16),
              "flash_bwd_simt": (OFFSET_SHAPE, torch.float32)}
OFFSET_WINDOW = 768


def check_flash_offsets() -> dict:
    """Each flash route, forward and backward, at ``OFFSET_PAIRS`` against
    its plain version at the route's blocks and the same offsets, with the
    tolerances of ``check_flash`` (forward; lse within 1e-4) and
    ``check_flash_bwd`` (backward: the wgmma pairs against the rounded
    plain version, the CUDA-core pair against the unrounded one).  Rows
    that see no key must drain o = 0, lse = -1e30 and dq = 0.  One
    kernel_check line of records, none a row of the kernels line."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    records = []
    for route, (shape, dt) in OFFSET_FWD.items():
        B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
        qt, kt, vt = flash_inputs(shape, dt, SEED + 7)
        require(katt.flash_fwd_route(qt, kt, vt) == route,
                f"flash_offsets: {shape} {dt} does not take {route}")
        bq, bk = katt.flash_fwd_blocks(route)
        for qo, ko in OFFSET_PAIRS:
            kw = dict(causal=True, window=OFFSET_WINDOW, q_offset=qo,
                      k_offset=ko)
            ops.reset_launches()
            with torch.no_grad():
                o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
                torch.cuda.synchronize()
                n = dict(ops.LAUNCHES)
                o_ref, lse_ref = katt.flash_attention_fwd_plain(
                    qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
                    vt.reshape(B * Hkv, S, D), block_q=bq, block_k=bk, **kw)
            o = o.reshape(B * H, S, D)
            close = (closeness(o, o_ref, atol=2e-3) if dt == torch.bfloat16
                     else closeness_f32(o, o_ref))
            dead = lse_ref == -1e30
            rec = dict(route=route, q_offset=qo, k_offset=ko,
                       dead_rows=int(dead.sum()), **close,
                       lse_max_abs_err=(lse - lse_ref).abs().max().item())
            records.append(rec)
            require(n[route] == 1 and sum(n.values()) == 1,
                    f"flash_offsets: launches {n}, want one {route}")
            require(close["within_tol"] and rec["lse_max_abs_err"] <= 1e-4
                    and (qo >= ko or dead.any())
                    and bool((o[dead] == 0).all())
                    and bool((lse[dead] == -1e30).all()),
                    f"flash_offsets: {route} disagrees: {rec}")
    for route, (shape, dt) in OFFSET_BWD.items():
        B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
        g = torch.Generator(device="cuda").manual_seed(SEED + 8)
        q, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda")
                .to(dt) for _ in range(2))
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        require(katt.flash_bwd_route(qt, kt, vt, dot) == route,
                f"flash_offsets: {dt} does not take {route}")
        keys = tuple(f"flash_bwd_{n}{BWD_SUFFIX[route]}"
                     for n in ("dq", "dkv"))
        close_fn = bwd_closeness(route)
        flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
                vt.reshape(B * Hkv, S, D), dot.reshape(B * H, S, D))
        for qo, ko in OFFSET_PAIRS:
            kw = dict(causal=True, window=OFFSET_WINDOW, q_offset=qo,
                      k_offset=ko)
            with torch.no_grad():
                o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
                delta = (o.float() * dot.float()).sum(-1) \
                    .reshape(B * H, S).contiguous()
                ops.reset_launches()
                got = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse,
                                                    delta, **kw)
                torch.cuda.synchronize()
                n = dict(ops.LAUNCHES)
                plain_kw = dict(kw, **katt.flash_bwd_plain_kw(route))
                want = katt.flash_attention_bwd_plain(*flat, lse, delta,
                                                      **plain_kw)
                terms = ((None,) * 3 if route == "flash_bwd_simt" else
                         katt.flash_bwd_term_max(*flat, lse, delta,
                                                 **plain_kw))
            closes = [close_fn(x.reshape(w.shape), w, t)
                      for x, w, t in zip(got, want, terms)]
            dead = lse == -1e30
            rec = dict(route=route, q_offset=qo, k_offset=ko,
                       dead_rows=int(dead.sum()),
                       **{f"{name}_{key}": c[key]
                          for name, c in zip(("dq", "dk", "dv"), closes)
                          for key in ("max_abs_err", "worst_tol_ratio")},
                       within_tol=all(c["within_tol"] for c in closes))
            records.append(rec)
            require(all(n[key] == 1 for key in keys) and
                    sum(n.values()) == 2,
                    f"flash_offsets: launches {n}, want one of each {keys}")
            require(rec["within_tol"] and
                    bool((got[0].reshape(want[0].shape)[dead] == 0).all()),
                    f"flash_offsets: {route} disagrees: {rec}")
    row = dict(name="flash_offsets", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_fwd.cu, "
                      "src/repro_torch/kernels/csrc/flash_bwd.cu",
               replaces="src/repro/kernels/attention.py:153, 311, 360",
               window=OFFSET_WINDOW, records=records,
               max_abs_err=max(r.get("max_abs_err", 0.0) for r in records),
               within_tol=all(r["within_tol"] for r in records))
    emit("kernel_check", **row)
    return row


PAGED_SHAPE = dict(B=4, H=32, Hkv=8, D=128, page=16, max_pages=128)


# the MoE configs' paged decode shapes (olmoe-1b-7b: 16 kv heads, G 1;
# granite-moe: 8 kv heads, G 3, head_dim 64) at the same slots and view
PAGED_MOE_SHAPES = {"olmoe-1b-7b": dict(PAGED_SHAPE, H=16, Hkv=16),
                    "granite-moe-3b-a800m": dict(PAGED_SHAPE, H=24, D=64)}


def paged_inputs(quant: bool, lens_np: np.ndarray, max_pages: int,
                 seed: int, shape: dict = PAGED_SHAPE) -> tuple:
    """Operands of the paged decode kernel at ``shape`` (default qwen3-4b's
    widths, ``PAGED_SHAPE``; one slot a length of ``lens_np``): q, bf16
    pools or int8 pools with scales (``models.layers.quantize_kv``), each
    slot's pages drawn at random from the pool, unmapped columns on trash
    page 0."""
    from repro_torch.models.layers import quantize_kv
    sh = shape
    B, H, Hkv, D, page = (sh[k] for k in ("B", "H", "Hkv", "D", "page"))
    P = B * max_pages + 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
    table_np = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        n = -(-int(lens_np[b]) // page)
        table_np[b, :n] = perm[b, :n]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(torch.bfloat16)
    kf = torch.randn((P, page, Hkv, D), generator=g, device="cuda")
    vf = torch.randn((P, page, Hkv, D), generator=g, device="cuda")
    if quant:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    table = torch.from_numpy(table_np).to("cuda")
    lens = torch.from_numpy(lens_np.astype(np.int32)).to("cuda")
    return q, k, v, table, lens, ks, vs


def paged_bound(args: tuple, lens_np: np.ndarray) -> tuple[float, str]:
    """The least time of one paged decode call on these lengths: each live
    token's K and V rows (and scales) read once, q and the table read and
    out written once, against the 4 D H flops a token takes."""
    q, k, _, table, lens, ks, _ = args
    _, H, D = q.shape
    Hkv = k.shape[2]
    n_tok = int(lens_np.sum())
    quant = ks is not None
    bytes_ = (2 * n_tok * Hkv * D * k.element_size() +
              (2 * n_tok * Hkv * 4 if quant else 0) + 2 * 2 * q.numel() +
              4 * (table.numel() + lens.numel()))
    return bound(bytes_, 4 * D * H * n_tok, PEAK_INT8 if quant else PEAK_BF16)


def check_paged(quant: bool, flush, shape: dict = PAGED_SHAPE,
                arch: str | None = None) -> dict:
    from repro_torch.kernels import paged_attention as kpa
    sh = shape
    B, H, Hkv, D, page, MP = (sh[k] for k in ("B", "H", "Hkv", "D", "page",
                                              "max_pages"))
    rng = np.random.default_rng(SEED + 1)
    lens_np = rng.integers(1, MP * page + 1, B).astype(np.int32)
    args = paged_inputs(quant, lens_np, MP, SEED + 2, shape)
    # the split plan (shapes only), and the CTAs these lengths keep live
    pps, nsplit = kpa.paged_decode_plan(B, Hkv, MP, page)
    live = Hkv * sum(min(nsplit, -(-int(n) // (pps * page)))
                     for n in lens_np)
    out = kpa.paged_flash_decode_cuda(*args)
    ref = kpa.paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    # kernel and plain version do the same f32 arithmetic (no bf16 p), so
    # only the sum order differs before the output's rounding
    close = closeness(out, ref, atol=1e-4)
    name = "paged_decode_int8" if quant else "paged_decode_bf16"
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite out")
    require(close["within_tol"], f"{name} disagrees: {close}")
    ms, ms_spread = time_ms(lambda: kpa.paged_flash_decode_cuda(*args), 20,
                            flush)
    dev_ms = device_ms(lambda: kpa.paged_flash_decode_cuda(*args), 20, flush)
    plain_ms, _ = time_ms(lambda: kpa.paged_flash_decode_plain(*args), 3,
                          flush)
    b_ms, b_by = paged_bound(args, lens_np)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_attention.py:42",
               **close, ms=ms, ms_spread=ms_spread, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, library_device_ms=None,
               shape=dict(B=B, H=H, Hkv=Hkv, D=D, page=page, max_pages=MP,
                          lengths=lens_np.tolist()),
               plan=dict(pages_per_split=pps, splits=nsplit,
                         ctas=B * Hkv * nsplit, live_ctas=live),
               **({} if arch is None else {"arch": arch}))
    emit("kernel_check", **row)
    return row


# ---------------------------------------------------------------------------
# phases 3 and 3b: the paper's workloads (matmul, conv2d, correlation) and
# dense flash decode, each kernel against its plain version
# ---------------------------------------------------------------------------

# atol of the bf16 comparisons below (besides one bf16 ulp of the value):
# the inputs are scaled so that every output has unit variance, and kernel
# and plain version sum the same f32 products (at most 9,216 of them) in
# two orders, which moves a sum by ~1e-5; 1e-3 leaves 100x room and is
# still 1/100 of what a dropped tap, channel chunk or displacement costs.
# Decode's outputs are means of ~1,500 unit values (~0.04): there, as for
# paged decode, both keep p in f32 and differ by ~1e-7.
PAPER_ATOL = {"matmul": 1e-3, "conv2d": 1e-3, "correlation": 1e-3,
              "flash_decode": 1e-4}
PAPER_SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:21"),
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:25"),
    "correlation": ("src/repro_torch/kernels/csrc/correlation.cu",
                    "src/repro/kernels/correlation.py:25"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/attention.py:577"),
}


def catalog_cases() -> list[dict]:
    """Every workload of the paper's catalog (``repro_torch.sim``) that a
    kernel computes, at the catalog's own shapes and batch 1: the dense
    convolutions (input rows and columns derived for VALID padding from the
    output, kernel, stride and dilation), the two correlations and the two
    GEMMs.  The depthwise MBN_DW_S1 has no kernel (``ops.conv2d`` has no
    groups) and stays with the simulator."""
    from repro_torch.sim import ALL
    cases = []
    for w in ALL:
        d = {x.name: x.size for x in w.op.dims}
        if w.family == "gemm":
            kernel, shapes = "matmul", dict(M=d["i"], N=d["j"], K=d["k"])
            macs = d["i"] * d["j"] * d["k"]
        elif w.family == "spatial":
            D = d["i"]
            kernel = "correlation"
            shapes = dict(H=d["l"], W=d["k"], C=d["m"], radius=(D - 1) // 2)
            macs = D * D * d["l"] * d["k"] * d["m"]
        elif "ci" in d:
            rows = w.op.inputs[0].index_exprs[1]      # y * stride + m * dil
            s, dil = rows.coeff("y"), rows.coeff("m")
            OH, OW, KH, KW = d["y"], d["x"], d["m"], d["n"]
            CI, CO = d["ci"], d["co"]
            kernel = "conv2d"
            shapes = dict(x=(1, (OH - 1) * s + (KH - 1) * dil + 1,
                             (OW - 1) * s + (KW - 1) * dil + 1, CI),
                          w=(KH, KW, CI, CO), stride=s, dilation=dil)
            macs = CO * OH * OW * CI * KH * KW
        else:
            continue
        cases.append(dict(name=w.name, kernel=kernel, shapes=shapes,
                          macs=macs))
    return cases


def decode_case() -> dict:
    """qwen3-4b's decode shape: B 4, 32 q / 8 kv heads, D 128, a dense cache
    of the serve phase's max_len 2048, lengths 1024-1916 from seed 0."""
    lens = np.random.default_rng(SEED).integers(1024, 1917, 4)
    B, H, Hkv, D, S = 4, 32, 8, 128, 2048
    return dict(name="qwen3-4b decode", kernel="flash_decode",
                shapes=dict(B=B, H=H, Hkv=Hkv, D=D, S=S,
                            lengths=[int(x) for x in lens]),
                macs=2 * H * D * int(lens.sum()))


def case_calls(case: dict, seed: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Inputs of one case (numpy, from ``seed``, ``dtype`` on the card,
    scaled so every output has unit variance), and its calls: ``main``
    through ``ops`` as a user calls it, ``launch`` of the kernel alone with
    the same tile (f32: ``main``, the CUDA-core route with the tile ``ops``
    gives it), ``plain`` (the plain version) and ``library`` (one PyTorch
    call of the same function, or None); with the bytes and flops of its
    bound."""
    from repro_torch.core.cuda_bridge import (conv2d_a_tma, conv2d_plan,
                                              correlation_plan, gemv_plan,
                                              matmul_block_shapes)
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import correlation as kcorr
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to("cuda", dtype)

    sh, kind = case["shapes"], case["kernel"]
    if kind == "matmul":
        M, N, K = sh["M"], sh["N"], sh["K"]
        a, b = t((M, K)), t((K, N), K ** -0.5)
        route = kmm.matmul_route(a, b)
        out_numel, in_numel = M * N, M * K + K * N
        if route == "matmul_gemv":
            splits, kchunk = gemv_plan(M, N, K)
            calls = dict(tile=dict(route=route, splits=splits,
                                   kchunk=kchunk),
                         launch=lambda: kmm.matmul_gemv_cuda(a, b),
                         plain=lambda: kmm.matmul_gemv_plain(a, b))
        else:
            bm, bn, bk = matmul_block_shapes(
                M if route == "matmul" else max(M, 8), N, K, route=route)
            launcher = (kmm.matmul_cuda if route == "matmul"
                        else kmm.matmul_simt_cuda)
            calls = dict(tile=dict(route=route, block_m=bm, block_n=bn,
                                   block_k=bk),
                         launch=lambda: launcher(a, b, block_m=bm,
                                                 block_n=bn, block_k=bk),
                         plain=lambda: kmm.matmul_plain(a, b, block_k=bk))
        calls.update(key=route, main=lambda: ops.matmul(a, b),
                     library=lambda: torch.matmul(a, b))
    elif kind == "conv2d":
        (_, IH, IW, CI), (KH, KW, _, CO) = sh["x"], sh["w"]
        s, dil = sh["stride"], sh["dilation"]
        x, w = t(sh["x"]), t(sh["w"], (KH * KW * CI) ** -0.5)
        OH, OW = kconv.out_hw(IH, IW, KH, KW, s, dil)
        route = kconv.conv2d_route(x, w)
        # the plan ops.conv2d takes: pixel tile, channel tile, K split
        plan = conv2d_plan(1, OH, OW, CI, CO, KH, KW, stride=s)
        blocks = dict(block_oh=plan.block_oh, block_ow=plan.block_ow,
                      block_co=plan.block_co, splits=plan.splits)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out_numel, in_numel = OH * OW * CO, x.numel() + w.numel()
        calls = dict(
            key=route,
            tile=dict(route=route, **blocks, k_steps=plan.k_steps,
                      ctas=plan.ctas,
                      a_tma=conv2d_a_tma(CI, s, plan.block_ow),
                      b_tma=CO % 8 == 0),
            main=lambda: ops.conv2d(x, w, stride=s, dilation=dil),
            launch=lambda: kconv.conv2d_cuda(x, w, stride=s, dilation=dil,
                                             **blocks),
            plain=lambda: kconv.conv2d_plain(x, w, stride=s, dilation=dil),
            library=lambda: F.conv2d(x.permute(0, 3, 1, 2), w_cl, stride=s,
                                     dilation=dil))
    elif kind == "correlation":
        H, W, C, R = sh["H"], sh["W"], sh["C"], sh["radius"]
        i1, i2 = t((H, W, C), C ** -0.25), t((H, W, C), C ** -0.25)
        D = 2 * R + 1
        out_numel, in_numel = H * W * D * D, 2 * H * W * C
        # the plan ops.correlation takes: rows, dy group, band, ring; the
        # callers require the wgmma route
        plan = correlation_plan(H, W, C, R)
        route = kcorr.correlation_route(i1, i2, R)
        calls = dict(tile=dict(route=route, **plan._asdict()),
                     launch=lambda: kcorr.correlation_cuda(
                         i1, i2, radius=R, plan=plan))
        calls.update(key=route,
                     main=lambda: ops.correlation(i1, i2, radius=R),
                     plain=lambda: kcorr.correlation_plain(i1, i2, radius=R),
                     library=None)
    else:
        B, H, Hkv, D, S = (sh[k] for k in ("B", "H", "Hkv", "D", "S"))
        q, kc, vc = t((B, H, D)), t((B, Hkv, S, D)), t((B, Hkv, S, D))
        lens = torch.tensor(sh["lengths"], dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :] <
                lens[:, None].long())[:, None, None, :]
        n_tok = sum(sh["lengths"])
        out_numel = in_numel = 0
        bk = katt.decode_block_k(S, 512)          # ops.flash_decode's default
        splits = katt.decode_splits(S, bk)
        live = sum(-(-n // bk) for n in sh["lengths"])
        calls = dict(
            tile=dict(block_k=bk, splits=splits,
                      ctas=B * Hkv * splits, live_ctas=Hkv * live),
            main=lambda: ops.flash_decode(q, kc, vc, lens, block_k=bk),
            launch=lambda: katt.flash_decode_cuda(q, kc, vc, lens,
                                                  block_k=bk),
            plain=lambda: katt.flash_decode_plain(q, kc, vc, lens,
                                                  block_k=bk),
            library=lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
        # the live K/V rows, q and out once each, the lengths
        calls["bytes"] = 2 * (2 * n_tok * Hkv * D + 2 * B * H * D) + 4 * B
    calls.setdefault("key", kind)
    if dtype != torch.bfloat16:
        calls["launch"] = calls["main"]
    if "bytes" not in calls:
        calls["bytes"] = torch.finfo(dtype).bits // 8 * (in_numel +
                                                         out_numel)
    calls["flops"] = 2 * case["macs"]
    return calls


def run_case(case: dict, flush, seed: int, iters: int = 20,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """One case through ``ops`` on the card, with the launch counts reset
    just before and read just after (exactly one launch, of the case's
    route); then its output against the plain version, and the kernel's,
    the plain version's and the library call's times (means over ``iters``
    calls, the plain version 3; ``ms`` as a caller waits for it,
    ``device_ms`` the device work alone: ``time_ms``)."""
    from repro_torch.kernels import ops
    kind = case["kernel"]
    calls = case_calls(case, seed, dtype)
    key = calls["key"]
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.no_grad():
        out = calls["main"]()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        require(launches[key] == 1 and sum(launches.values()) == 1,
                f"{case['name']}: ops.{kind} launched {launches}, want one "
                f"launch of {key}")
        ref = calls["plain"]()
        torch.cuda.synchronize()
        close = (closeness(out, ref, atol=PAPER_ATOL[kind])
                 if dtype == torch.bfloat16 else closeness_f32(out, ref))
        require(bool(torch.isfinite(out).all()),
                f"{case['name']}: non-finite out")
        require(close["within_tol"], f"{case['name']} ({kind}) disagrees: "
                f"{close}")
        ms, ms_spread = time_ms(calls["launch"], iters, flush)
        dev_ms = device_ms(calls["launch"], iters, flush)
        plain_ms, _ = time_ms(calls["plain"], 3, flush)
        lib = calls["library"]
        lib_ms, lib_dev_ms = ((time_ms(lib, iters, flush)[0],
                               device_ms(lib, iters, flush))
                              if lib is not None else (None, None))
    b_ms, b_by = bound(calls["bytes"], calls["flops"], peak_ops(dtype))
    tile = calls["tile"]
    del calls, out, ref
    return dict(workload=case["name"], kernel=kind, key=key,
                shapes=case["shapes"], tile=tile, **close, ms=ms,
                ms_spread=ms_spread, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms,
                kernel_over_library=(ms / lib_ms if lib_ms else None),
                device_over_library=(dev_ms / lib_dev_ms if lib_dev_ms
                                     else None),
                launches=launches)


PAPER_LIBRARY = {"matmul": "torch.matmul (cuBLAS)",
                 "conv2d": "F.conv2d on channels_last tensors (cuDNN)",
                 "correlation": None,
                 "flash_decode": "SDPA with a boolean length mask, GQA"}


def check_paper_kernels(flush, dtype: torch.dtype = torch.bfloat16
                        ) -> list[dict]:
    """The kernel routes of the paper-workload path against their plain
    versions: the matmul's wgmma route at GEMM_1K and its GEMV route at
    GEMM_FC, conv2d's wgmma route at DL_ATROUS4, correlation's wgmma route
    at FLOWNET_CORR, flash decode at qwen3-4b's decode shape.  In f32 the
    CUDA-core routes of the first three at GEMM_1K, DL_ATROUS4 and
    FLOWNET_CORR.  Each row is named by its launch key."""
    by = {c["name"]: c for c in catalog_cases()}
    bf16 = dtype == torch.bfloat16
    cases = ((by["GEMM_1K"], by["GEMM_FC"], by["DL_ATROUS4"],
              by["FLOWNET_CORR"], decode_case()) if bf16 else
             (by["GEMM_1K"], by["DL_ATROUS4"], by["FLOWNET_CORR"]))
    rows = []
    for i, case in enumerate(cases):
        r = run_case(case, flush, SEED + 20 + i, dtype=dtype)
        # bf16: the correlation must take its wgmma route (the matmul's
        # route depends on M); f32: every case the CUDA-core route
        want = case["kernel"] if bf16 else f"{case['kernel']}_simt"
        require(r["key"] == want or (bf16 and case["kernel"] != "correlation"),
                f"{case['name']} ({dtype}) took route {r['key']}, not "
                f"{want}")
        source, replaces = PAPER_SOURCES[case["kernel"]]
        row = dict(name=r["key"], route="cuda", source=source,
                   replaces=replaces, workload=case["name"],
                   library=PAPER_LIBRARY[case["kernel"]],
                   dtype=str(dtype).split(".")[-1],
                   **{k: v for k, v in r.items()
                      if k not in ("workload", "kernel", "key", "launches")})
        emit("kernel_check", **row)
        rows.append(row)
    return rows


# the launch keys of the paper-workload path: the matmul's wgmma and GEMV
# routes (GEMM_1K, GEMM_FC), conv2d's wgmma route, correlation, dense decode
PAPER_KEYS = ("matmul", "matmul_gemv", "conv2d", "correlation",
              "flash_decode")


def paper_workloads(flush) -> dict:
    """Phase 3b: the 24 catalog workloads and qwen3-4b's decode shape
    through ``ops`` on the card, one line each (with the route and tile of
    each matmul, the tile, CTAs and K split of each conv, the splits of
    the decode, the plan of each correlation); every kernel route of the
    path must have launched, all 20 convs and both correlations on their
    wgmma routes."""
    cases = catalog_cases() + [decode_case()]
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    for i, case in enumerate(cases):
        row = run_case(case, flush, SEED + 100 + i)
        emit("paper_workload", **row)
        for k, n in row["launches"].items():
            total[k] = total.get(k, 0) + n
    emit("paper_workloads", workloads=len(cases), launches=total,
         seconds=time.perf_counter() - t0)
    for k in PAPER_KEYS:
        require(total.get(k, 0) > 0, f"paper_workloads never launched {k}")
    n_conv = sum(c["kernel"] == "conv2d" for c in cases)
    require(n_conv == 20 and total.get("conv2d") == n_conv and
            total.get("conv2d_simt", 0) == 0,
            f"paper_workloads: {n_conv} convs launched conv2d "
            f"{total.get('conv2d')} and conv2d_simt "
            f"{total.get('conv2d_simt', 0)} times, want 20 and 0")
    n_corr = sum(c["kernel"] == "correlation" for c in cases)
    require(n_corr == 2 and total.get("correlation") == n_corr and
            total.get("correlation_simt", 0) == 0,
            f"paper_workloads: {n_corr} correlations launched correlation "
            f"{total.get('correlation')} and correlation_simt "
            f"{total.get('correlation_simt', 0)} times, want 2 and 0")
    return total


# GEMM_FC's N and K (AlexNet's fc6) at the batch sizes below one 64-row tile
SKINNY_M = (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32, 48, 63)


def skinny_matmuls(flush) -> list[dict]:
    """Phase 3c: bf16 M < 64 at GEMM_FC's N 4096 and K 9216, each M on both
    kernels that can take it: the split-K GEMV and the wgmma kernel at the
    tile search's tile, each launched once with the counts reset and held
    against its plain version, with host-inclusive and device-only times
    beside ``torch.matmul``'s; and ``ops.matmul`` on the route
    ``matmul_route`` gives the M (the GEMV only at M <= ``GEMV_MAX_M``).
    One line per M: the readings behind that cut."""
    from repro_torch.core.cuda_bridge import gemv_plan, matmul_block_shapes
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    N, K = 4096, 9216
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    rows = []
    for M in SKINNY_M:
        a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        b = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5) \
            .to(torch.bfloat16)
        bm, bn, bk = matmul_block_shapes(M, N, K, route="matmul")
        runs = {
            "matmul_gemv": (lambda: kmm.matmul_gemv_cuda(a, b),
                            lambda: kmm.matmul_gemv_plain(a, b),
                            dict(zip(("splits", "kchunk"),
                                     gemv_plan(M, N, K)))),
            "matmul": (lambda: kmm.matmul_cuda(a, b, block_m=bm, block_n=bn,
                                               block_k=bk),
                       lambda: kmm.matmul_plain(a, b, block_k=bk),
                       dict(block_m=bm, block_n=bn, block_k=bk))}
        route = kmm.matmul_route(a, b)
        row = dict(M=M, N=N, K=K, route=route)
        with torch.no_grad():
            for key, (launch, plain, tile) in runs.items():
                ops.reset_launches()
                out = launch()
                torch.cuda.synchronize()
                launched = {k: n for k, n in ops.LAUNCHES.items() if n}
                require(launched == {key: 1}, f"skinny M {M}: launched "
                        f"{launched}, want one launch of {key}")
                close = closeness(out, plain(), atol=PAPER_ATOL["matmul"])
                require(close["within_tol"], f"skinny M {M} ({key}) "
                        f"disagrees: {close}")
                ms, spread = time_ms(launch, 20, flush)
                row[key] = dict(tile, ms=ms, ms_spread=spread,
                                device_ms=device_ms(launch, 20, flush),
                                worst_tol_ratio=close["worst_tol_ratio"])
            ops.reset_launches()
            ops.matmul(a, b)
            torch.cuda.synchronize()
            launched = {k: n for k, n in ops.LAUNCHES.items() if n}
            require(route in runs and launched == {route: 1},
                    f"skinny M {M}: ops.matmul launched {launched}, its "
                    f"route is {route}")
            lib = lambda: torch.matmul(a, b)  # noqa: E731
            row.update(library_ms=time_ms(lib, 20, flush)[0],
                       library_device_ms=device_ms(lib, 20, flush))
        row["bound_ms"], row["bound_by"] = bound(
            2 * (M * K + K * N + M * N), 2 * M * N * K, PEAK_BF16)
        emit("skinny_matmul", **row)
        rows.append(row)
        del a, b
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve qwen3-4b at full width
# ---------------------------------------------------------------------------

class FiniteWatch:
    """Forwards to the engine's bundle and keeps, on the device, whether
    every logit its serving steps returned was finite."""

    def __init__(self, bundle):
        self._bundle = bundle
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self._bundle, name)

    def _watch(self, out):
        self.finite &= torch.isfinite(out[0]).all()
        self.steps += 1
        return out

    def prefill(self, *a, **kw):
        return self._watch(self._bundle.prefill(*a, **kw))

    def decode_step(self, *a, **kw):
        return self._watch(self._bundle.decode_step(*a, **kw))

    def paged_step(self, *a, **kw):
        return self._watch(self._bundle.paged_step(*a, **kw))


def prompts(n: int, lo: int, hi: int, seed: int, vocab: int,
            share: float = 0.0) -> list[np.ndarray]:
    """``n`` random prompts of lengths in [lo, hi] over ids below
    ``vocab`` (the config's: an id past the embedding is an out-of-bounds
    gather on the card); a ``share`` fraction of them start with one
    common prefix of lo // 2 tokens."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, lo // 2)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        if share > 0 and i % max(1, round(1 / share)) == 0:
            p[:len(common)] = common
        out.append(p.astype(np.int32))
    return out


def workload(mode: str, vocab: int) -> tuple[list[np.ndarray], dict]:
    """The serve phase's requests and engine settings for one KV mode:
    dense takes 4 long prompts (the flash kernel's prefill path), the
    paged modes 8 shorter ones over 4 slots, half sharing a prefix."""
    if mode == "dense":
        return (prompts(4, 1024, 1900, SEED + 3, vocab),
                dict(max_new=16, slots=4))
    return (prompts(8, 256, 1024, SEED + 4, vocab, share=0.5),
            dict(max_new=32, slots=4, page_size=16, prefill_chunk=256,
                 prefill_token_budget=1024))


class DropWatch:
    """Counts, on the card, the MoE assignments the expert capacity drops:
    wraps ``models.layers._moe_slots`` while it is entered and sums its
    ``keep`` per call (two small launches a layer, no host read).  A call
    of ``slots`` rows is a decode tick (one token a row, idle slots
    included), any other a prefill."""

    def __init__(self, slots: int):
        from repro_torch.models import layers
        self._layers, self._slots_fn, self.slots = layers, None, slots
        self.kept = {k: torch.zeros((), dtype=torch.long, device="cuda")
                     for k in ("decode", "prefill")}
        self.total = {"decode": 0, "prefill": 0}

    def __enter__(self):
        self._slots_fn = inner = self._layers._moe_slots

        def counted(gate_idx, E, C):
            pos, keep = inner(gate_idx, E, C)
            kind = "decode" if gate_idx.shape[0] == self.slots else "prefill"
            self.kept[kind] += keep.sum()
            self.total[kind] += keep.numel()
            return pos, keep
        self._layers._moe_slots = counted
        return self

    def __exit__(self, *exc):
        self._layers._moe_slots = self._slots_fn

    def shares(self) -> dict:
        out = {}
        for k, n in self.total.items():
            dropped = n - int(self.kept[k].item())
            out[k] = dict(assignments=n, dropped=dropped,
                          dropped_share=dropped / n if n else None)
        return out


def serve(mode: str, params, arch: str = ARCH) -> dict:
    """Serve ``workload(mode)`` at ``arch``'s full width; for a MoE config
    the row also gives the share of assignments the capacity dropped."""
    import contextlib

    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    cfg = get_bundle(arch).cfg
    reqs, kw = workload(mode, cfg.vocab)
    max_new = kw["max_new"]
    engine, _ = build_engine(arch, smoke=False, max_len=2048, kv_mode=mode,
                             params=params, device="cuda", **kw)
    watch = FiniteWatch(engine.bundle)
    engine.bundle = watch
    drops = DropWatch(engine.cfg.batch) if cfg.moe else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with drops or contextlib.nullcontext():
        for p in reqs:
            engine.submit(p)
        results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_tok = sum(len(v) for v in results.values())
    require(sorted(results) == list(range(len(reqs))),
            f"{mode}: {len(results)} of {len(reqs)} requests completed")
    require(all(len(v) == max_new for v in results.values()) and
            all(o == "ok" for o in engine.outcomes.values()),
            f"{mode}: a request ended short of {max_new} tokens")
    require(bool(watch.finite.item()), f"{mode}: non-finite logits")
    row = dict(arch=arch, mode=mode, requests=len(reqs),
               slots=engine.cfg.batch,
               prompt_tokens=int(sum(len(p) for p in reqs)),
               generated_tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               steps=watch.steps, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               kv=engine.kv_stats(), prefix=engine.prefix_stats())
    if drops is not None:
        row["moe_capacity_drops"] = drops.shares()
    emit("serve_moe" if cfg.moe else "serve", **row)
    del engine, watch
    torch.cuda.empty_cache()
    return {"row": row, "results": results, "launches": launches}


def agreement(a: dict, b: dict) -> float:
    same = total = 0
    for rid in a:
        x, y = a[rid], b[rid]
        same += sum(int(i == j) for i, j in zip(x, y))
        total += max(len(x), len(y))
    return same / max(1, total)


def logits_check(params, arch: str = ARCH, n: int = 1536,
                 top1: bool = False) -> dict:
    """Full-width prefill logits of one ``n``-token prompt (after a VLM's
    zero vision prefix, beside an audio model's zero frames, as served)
    through the flash kernel against the plain attention path (the
    reference's XLA path): bf16 at full width is not bit-stable across
    attention paths, so this asserts a cosine similarity, not equality,
    and with ``top1`` the same top token."""
    import dataclasses

    from repro_torch.configs import get_bundle
    bundle = get_bundle(arch)
    tok = torch.from_numpy(prompts(1, n, n, SEED + 9,
                                   bundle.cfg.vocab)[0][None]) \
        .long().to("cuda")
    extras = bundle.zero_extras(1, bundle.cfg.dtype, "cuda") or None
    max_len = n + getattr(bundle.cfg, "vision_tokens", 0)
    out = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            b = dataclasses.replace(bundle, cfg=dataclasses.replace(
                bundle.cfg, attn_impl=impl))
            cache = b.init_cache(1, max_len, device="cuda")
            logits, _ = b.prefill(params, tok, cache, batch_extras=extras)
            out[impl] = logits.float().flatten()
            del cache
    a, b = out["pallas"], out["xla"]
    cos = F.cosine_similarity(a, b, dim=0).item()
    row = dict(arch=arch, prompt=n, cosine=cos,
               max_abs_diff=(a - b).abs().max().item(),
               top1_equal=bool(a.argmax() == b.argmax()),
               finite=bool(torch.isfinite(a).all()))
    emit("logits_check", **row)
    require(row["finite"] and cos > 0.99,
            f"flash vs plain prefill logits: cosine {cos}")
    require(row["top1_equal"] or not top1,
            f"{arch}: flash vs plain prefill top-1 differs: {row}")
    return row


def paged_step_check(params, arch: str = ARCH) -> list[dict]:
    """One full-width T = 1 ``paged_step`` over bf16 and int8 pools that a
    prefill step of 4 prompts (256-1024 tokens) filled, through the paged
    kernel (``attn_impl="pallas"``) and through the plain gather path
    (``"xla"``), in that order, on the same pool (the step writes the same
    new K/V either way): bf16 at full width is not bit-stable across
    attention paths, so this asserts a cosine similarity of the logits, as
    ``logits_check`` does, and that only the kernel path launched the
    kernel, once a layer."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    bundle = get_bundle(arch)
    L, page = bundle.cfg.n_layers, 16
    reqs = prompts(4, 256, 1024, SEED + 12, bundle.cfg.vocab)
    B, T = len(reqs), max(len(p) for p in reqs)
    MP = 1 << (-(-(T + 1) // page) - 1).bit_length()   # the engine's view
    table = (1 + torch.arange(B * MP, dtype=torch.int32, device="cuda")
             .reshape(B, MP))
    tok = torch.zeros((B, T), dtype=torch.long, device="cuda")
    for b, p in enumerate(reqs):
        tok[b, :len(p)] = torch.from_numpy(p).long()
    counts = torch.tensor([len(p) for p in reqs], dtype=torch.int32,
                          device="cuda")
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
    rows = []
    for kv in ("bf16", "int8"):
        pool = bundle.family.init_paged_pool(
            bundle.cfg, 1 + B * MP, page,
            kv_dtype=torch.int8 if kv == "int8" else None, device="cuda")
        with torch.no_grad():
            logits, pool, lengths = bundle.family.paged_step(
                bundle.cfg, params, tok, pool, table, zeros, counts)
            nxt = logits[torch.arange(B), counts.long() - 1].argmax(-1)
            out, launches = {}, {}
            for impl in ("pallas", "xla"):
                cfg = dataclasses.replace(bundle.cfg, attn_impl=impl)
                ops.reset_launches()
                lg, _, _ = bundle.family.paged_step(
                    cfg, params, nxt[:, None], pool, table, lengths,
                    torch.ones_like(counts))
                torch.cuda.synchronize()
                out[impl] = lg.float().flatten()
                launches[impl] = dict(ops.LAUNCHES)
        del pool, logits
        a, b = out["pallas"], out["xla"]
        key = f"paged_decode_{kv}"
        cos = F.cosine_similarity(a, b, dim=0).item()
        row = dict(arch=arch, kv=kv, slots=B, max_pages=MP,
                   lengths=[len(p) for p in reqs], cosine=cos,
                   max_abs_diff=(a - b).abs().max().item(),
                   top1_equal=bool((a.reshape(B, -1).argmax(-1) ==
                                    b.reshape(B, -1).argmax(-1)).all()),
                   finite=bool(torch.isfinite(a).all()),
                   launches_kernel_path=launches["pallas"][key],
                   launches_plain_path=launches["xla"][key])
        emit("paged_step_check", **row)
        require(row["finite"] and cos > 0.99,
                f"paged kernel vs plain paged step logits ({kv}): {row}")
        require(row["launches_kernel_path"] == L and
                row["launches_plain_path"] == 0,
                f"paged_step_check ({kv}): {key} launches {row}, want "
                f"{L} on the kernel path and 0 on the plain one")
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4a: the serving fleet at full width (three hosts, page migration)
# ---------------------------------------------------------------------------

FLEET_HOSTS = 3
# full width: qwen3-4b's weights, 2 slots a host, page 16; 8 prompts of
# 256-1024 tokens, the even ones a common 512-token (32-page) prefix and a
# random suffix, 32 new tokens each, in two waves of 4
# (wave 1 drains at fleet tick 35, wave 2 at 70: scheduling alone sets the
# ticks, so the die drill's tick 40 falls in wave 2, after wave 1 published
# its pages, with a wave-2 request in flight on host 0)
FLEET_FULL = dict(slots=2, page=16, max_len=2048, lo=256, hi=1024,
                  prefix=512, n=8, max_new=32, prefill_chunk=256,
                  prefill_token_budget=1024, die_tick=40)
# (name, kv mode, chaos specs): each drill's fault and where it shows
FLEET_SCENARIOS = (
    ("migrate", "paged", ()),
    ("migrate_int8", "paged_int8", ()),
    ("die", "paged", ("die@{die_tick}:host=0",)),
    ("netsplit", "paged", ("netsplit@1:host=1,duration=1000000",)),
    ("pagecorrupt", "paged", ("pagecorrupt@1",)),
)


def fleet_workload(vocab: int, size: dict, seed: int = SEED + 4
                   ) -> list[np.ndarray]:
    """``size["n"]`` prompts: the odd ones ``lo``-``hi`` random tokens, the
    even ones one common ``prefix``-token prefix followed by a random
    suffix, ``prefix + lo // 4`` to ``hi`` tokens in all."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size["prefix"])
    out = []
    for i in range(size["n"]):
        if i % 2:
            p = rng.integers(0, vocab, int(rng.integers(size["lo"],
                                                        size["hi"] + 1)))
        else:
            n = int(rng.integers(size["prefix"] + size["lo"] // 4,
                                 size["hi"] + 1))
            p = np.concatenate([common, rng.integers(0, vocab,
                                                     n - size["prefix"])])
        out.append(p.astype(np.int32))
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality of two tensors of one dtype (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int).cpu(),
                       b.contiguous().view(as_int).cpu())


class MigrationWatch:
    """Wraps a fleet's migration path on its instances: times each
    ``_migrate`` that moved pages (export, frames, exchange, import; the
    device synchronised on both sides), and holds every page a target
    adopted, as its pool now holds it, against the source's exported page,
    bit for bit, for every pool entry."""

    def __init__(self, fleet):
        self.timed: list[tuple[float, int]] = []     # (seconds, pages)
        self.exported: dict[tuple, dict] = {}
        self.checked = self.equal = 0
        inner = fleet._migrate

        def migrate(fl, match, target):
            torch.cuda.synchronize()
            t0, before = time.perf_counter(), fleet.migrated_pages
            inner(fl, match, target)
            torch.cuda.synchronize()
            if fleet.migrated_pages > before:
                self.timed.append((time.perf_counter() - t0,
                                   fleet.migrated_pages - before))
        fleet._migrate = migrate
        for eng in fleet.engines:
            self._wrap(eng)

    def _wrap(self, eng) -> None:
        export, imp = eng.export_prefix_pages, eng.import_prefix_pages

        def exported(tokens, n_tokens):
            out = export(tokens, n_tokens)
            for seg, vals in out:
                self.exported[tuple(int(t) for t in seg)] = vals
            return out

        def imported(segments):
            adopted, adopt = [], eng.prefix.adopt_segment

            def adopt_segment(node, seg, page):
                adopted.append((seg, page))
                return adopt(node, seg, page)
            eng.prefix.adopt_segment = adopt_segment
            try:
                n = imp(segments)
            finally:
                del eng.prefix.adopt_segment
            for seg, page in adopted:
                src = self.exported[tuple(seg)]
                self.checked += 1
                self.equal += all(same_bits(v[:, page], src[k])
                                  for k, v in eng.pool.items())
            return n
        eng.export_prefix_pages = exported
        eng.import_prefix_pages = imported

    def row(self) -> dict:
        secs = sum(t for t, _ in self.timed)
        pages = sum(n for _, n in self.timed)
        return dict(migrations_timed=len(self.timed), pages_timed=pages,
                    migration_ms=[t * 1e3 for t, _ in self.timed],
                    migration_ms_per_page=secs * 1e3 / pages if pages
                    else None,
                    pages_checked=self.checked, pages_bit_equal=self.equal)


def serve_waves(target, reqs: list[np.ndarray], settle: int | None = None
                ) -> list[int]:
    """Submit ``reqs`` in two waves (the second after the first has
    drained, or after ``settle`` ticks) and drain; a fleet or an engine."""
    half = len(reqs) // 2
    rids = [target.submit(p) for p in reqs[:half]]
    if settle is None:
        target.run()
    else:
        for _ in range(settle):
            target.step()
    rids += [target.submit(p) for p in reqs[half:]]
    target.run()
    return rids


def fleet_drill(name: str, kv_mode: str, specs, params, bundle,
                size: dict) -> dict:
    """One chaos drill: ``FLEET_HOSTS`` paged hosts sharing ``params``
    behind round-robin placement serve ``fleet_workload`` in two waves
    under ``specs``; every request must finish to its token count with
    finite logits, every adopted page must equal its source page, and the
    drill's fault must show in the injector's log and the fleet's
    counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_fleet
    from repro_torch.obs import Telemetry
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.runtime.chaos import ChaosInjector
    from repro_torch.serving import FleetConfig
    specs = [sp.format(**size) for sp in specs]
    chaos = ChaosInjector(specs, seed=SEED)
    reg = MetricsRegistry()
    fleet, vocab = build_fleet(
        bundle, FLEET_HOSTS, slots=size["slots"],
        max_len=size["max_len"], max_new=size["max_new"], kv_mode=kv_mode,
        page_size=size["page"], prefill_chunk=size["prefill_chunk"],
        prefill_token_budget=size["prefill_token_budget"], params=params,
        device="cuda", fleet_cfg=FleetConfig(placement="round_robin",
                                              seed=SEED),
        chaos=chaos, telemetry=Telemetry(enabled=False, registry=reg))
    watch = FiniteWatch(fleet.engines[0].bundle)
    for eng in fleet.engines:
        eng.bundle = watch
    mig = MigrationWatch(fleet)
    reqs = fleet_workload(vocab, size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = serve_waves(fleet, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    fleet.telemetry()
    snap, st = reg.snapshot(), fleet.stats()
    results = {i: fleet.results[r] for i, r in enumerate(rids)}
    n_tok = sum(len(v) for v in results.values())
    hist = snap["histograms"].get("fleet_migration_s")
    row = dict(arch=bundle.arch_id, n_layers=bundle.cfg.n_layers,
               scenario=name, kv_mode=kv_mode, chaos=specs,
               fired=list(chaos.fired), hosts=FLEET_HOSTS,
               slots=size["slots"], page=size["page"], requests=len(reqs),
               prompt_tokens=int(sum(len(p) for p in reqs)),
               generated_tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               outcomes=st["outcomes"], ticks=st["ticks"],
               deaths=st["deaths"], retries=st["retries"],
               tombstones=st["directory"]["tombstoned_pages"],
               hedges=st["hedges"], migrations=st["migrations"],
               migrated_pages=st["migrated_pages"],
               page_exchange_bytes=st["page_exchange_bytes"],
               directory=st["directory"], launches=launches,
               fleet_migration_s=hist,
               counters={k: v for k, v in snap["counters"].items()
                         if k.startswith(("fleet", "page_exchange"))},
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               **mig.row())
    emit("serve_fleet", **row)
    require(sorted(results) == list(range(len(reqs))) and
            all(fleet.outcomes[r] == "ok" for r in rids) and
            all(len(v) == size["max_new"] for v in results.values()),
            f"serve_fleet {name}: a request did not finish to "
            f"{size['max_new']} tokens: {st['outcomes']}")
    require(bool(watch.finite.item()), f"serve_fleet {name}: non-finite "
            "logits")
    require(mig.checked == mig.equal,
            f"serve_fleet {name}: {mig.checked - mig.equal} of "
            f"{mig.checked} migrated pages differ from the source's")
    key = "paged_decode_int8" if kv_mode == "paged_int8" \
        else "paged_decode_bf16"
    require(launches.get(key, 0) > 0,
            f"serve_fleet {name}: the decode ticks never launched {key}")
    c = row["counters"]
    if name.startswith("migrate"):
        require(st["migrations"]["ok"] >= 1 and mig.checked >= 1 and
                c.get("fleet_migrations{outcome=ok}", 0) >= 1 and
                c.get("page_exchange_bytes", 0) > 0,
                f"serve_fleet {name}: no page migrated: {st}")
    elif name == "die":
        require(specs[0] in chaos.fired and st["deaths"] == 1 and
                st["retries"] >= 1 and c.get("fleet_deaths", 0) == 1 and
                c.get("fleet_retries", 0) >= 1 and
                c.get("fleet_tombstones", 0) >= 1,
                f"serve_fleet die: the fault did not fire: {row['fired']}, "
                f"{st}")
    elif name == "netsplit":
        require(any(f.startswith("netsplit@1") for f in chaos.fired) and
                st["migrations"]["timeout"] >= 1 and
                c.get("fleet_migrations{outcome=timeout}", 0) >= 1,
                f"serve_fleet netsplit: the fault did not fire: {st}")
    elif name == "pagecorrupt":
        require("pagecorrupt@1" in chaos.fired and
                st["migrations"]["corrupt"] >= 1 and
                c.get("fleet_migrations{outcome=corrupt}", 0) >= 1,
                f"serve_fleet pagecorrupt: the fault did not fire: {st}")
    # the watch's wrappers close over the engines: collect the cycles so
    # the next drill's peak starts from the same resident bytes
    del fleet, watch, mig
    gc.collect()
    return {"row": row, "results": results, "launches": launches}


def one_engine(params, bundle, kv_mode: str, size: dict):
    """One host of the fleet's drills, alone."""
    from repro_torch.launch.serve import build_engine
    engine, vocab = build_engine(
        bundle, slots=size["slots"],
        max_len=size["max_len"], max_new=size["max_new"], kv_mode=kv_mode,
        page_size=size["page"], prefill_chunk=size["prefill_chunk"],
        prefill_token_budget=size["prefill_token_budget"], params=params,
        device="cuda")
    return engine, vocab


def token_logits(engine, prompt: np.ndarray, n: int) -> list[torch.Tensor]:
    """Serve ``prompt`` alone on ``engine`` until it has ``n`` tokens and
    return the logit row each token was picked from (the end of its
    prefill, then its decode steps)."""
    calls, inner = [], engine._exec_step

    def record(tokens, counts, mp):
        rows, picked = inner(tokens, counts, mp)
        calls.append((rows, counts.copy()))
        return rows, picked
    engine._exec_step = record
    rid, out = engine.submit(prompt), []
    try:
        while len(out) < n:
            before = len(engine._partial_output(rid))
            engine.step()
            if len(engine._partial_output(rid)) > before:
                rows, counts = calls[-1]
                out.append(rows[int(np.flatnonzero(counts)[0])].float())
    finally:
        del engine._exec_step
    return out


def migrated_logits_check(params, bundle, kv_mode: str, size: dict
                          ) -> dict:
    """A prefix's pages exported from one engine, framed, sent over the
    page exchange and imported into a second: the second serves another
    prompt of that prefix from the migrated pages, and its first two
    tokens' logits (the prefill's end over the migrated KV, then one
    decode step through the paged kernel) are held against a third engine
    that prefilled the whole prompt itself, by cosine, as ``logits_check``
    does; the adopted pages must equal the exported ones bit for bit."""
    from repro_torch.runtime.fleet import (LocalPageExchange,
                                           encode_page_frame)
    src, vocab = one_engine(params, bundle, kv_mode, size)
    dst, _ = one_engine(params, bundle, kv_mode, size)
    ref, _ = one_engine(params, bundle, kv_mode, size)
    p0, _, p1 = fleet_workload(vocab, size)[:3]
    src.submit(p0)
    src.run()
    exported = src.export_prefix_pages(p0, size["prefix"])
    frames = [encode_page_frame(t, a) for t, a in exported]
    decoded = LocalPageExchange().transfer(0, 1, frames)
    require(dst.import_prefix_pages(decoded) == size["prefix"],
            f"migrated_logits_check: import of {size['prefix']} tokens")
    pages = [n.page for n in dst.prefix.path_nodes(p0, size["prefix"])]
    equal = all(same_bits(dst.pool[k][:, pg], vals[k])
                for pg, (_, vals) in zip(pages, exported)
                for k in dst.pool)
    got = token_logits(dst, p1, 2)
    want = token_logits(ref, p1, 2)
    cos = [F.cosine_similarity(a, b, dim=0).item()
           for a, b in zip(got, want)]
    row = dict(arch=bundle.arch_id, n_layers=bundle.cfg.n_layers,
               kv_mode=kv_mode, prefix=size["prefix"],
               pages=len(exported), frame_bytes=sum(len(f) for f in frames),
               pages_bit_equal=equal,
               matched_tokens=dst.prefix_stats()["matched_tokens"],
               cosine_prefill=cos[0], cosine_decode=cos[1],
               max_abs_diff=[(a - b).abs().max().item()
                             for a, b in zip(got, want)],
               top1_equal=[bool(a.argmax() == b.argmax())
                           for a, b in zip(got, want)],
               finite=all(bool(torch.isfinite(a).all()) for a in got))
    emit("fleet_logits_check", **row)
    require(equal and len(exported) == size["prefix"] // size["page"],
            f"migrated_logits_check ({kv_mode}): pages {row}")
    require(row["finite"] and min(cos) > 0.99 and
            row["matched_tokens"] >= size["prefix"],
            f"migrated vs recomputed logits ({kv_mode}): {row}")
    return row


def prefix_prefill_ms(params, bundle, size: dict) -> list[float]:
    """Time to the first token of the common prefix plus one token on one
    paged engine with nothing cached (what a recompute costs in place of
    a migration), twice on fresh state; ms, device synchronised."""
    engine, vocab = one_engine(params, bundle, "paged", size)
    prompt = fleet_workload(vocab, size)[0][:size["prefix"] + 1]
    out = []
    for _ in range(2):
        engine.reset_serving_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        token_logits(engine, prompt, 1)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def supervised_drill() -> dict:
    """``python -m repro_torch.launch.serve --fleet 2`` with ``die@2`` on
    worker 1, at the launcher's smoke width: it must exit 0, serve 4 of 4,
    and worker 1 must have exited 43 and then 0."""
    import os
    fleet_dir = ROOT / "build" / "serve_fleet_drill"
    shutil.rmtree(fleet_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--fleet", "2", "--requests", "4", "--kv-mode", "paged",
           "--page-size", "8", "--slots", "2", "--max-new", "4",
           "--prefix-share", "0.5", "--chaos", "die@2:host=1",
           "--fleet-dir", str(fleet_dir), "--max-wall-s", "300"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=400)
    wall = time.perf_counter() - t0
    try:
        report = json.loads((fleet_dir / "report.json").read_text())
    except (OSError, ValueError):
        report = {}
    hist = {w["tag"]: w["exit_history"] for w in report.get("workers", ())}
    devices, merged = set(), {}
    for tag in range(2):
        try:
            res = json.loads((fleet_dir / "results" /
                              f"rank_{tag}.json").read_text())
        except (OSError, ValueError):
            continue
        devices.add(res.get("device"))
        merged.update(res.get("results", {}))
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve-fleet]")]
    row = dict(cmd=" ".join(cmd[1:]), rc=out.returncode, wall_s=wall,
               summary=line[-1] if line else None,
               outcome=report.get("outcome"),
               total_failures=report.get("total_failures"),
               exit_history=hist, devices=sorted(map(str, devices)),
               served=len(merged),
               tokens_each=sorted({len(v) for v in merged.values()}))
    emit("serve_fleet_supervised", **row)
    require(out.returncode == 0 and row["summary"] is not None and
            "outcome=completed" in row["summary"] and
            "served=4/4" in row["summary"] and hist.get(1) == [43, 0] and
            row["tokens_each"] == [4],
            f"serve --fleet 2 drill: {row}; stderr "
            f"{out.stderr[-2000:]}")
    return row


def serve_fleet(params, bundle=None, size: dict = FLEET_FULL,
                drill: bool = True) -> dict:
    """The serving fleet on the card: the migrated-page logits check in
    bf16 and int8, the prefix's prefill time on one engine, each drill of
    ``FLEET_SCENARIOS`` beside one engine serving the same two waves
    (token agreement printed, not required: bf16 GEMMs may pick kernels by
    the batch's rows), then (``drill``) the supervised ``--fleet 2``
    drill.  ``bundle``: qwen3-4b's full-width bundle unless given (one cut
    in depth, say).  -> the drills' launches, summed."""
    from repro_torch.configs import get_bundle
    bundle = bundle or get_bundle(ARCH)
    with torch.no_grad():
        checks = {m: migrated_logits_check(params, bundle, m, size)
                  for m in ("paged", "paged_int8")}
        prefill = prefix_prefill_ms(params, bundle, size)
        base = {}
        for m in ("paged", "paged_int8"):
            engine, vocab = one_engine(params, bundle, m, size)
            rids = serve_waves(engine, fleet_workload(vocab, size))
            base[m] = {i: engine.results[r] for i, r in enumerate(rids)}
            del engine
        runs = [fleet_drill(name, mode, specs, params, bundle, size)
                for name, mode, specs in FLEET_SCENARIOS]
    ok = next(r["row"] for r in runs if r["row"]["scenario"] == "migrate")
    emit("serve_fleet_summary", arch=bundle.arch_id,
         migration_ms_per_page=ok["migration_ms_per_page"],
         migration_ms=ok["migration_ms"],
         prefix_prefill_ms=prefill, prefix_tokens=size["prefix"],
         frame_bytes_per_page={m: c["frame_bytes"] / c["pages"]
                               for m, c in checks.items()},
         agreement={r["row"]["scenario"]: agreement(
             r["results"], base[r["row"]["kv_mode"]]) for r in runs})
    if drill:
        supervised_drill()
    launches: dict[str, int] = {}
    for r in runs:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4b: serve olmoe-1b-7b (MoE) at full width
# ---------------------------------------------------------------------------

MODES = ("dense", "paged", "paged_int8")
# the launch key each mode's serve run must reach: the flash forward on the
# dense prefill, the paged kernel on the paged decode ticks
MODE_KEYS = {"dense": "flash_fwd", "paged": "paged_decode_bf16",
             "paged_int8": "paged_decode_int8"}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()


def init_params(arch: str) -> dict:
    """``arch``'s full-width random bf16 weights from ``SEED`` on the
    card, with a line of their count and bytes."""
    from repro_torch.configs import get_bundle
    bundle = get_bundle(arch)
    t0 = time.perf_counter()
    params = bundle.init_params(SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init_params", arch=arch, seconds=time.perf_counter() - t0,
         params=bundle.param_count(),
         active_params=bundle.active_param_count(),
         bytes=tree_bytes(params))
    return params


def serve_all(params, arch: str) -> dict:
    """Serve ``arch`` in the three KV modes; each mode must launch its
    kernel (``MODE_KEYS``).  -> {mode: serve()'s result}."""
    with torch.no_grad():
        runs = {m: serve(m, params, arch) for m in MODES}
    for m, key in MODE_KEYS.items():
        require(runs[m]["launches"][key] > 0,
                f"{arch}: {m} mode never launched {key}")
    emit("agreement", arch=arch, paged_vs_paged_int8=agreement(
        runs["paged"]["results"], runs["paged_int8"]["results"]))
    return runs


def serve_moe() -> dict:
    """olmoe-1b-7b at full width (16 layers, d 2048, MHA 16/16 heads,
    head_dim 128, 64 experts top 8, vocab 50304; random bf16 weights from
    ``SEED``) served in the three KV modes with qwen3-4b's request shapes,
    then the paged modes again (same tokens and drops required), its
    flash-vs-plain prefill logits and one paged step through the kernel
    against the gather path.  The serve runs must launch ``flash_fwd``,
    ``paged_decode_bf16`` and ``paged_decode_int8`` more than once each.
    -> the first serve runs' launches, summed."""
    params = init_params(MOE_ARCH)
    runs = serve_all(params, MOE_ARCH)
    launches: dict[str, int] = {}
    for r in runs.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for key in MODE_KEYS.values():
        require(launches.get(key, 0) > 1,
                f"serve_moe: {key} launched {launches.get(key, 0)} times, "
                f"want more than once")
    # the capacity couples a tick's rows, pad and idle ones included: the
    # paged modes served again must give the same tokens and drops
    with torch.no_grad():
        for m in ("paged", "paged_int8"):
            again = serve(m, params, MOE_ARCH)
            same = (again["results"] == runs[m]["results"] and
                    again["row"]["moe_capacity_drops"] ==
                    runs[m]["row"]["moe_capacity_drops"])
            emit("serve_moe_repeat", arch=MOE_ARCH, mode=m, equal=same)
            require(same, f"serve_moe: {m} served again gave other tokens "
                    f"or drops")
    logits_check(params, MOE_ARCH)
    paged_step_check(params, MOE_ARCH)
    del params, runs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4c: serve the vlm, hybrid, audio and ssm families at full width
# ---------------------------------------------------------------------------

FAMILIES = ("internvl2-26b", "recurrentgemma-9b", "whisper-medium",
            "mamba2-370m")
# the flash route each family's prefill must launch (mamba2 runs no
# kernel); none may launch the CUDA-core forward
FAMILY_ROUTE = {"internvl2-26b": "flash_fwd",
                "recurrentgemma-9b": "flash_fwd_d256",
                "whisper-medium": "flash_fwd", "mamba2-370m": None}
FWD_KEYS = ("flash_fwd", "flash_fwd_d256", "flash_fwd_simt")
# internvl2: the 256-token vision prefix + a 2048 prompt bucket + 16 new
# tokens; recurrentgemma: its 2600-token prompt + 16 (its ring cache holds
# the 2048-token window)
FAMILY_MAX_LEN = {"internvl2-26b": 2320, "recurrentgemma-9b": 2616,
                  "whisper-medium": 2048, "mamba2-370m": 2048}
# logits_check's prompt: recurrentgemma's is longer than its window
FAMILY_CHECK_LEN = {"internvl2-26b": 1536, "recurrentgemma-9b": 3072,
                    "whisper-medium": 1536}


def family_workload(arch: str) -> tuple[list[np.ndarray], dict]:
    """A family's requests and engine settings: 4 prompts of 1024-1900
    tokens (recurrentgemma's last one 2600, past its window), 16 new
    tokens each, 4 slots."""
    from repro_torch.configs import get_bundle
    vocab = get_bundle(arch).cfg.vocab
    reqs = prompts(4, 1024, 1900, SEED + 3, vocab)
    if arch == "recurrentgemma-9b":
        reqs[-1] = prompts(1, 2600, 2600, SEED + 13, vocab)[0]
    return reqs, dict(max_new=16, slots=4, max_len=FAMILY_MAX_LEN[arch])


class PrefillClock(FiniteWatch):
    """FiniteWatch that also brackets each prefill with CUDA events (no
    host sync): the device-timeline span of every admission."""

    def __init__(self, bundle):
        super().__init__(bundle)
        self.spans = []

    def prefill(self, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = super().prefill(*a, **kw)
        ev[1].record()
        self.spans.append(ev)
        return out

    def prefill_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.spans]


def serve_family(arch: str) -> dict:
    """Serve 4 requests of 16 new tokens (prompts of 1024-1900 tokens;
    recurrentgemma's last one 2600, past its window) at ``arch``'s full
    width in the dense KV mode (the only one these kinds have), random
    bf16 weights from ``SEED``; every request must reach its count with
    finite logits and the family's flash route must launch.  Then
    ``logits_check`` for the families that run attention.  The weights are
    freed before the next family.  -> the serve run's launches."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    reqs, kw = family_workload(arch)
    params = init_params(arch)
    engine, _ = build_engine(arch, smoke=False, kv_mode="dense",
                             params=params, device="cuda", **kw)
    clock = PrefillClock(engine.bundle)
    engine.bundle = clock
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for p in reqs:
            engine.submit(p)
        results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_tok = sum(len(v) for v in results.values())
    pre = clock.prefill_ms()
    row = dict(arch=arch, kind=get_bundle(arch).kind, mode="dense",
               requests=len(reqs), slots=engine.cfg.batch,
               prompt_lengths=[len(p) for p in reqs],
               generated_tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               prefill_ms=pre, prefill_ms_total=sum(pre),
               steps=clock.steps,
               flash_launches={k: launches[k] for k in FWD_KEYS},
               launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               kv=engine.kv_stats())
    emit("serve_families", **row)
    require(sorted(results) == list(range(len(reqs))),
            f"{arch}: {len(results)} of {len(reqs)} requests completed")
    require(all(len(v) == 16 for v in results.values()) and
            all(o == "ok" for o in engine.outcomes.values()),
            f"{arch}: a request ended short of 16 tokens")
    require(bool(clock.finite.item()), f"{arch}: non-finite logits")
    route = FAMILY_ROUTE[arch]
    flash = sum(row["flash_launches"].values())
    require(flash == 0 if route is None else
            launches[route] == flash > 0,
            f"{arch}: flash launches {row['flash_launches']}, want "
            f"{route or 'none'} alone")
    del engine, clock
    torch.cuda.empty_cache()
    if arch in FAMILY_CHECK_LEN:
        logits_check(params, arch, n=FAMILY_CHECK_LEN[arch], top1=True)
    del params
    torch.cuda.empty_cache()
    return launches


def serve_families() -> dict:
    """Each family of ``FAMILIES`` in turn (qwen3-4b's weights stay
    resident).  -> the serve runs' launches, summed."""
    total: dict[str, int] = {}
    for arch in FAMILIES:
        for k, n in serve_family(arch).items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# phase 5: train qwen3-4b at full width
# ---------------------------------------------------------------------------

def token_batch(B: int, S: int, seed: int, vocab: int) -> dict:
    t = torch.from_numpy(np.stack(prompts(B, S + 1, S + 1, seed, vocab))) \
        .long().to("cuda")
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


# |norm ratio - 1| of each train_check leaf: the cosine is blind to a
# gradient wrong by a factor (a scale applied twice, a GQA group summed G
# times), which the norm shows at once.  About 7x the largest reading of a
# sound run on one H100 (6.8e-4, wv of layer 0).
NORM_TOL = 5e-3


def train_check(params, bundle=None, B: int = 1, S: int = 2048) -> dict:
    """Loss and gradients of one (B, S) batch through the flash kernels
    (forward and backward) against the plain attention path, both under
    per-layer recompute, for ``bundle`` (default qwen3-4b's): bf16 over
    many layers is not bit-stable across attention paths, so this asserts
    a relative loss difference under 1e-3 and, per leaf, a cosine over
    0.99 and a norm within ``NORM_TOL`` of the plain path's.  The leaves:
    the embedding, and wq, wk and wv of the first and the last attention
    layer (recurrentgemma: of its attention groups)."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.training import loss_fn
    bundle = bundle or get_bundle(ARCH)
    stack = params["attn_groups" if bundle.kind == "hybrid" else "layers"]
    batch = token_batch(B, S, SEED + 11, bundle.cfg.vocab)
    L = stack["wq"].shape[0]
    names = ("wq", "wk", "wv")
    leaves = [params["embed"], *(stack[n] for n in names)]
    out = {}
    for impl in ("pallas", "xla"):
        b = dataclasses.replace(bundle, cfg=dataclasses.replace(
            bundle.cfg, attn_impl=impl))
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(b.forward, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        got = {"embed": grads[0]}
        for n, g in zip(names, grads[1:]):
            got[f"{n}[0]"], got[f"{n}[{L - 1}]"] = g[0].clone(), \
                g[L - 1].clone()
        out[impl] = (loss.item(), got)
        del grads, loss
    (la, ga), (lb, gb) = out["pallas"], out["xla"]
    cos = {k: F.cosine_similarity(ga[k].float().flatten(),
                                  gb[k].float().flatten(), dim=0).item()
           for k in ga}
    ratio = {k: (ga[k].float().norm() / gb[k].float().norm()).item()
             for k in ga}
    rel = abs(la - lb) / abs(lb)
    row = dict(arch=bundle.cfg.name, n_layers=bundle.cfg.n_layers, B=B, S=S,
               loss_flash=la, loss_plain=lb, loss_rel_diff=rel, cosine=cos,
               norm_ratio=ratio,
               tol=f"loss rel diff < 1e-3; per leaf cosine > 0.99 and "
                   f"|norm ratio - 1| < {NORM_TOL}")
    emit("train_check", **row)
    require(math.isfinite(la) and rel < 1e-3 and
            all(c > 0.99 for c in cos.values()) and
            all(abs(r - 1.0) < NORM_TOL for r in ratio.values()),
            f"flash vs plain training loss/grads: {row}")
    return row


def train(params) -> dict:
    """Three AdamW steps of qwen3-4b at full width (B 2, S 2048, one
    microbatch) through ``launch.train.run`` on the served weights, which
    it updates in place."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.configs import get_bundle
    L = get_bundle(ARCH).cfg.n_layers

    def probes():
        return {"wq[0]": params["layers"]["wq"][0, :64, :64],
                f"w_gate[{L - 1}]": params["layers"]["w_gate"][L - 1, :64,
                                                               :64],
                "embed": params["embed"][:64, :64]}
    def moved():
        return {k: not torch.equal(before[k], v) for k, v in probes().items()}

    after_first = {}

    def on_step(i, p, opt, m):
        if i == 0:
            after_first.update(moved())

    before = {k: v.clone() for k, v in probes().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run(ARCH, smoke=False, steps=3, seq_len=2048, global_batch=2,
              microbatches=1, device="cuda", params=params, on_step=on_step)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    changed = moved()
    steps_s = out["seconds"]
    tokens = 2 * 2048
    row = dict(steps=len(steps_s), losses=out["losses"],
               finite=[m["finite"] for m in out["metrics"]],
               grad_norm=[m["grad_norm"] for m in out["metrics"]],
               lr=[m["lr"] for m in out["metrics"]], s_per_step=steps_s,
               tok_per_s_after_first=tokens * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall,
               max_memory_allocated=peak,
               params_changed_after_step_1=after_first,
               params_changed=changed,
               opt_step=int(out["opt"]["step"]), launches=launches)
    emit("train", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and len(steps_s) == 3,
            f"train: a loss or finite flag is bad: {row}")
    require(len(after_first) == len(changed) and
            all(after_first.values()) and all(changed.values()) and
            row["opt_step"] == 3,
            f"train: params did not change: after step 1 {after_first}, "
            f"after step 3 {changed}")
    require(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == L * 3
            and launches["flash_fwd"] == 2 * L * 3
            and launches["flash_fwd_simt"] == 0
            and launches["flash_bwd_dq_simt"] == 0
            and launches["flash_bwd_dkv_simt"] == 0,
            f"train: flash launches {launches}, want wgmma bwd {L * 3} each, "
            f"wgmma fwd {2 * L * 3} (forward + per-layer recompute) and no "
            f"CUDA-core flash kernel")
    del out
    return row


# ---------------------------------------------------------------------------
# phase 5a: the context-parallel ring on one card.  A (1, RING_M) mesh of
# local rings holds every rank of the model axis in this process, one after
# another: a hop rotates a list and moves no bytes, so these times are the
# ring's compute (m x m hop folds a call), not its communication
# ---------------------------------------------------------------------------

RING_M = 4
# ring_attention alone: qwen3-4b's heads causal over 16,384 tokens (S_l
# 4,096), recurrentgemma-9b's local MQA at head_dim 256 over 8,192 tokens
# with its 2,048 window (S_l 2,048)
RING_SHAPES = {
    "qwen3-4b": dict(B=1, S=16384, H=32, Hkv=8, D=128, window=None),
    "recurrentgemma-9b": dict(B=1, S=8192, H=16, Hkv=1, D=256,
                              window=2048)}
# ring_matmul at qwen3-4b's MLP width: 4,096 tokens x d_model 2,560 times
# d_model x d_ff 9,728
RING_MM_SHAPE = dict(M=4096, K=2560, N=9728)
# train_ring: qwen3-4b whole, the 4,096 tokens of `train` in one row, so
# that the default policy picks the ring (S >= 4,096, S_l 1,024 <= 4,096)
RING_TRAIN = dict(B=1, S=4096)
# attention() under the mesh at qwen3-4b's heads, one sequence on each
# route the default policies give: S 2,048 is not above attention()'s
# full_threshold (the unsharded flash kernels), 3,072 is above it and below
# the ring's 4,096 threshold (the replicated mode: the flash kernels on each
# q shard), 4,096 takes the ring
MESH_ROUTE_HEADS = dict(B=1, H=32, Hkv=8, D=128, window=None)
MESH_ROUTE_SEQS = {2048: "flash", 3072: "replicated", 4096: "ring"}


def ring_mesh():
    from repro_torch.parallel import make_mesh
    return make_mesh((1, RING_M), ("data", "model"))


def ring_inputs(shape: dict, seed: int):
    """Global (B, S, H, D) q and do, (B, S, Hkv, D) k and v, bf16."""
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, h, D), generator=g, device="cuda")
                 .to(torch.bfloat16) for h in (H, Hkv, Hkv, H))


def masked_hop(q, k, v, do, lse, delta, window) -> dict:
    """Rank 0's hop with rank 1's shard: every key lies in its rows'
    future, so the hop's ranges are empty.  Each launcher's outputs land in
    blocks filled with NaN and freed just before (the caching allocator
    hands them back; a warm-up launch first builds the ranges): the
    forward must drain o = 0 and lse = -1e30, the backward (fed the ring's
    global lse and delta of those rows) dq = dk = dv = 0, all exactly."""
    from repro_torch.kernels import attention as katt
    B, S, H, D = q.shape
    S_l = S // RING_M
    qt, dot = (x[:, :S_l].transpose(1, 2) for x in (q, do))
    kt, vt = (x[:, S_l:2 * S_l].transpose(1, 2) for x in (k, v))
    lse0, delta0 = (x.view(B * H, S)[:, :S_l].contiguous()
                    for x in (lse, delta))
    kw = dict(causal=True, window=window, q_offset=0, k_offset=S_l)
    nan = float("nan")

    def poisoned(*likes):
        blocks = [torch.full(x.shape, nan, dtype=d, device="cuda")
                  for x, d in likes]
        ptrs = [b.data_ptr() for b in blocks]
        del blocks
        return ptrs

    with torch.no_grad():
        args = (qt, kt, vt, dot, lse0, delta0)
        katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)        # warm-up
        katt.flash_bwd_dq_cuda(*args, **kw)
        katt.flash_bwd_dkv_cuda(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # no other free block to hand out
        ptrs = poisoned((qt, qt.dtype), (lse0, torch.float32))
        o, lse_h = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
        reused = [o.data_ptr(), lse_h.data_ptr()] == ptrs
        ptrs = poisoned((qt, torch.float32))
        dq = katt.flash_bwd_dq_cuda(*args, **kw)
        reused &= dq.data_ptr() == ptrs[0]
        ptrs = poisoned((kt, torch.float32), (kt, torch.float32))
        dk, dv = katt.flash_bwd_dkv_cuda(*args, **kw)
        reused &= sorted([dk.data_ptr(), dv.data_ptr()]) == sorted(ptrs)
        torch.cuda.synchronize()
    row = dict(poisoned_blocks_reused=reused,
               o_zero=bool((o == 0).all()),
               lse_neg_inf=bool((lse_h == -1e30).all()),
               dq_zero=bool((dq == 0).all()), dk_zero=bool((dk == 0).all()),
               dv_zero=bool((dv == 0).all()))
    require(all(row.values()), f"wholly masked hop: {row}")
    return row


def check_ring_attention(flush, arch: str, shape: dict) -> dict:
    """``ring_attention`` on a (1, RING_M) local ring, fused (the flash
    kernels each hop), against the unsharded flash kernels on the same
    bf16 inputs: o by the forward's element bound and lse within 1e-4; the
    f32 dq, dk and dv of the autograd Function's backward (read through
    ``record_ring_passes``; its grads must be them cast, bit for bit) by
    the rounded routes' bound against the unsharded backward kernels fed
    the ring's own o and lse (the ring rounds o to bf16 from another f32
    sum, so its delta = rowsum(o * do) may differ from the unsharded one by
    an ulp of o, which moves every ds of a row at once: a shift the
    per-term bound does not cover and the check of o already bounds); the
    launches of one call
    (m x m of each kernel), times of the forward and of the backward
    beside the unsharded kernels', and the wholly masked hop's
    zero-write."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    from repro_torch.parallel.ring_attention import (ring_attention,
                                                     record_ring_passes)
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    band = dict(causal=True, window=shape["window"])
    mesh = ring_mesh()
    q, k, v, do = ring_inputs(shape, SEED + 21)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    fwd_key = katt.flash_fwd_route(qt, kt, vt)
    route = katt.flash_bwd_route(qt, kt, vt, dot)
    sfx = BWD_SUFFIX[route]
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    with record_ring_passes() as record:
        out = ring_attention(*leaves, mesh=mesh, fused=True, **band)
        grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    (passes,) = record
    o, lse_ring = out.detach(), passes["lse"]
    dq, dk, dv = (passes[n] for n in ("dq", "dk", "dv"))
    cast_equal = all(torch.equal(g, f.to(g.dtype))
                     for g, f in zip(grads, (dq, dk, dv)))
    del out, grads, record, passes
    hops = RING_M * RING_M
    want = {fwd_key: hops, f"flash_bwd_dq{sfx}": hops,
            f"flash_bwd_dkv{sfx}": hops}
    require(launches == want, f"ring_attention {arch}: launches "
            f"{launches}, want {want}")
    with torch.no_grad():
        o_ref, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **band)
        lse_ring = lse_ring.reshape(B * H, S).contiguous()
        ot = o.transpose(1, 2)
        ref = katt.flash_attention_bwd(qt, kt, vt, ot, lse_ring, dot,
                                       **band)
        delta = (ot.float() * dot.float()).sum(-1).reshape(B * H, S) \
            .contiguous()
        flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
                vt.reshape(B * Hkv, S, D), dot.reshape(B * H, S, D))
        t0 = time.perf_counter()
        terms = katt.flash_bwd_term_max(*flat, lse_ring, delta, **band,
                                        **katt.flash_bwd_plain_kw(route))
        terms_s = time.perf_counter() - t0
    close = {"o": closeness(o, o_ref.transpose(1, 2), 2e-3)}
    lse_err = (lse_ring - lse).abs().max().item()
    for name, got, want_, t, h in (("dq", dq, ref[0], terms[0], H),
                                   ("dk", dk, ref[1], terms[1], Hkv),
                                   ("dv", dv, ref[2], terms[2], Hkv)):
        close[name] = closeness_rounded(
            got, want_.transpose(1, 2), t.view(B, h, S, D).transpose(1, 2))
    del ref, terms
    masked = masked_hop(q, k, v, do, lse, delta, band["window"])
    # times: the ring's forward (no grad) and its backward alone (the
    # graph kept), beside the unsharded kernels' through the same autograd
    out = ring_attention(*leaves, mesh=mesh, fused=True, **band)
    ref_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out_ref = katt.flash_attention_train(
        *(x.transpose(1, 2) for x in ref_leaves), **band)
    calls = {
        "ring_fwd": lambda: ring_attention(q, k, v, mesh=mesh, fused=True,
                                           **band),
        "ring_bwd": lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True),
        "unsharded_fwd": lambda: katt.flash_attention_fwd_cuda(qt, kt, vt,
                                                               **band),
        "unsharded_bwd": lambda: torch.autograd.grad(
            out_ref, ref_leaves, dot, retain_graph=True)}
    times = {}
    for name, fn in calls.items():
        with torch.no_grad() if name.endswith("fwd") else \
                contextlib.nullcontext():
            times[name] = dict(ms=time_ms(fn, 5, flush)[0],
                               device_ms=device_ms(fn, 5, flush))
    del out, out_ref, leaves, ref_leaves
    row = dict(arch=arch, m=RING_M, S_local=S // RING_M,
               shape=dict(shape, causal=True), routes=[fwd_key, route],
               launches_per_call=launches, times=times,
               fwd_ratio=times["ring_fwd"]["device_ms"] /
               times["unsharded_fwd"]["device_ms"],
               bwd_ratio=times["ring_bwd"]["device_ms"] /
               times["unsharded_bwd"]["device_ms"],
               terms_s=terms_s, masked_hop=masked,
               grads_are_f32_cast=cast_equal, lse_max_abs_err=lse_err, **{
                   f"{n}_close": c for n, c in close.items()})
    emit("ring_attention", **row)
    for name, c in close.items():
        require(c["within_tol"], f"ring_attention {arch} {name}: {c}")
    require(lse_err < 1e-4, f"ring_attention {arch}: lse off by {lse_err}")
    require(cast_equal, f"ring_attention {arch}: the autograd grads are not "
            f"the backward's f32 grads cast")
    return row


def check_mesh_routes(arch: str, heads: dict) -> dict:
    """``layers.attention`` (the default policies) with its backward under
    the (1, RING_M) mesh against the same call with no mesh (the unsharded
    flash kernels), at each sequence of MESH_ROUTE_SEQS: the flash launches
    of its route (1, m or m x m of each kernel), ring hops on the ring's
    route only, o by the forward's element bound, and dq, dk and dv each
    within 2^-6 relative L2 of the whole tensor (the replicated mode's
    dk / dv are m bf16 partials that autograd sums)."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    from repro_torch.models.layers import attention
    from repro_torch.parallel import set_mesh
    rows = {}
    for S, path in MESH_ROUTE_SEQS.items():
        q, k, v, do = ring_inputs(dict(heads, S=S), SEED + 25)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        sfx = BWD_SUFFIX[katt.flash_bwd_route(qt, kt, vt, dot)]
        n = {"flash": 1, "replicated": RING_M, "ring": RING_M * RING_M}[path]
        want = {katt.flash_fwd_route(qt, kt, vt): n,
                f"flash_bwd_dq{sfx}": n, f"flash_bwd_dkv{sfx}": n}
        runs = {}
        for mesh in (ring_mesh(), None):
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            ops.reset_launches()
            with set_mesh(mesh):
                o = attention(*leaves, causal=True, window=heads["window"])
                grads = torch.autograd.grad(o, leaves, do)
            torch.cuda.synchronize()
            runs["mesh" if mesh else "unsharded"] = dict(
                o=o.detach(), grads=grads,
                launches={n_: c for n_, c in ops.LAUNCHES.items() if c},
                hops=mesh.transport("model").hops if mesh else 0)
        got, ref = runs["mesh"], runs["unsharded"]
        rel = {name: ((g.float() - r.float()).norm() /
                      r.float().norm()).item()
               for name, g, r in zip(("dq", "dk", "dv"), got["grads"],
                                     ref["grads"])}
        rows[S] = dict(path=path, launches=got["launches"],
                       launches_unsharded=ref["launches"], want=want,
                       hops=got["hops"],
                       o_close=closeness(got["o"], ref["o"], 2e-3),
                       grad_rel_l2=rel)
        del runs, got, ref
    emit("mesh_routes", arch=arch, m=RING_M, heads=heads, rows=rows)
    for S, r in rows.items():
        require(r["launches"] == r["want"] and
                (r["hops"] > 0) == (r["path"] == "ring"),
                f"mesh_routes {arch} S {S}: launches {r['launches']}, hops "
                f"{r['hops']}, want {r['want']} on the {r['path']} route")
        require(r["o_close"]["within_tol"] and
                all(x < 2.0 ** -6 for x in r["grad_rel_l2"].values()),
                f"mesh_routes {arch} S {S}: {r}")
    return rows


def check_ring_matmul(flush) -> dict:
    """``ring_matmul`` on a (1, RING_M) local ring at qwen3-4b's MLP width
    against ``torch.matmul``, forward and backward (bf16; each element
    within one bf16 ulp plus 1e-3 of the output's max), their times, and
    the peak-memory growth of ``ring_matmul`` against ``allgather_matmul``
    (``max_memory_allocated`` above what was allocated before each call):
    the ring's must be smaller."""
    from repro_torch.parallel import allgather_matmul, ring_matmul
    M, K, N = (RING_MM_SHAPE[k] for k in ("M", "K", "N"))
    mesh = ring_mesh()
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    b = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5) \
        .to(torch.bfloat16)
    do = torch.randn((M, N), generator=g, device="cuda").to(torch.bfloat16)
    leaves = [x.detach().requires_grad_(True) for x in (a, b)]
    refs = [x.detach().requires_grad_(True) for x in (a, b)]
    out = ring_matmul(*leaves, mesh)
    out_ref = torch.matmul(*refs)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    grads_ref = torch.autograd.grad(out_ref, refs, do, retain_graph=True)
    close = {n: closeness(x, y, 1e-3 * y.float().abs().max().item())
             for n, x, y in (("out", out, out_ref), ("da", grads[0],
                                                     grads_ref[0]),
                             ("db", grads[1], grads_ref[1]))}
    peak = {}
    with torch.no_grad():
        for name, fn in (("ring_matmul", ring_matmul),
                         ("allgather_matmul", allgather_matmul)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r = fn(a, b, mesh)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() - base
            del r
    times = {}
    for name, fn in (
            ("ring_fwd", lambda: ring_matmul(a, b, mesh)),
            ("matmul_fwd", lambda: torch.matmul(a, b)),
            ("ring_bwd", lambda: torch.autograd.grad(out, leaves, do,
                                                     retain_graph=True)),
            ("matmul_bwd", lambda: torch.autograd.grad(
                out_ref, refs, do, retain_graph=True))):
        with torch.no_grad() if name.endswith("fwd") else \
                contextlib.nullcontext():
            times[name] = dict(ms=time_ms(fn, 10, flush)[0],
                               device_ms=device_ms(fn, 10, flush))
    del out, out_ref, grads, grads_ref
    row = dict(shape=dict(RING_MM_SHAPE, m=RING_M), times=times,
               peak_growth_bytes=peak, b_bytes=b.numel() * b.element_size(),
               **{f"{n}_close": c for n, c in close.items()})
    emit("ring_matmul", **row)
    for n, c in close.items():
        require(c["within_tol"], f"ring_matmul {n}: {c}")
    require(peak["ring_matmul"] < peak["allgather_matmul"],
            f"ring_matmul holds more than all-gather: {peak}")
    return row


def ring_train_check(params) -> dict:
    """qwen3-4b's loss and gradients of one B 1 x S 4,096 batch under the
    (1, RING_M) mesh (the default policy: the ring, each hop the flash
    kernels) against the same batch with no mesh (the unsharded flash
    kernels), by ``train_check``'s limits: loss rel diff < 1e-3, per leaf
    cosine > 0.99 and |norm ratio - 1| < NORM_TOL, for the embedding and
    wq, wk, wv of the first and the last layer."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.parallel import set_mesh
    from repro_torch.training import loss_fn
    bundle = get_bundle(ARCH)
    stack = params["layers"]
    batch = token_batch(RING_TRAIN["B"], RING_TRAIN["S"], SEED + 11,
                        bundle.cfg.vocab)
    L = stack["wq"].shape[0]
    names = ("wq", "wk", "wv")
    leaves = [params["embed"], *(stack[n] for n in names)]
    out = {}
    for mesh in (ring_mesh(), None):
        for p in leaves:
            p.requires_grad_(True)
        ops.reset_launches()
        with set_mesh(mesh):
            loss, _ = loss_fn(bundle.forward, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        launches = {n: c for n, c in ops.LAUNCHES.items() if c}
        for p in leaves:
            p.requires_grad_(False)
        got = {"embed": grads[0]}
        for n, gr in zip(names, grads[1:]):
            got[f"{n}[0]"], got[f"{n}[{L - 1}]"] = gr[0].clone(), \
                gr[L - 1].clone()
        out["ring" if mesh else "unsharded"] = (loss.item(), got, launches)
        del grads, loss
    (la, ga, lna), (lb, gb, lnb) = out["ring"], out["unsharded"]
    cos = {k: F.cosine_similarity(ga[k].float().flatten(),
                                  gb[k].float().flatten(), dim=0).item()
           for k in ga}
    ratio = {k: (ga[k].float().norm() / gb[k].float().norm()).item()
             for k in ga}
    rel = abs(la - lb) / abs(lb)
    hops = L * RING_M * RING_M
    row = dict(arch=ARCH, B=RING_TRAIN["B"], S=RING_TRAIN["S"], m=RING_M,
               loss_ring=la, loss_unsharded=lb, loss_rel_diff=rel,
               cosine=cos, norm_ratio=ratio, launches_ring=lna,
               launches_unsharded=lnb,
               tol=f"loss rel diff < 1e-3; per leaf cosine > 0.99 and "
                   f"|norm ratio - 1| < {NORM_TOL}")
    emit("ring_train_check", **row)
    require(math.isfinite(la) and rel < 1e-3 and
            all(c > 0.99 for c in cos.values()) and
            all(abs(r - 1.0) < NORM_TOL for r in ratio.values()),
            f"ring vs unsharded loss/grads: {row}")
    require(lna.get("flash_fwd") == 2 * hops and
            lna.get("flash_bwd_dq") == lna.get("flash_bwd_dkv") == hops and
            lnb.get("flash_fwd") == 2 * L,
            f"ring_train_check launches: ring {lna}, unsharded {lnb}")
    return row


def train_ring(params) -> dict:
    """Three AdamW steps of qwen3-4b at full width and depth (B 1 x S
    4,096, one microbatch) through ``launch.train.run`` under the (1,
    RING_M) local mesh, on ``params`` (updated in place): finite losses,
    probed params moved, ``opt_step`` 3, the peak under 80 GB, and the
    flash launches of the formula: each of L layers folds m ranks x m
    hops, the forward twice (the step's forward and the per-layer
    recompute), each backward kernel once."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    L = params["layers"]["wq"].shape[0]
    probes = {"wq[0]": lambda: params["layers"]["wq"][0, :64, :64],
              f"w_gate[{L - 1}]":
                  lambda: params["layers"]["w_gate"][L - 1, :64, :64],
              "embed": lambda: params["embed"][:64, :64]}
    before = {k: f().clone() for k, f in probes.items()}
    mesh = ring_mesh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run(ARCH, smoke=False, steps=TRAIN_STEPS, seq_len=RING_TRAIN["S"],
              global_batch=RING_TRAIN["B"], microbatches=1, device="cuda",
              mesh_kind=mesh, params=params)
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    changed = {k: not torch.equal(before[k], f()) for k, f in probes.items()}
    steps_s = out["seconds"]
    tokens = RING_TRAIN["B"] * RING_TRAIN["S"]
    n = L * RING_M * RING_M * TRAIN_STEPS
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    row = dict(arch=ARCH, m=RING_M, **RING_TRAIN, steps=len(steps_s),
               losses=out["losses"],
               finite=[m["finite"] for m in out["metrics"]],
               grad_norm=[m["grad_norm"] for m in out["metrics"]],
               s_per_step=steps_s,
               tok_per_s_after_first=tokens * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall, max_memory_allocated=peak,
               params_changed=changed, opt_step=int(out["opt"]["step"]),
               ring_hops=mesh.transport("model").hops, launches=launches,
               want_flash=want)
    emit("train_ring", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and
            len(steps_s) == TRAIN_STEPS and row["opt_step"] == TRAIN_STEPS,
            f"train_ring: a loss, finite flag or step count is bad: {row}")
    require(all(changed.values()), f"train_ring: params did not move "
            f"{changed}")
    require(peak < 80e9, f"train_ring: peak {peak} bytes")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} ==
            dict(dict.fromkeys(FLASH_KEYS, 0), **want),
            f"train_ring: flash launches {launches}, want {want}")
    del out
    return row


def ring_phase() -> dict:
    """Phase 5a: ring_attention alone at two models' heads, attention()'s
    routes under the mesh, ring_matmul, then qwen3-4b's ring_train_check
    and train_ring on the same random weights from ``SEED``; returns
    train_ring's launches (the main path's) for the kernels line."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for arch, shape in RING_SHAPES.items():
        check_ring_attention(flush, arch, shape)
        torch.cuda.empty_cache()
    check_mesh_routes(ARCH, MESH_ROUTE_HEADS)
    torch.cuda.empty_cache()
    check_ring_matmul(flush)
    del flush
    torch.cuda.empty_cache()
    params = init_params(ARCH)
    ring_train_check(params)
    torch.cuda.empty_cache()
    return train_ring(params)["launches"]


# ---------------------------------------------------------------------------
# phase 5b: train the vlm, hybrid, audio and ssm families at full width
# ---------------------------------------------------------------------------

# per family: the depth run (None: the config's own), the batch, why a
# depth is cut (the state, bf16 params and grads with f32 moments, is 12
# bytes a param: the full recurrentgemma-9b needs 125 GB, internvl2-26b
# 238 GB, one card 80), and three probes (the embedding, a leaf of the
# first unit and one of the last) that must move with every step
TRAIN_FAMILIES = {
    "recurrentgemma-9b": dict(
        n_layers=8, B=1, S=4096,
        cut="8 of 38 layers: 2 (rec, rec, attn) groups and the 2-layer "
            "rec tail; the full 10.45 B params need 125 GB of state",
        probes=(("embed",), ("attn_groups", "wq", 0),
                ("rec_tail", "mlp_down", -1))),
    "internvl2-26b": dict(
        n_layers=8, B=2, S=2048,
        cut="8 of 48 layers; the full 19.86 B params need 238 GB of state",
        probes=(("embed",), ("layers", "wq", 0), ("layers", "w_gate", -1))),
    "whisper-medium": dict(
        n_layers=None, B=2, S=1024, cut=None,
        probes=(("embed",), ("enc", "attn", "wq", 0),
                ("dec", "mlp_w1", -1))),
    "mamba2-370m": dict(
        n_layers=None, B=2, S=2048, cut=None,
        probes=(("embed",), ("layers", "in_proj", 0),
                ("layers", "out_proj", -1))),
}
TRAIN_STEPS = 3
FLASH_KEYS = ("flash_fwd", "flash_fwd_d256", "flash_fwd_simt",
              "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_d256",
              "flash_bwd_dkv_d256", "flash_bwd_dq_simt", "flash_bwd_dkv_simt")


def family_bundle(arch: str):
    """``arch``'s full-width bundle, cut in depth where TRAIN_FAMILIES
    says so (every width is the config's own)."""
    import dataclasses

    from repro_torch.configs import get_bundle
    bundle = get_bundle(arch)
    n = TRAIN_FAMILIES[arch]["n_layers"]
    if n is None:
        return bundle
    return dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, n_layers=n))


def attention_calls(bundle) -> int:
    """Flash attention calls of one forward: recurrentgemma's attention
    groups, the transformer's layers, whisper's encoder self-attention and
    decoder self- and cross-attention (all at or above the flash policy's
    1024-token threshold here), none in mamba2."""
    if bundle.kind == "hybrid":
        return bundle.cfg.n_groups
    if bundle.kind == "audio":
        return 3 * bundle.cfg.n_layers
    return bundle.cfg.n_layers if bundle.kind == "vlm" else 0


def want_flash(bundle, steps: int) -> dict:
    """The flash launches ``steps`` train steps must make: the forward
    twice per attention call (the step's forward and the per-layer
    recompute), each backward kernel once, all on the family's routes."""
    n = attention_calls(bundle) * steps
    want = dict.fromkeys(FLASH_KEYS, 0)
    if bundle.kind == "hybrid":         # head_dim 256
        want.update(flash_fwd_d256=2 * n, flash_bwd_dq_d256=n,
                    flash_bwd_dkv_d256=n)
    elif n:
        want.update(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
    return want


def train_family(arch: str) -> dict:
    """``TRAIN_STEPS`` AdamW steps of ``arch`` at full width (depth cut as
    ``TRAIN_FAMILIES`` says, random bf16 weights from ``SEED``, one
    microbatch, zero extras) through ``launch.train.run``; recurrentgemma
    first holds its flash path against the plain one (``train_check`` at
    its train batch, the head_dim-256 backward end to end).  Requires
    finite losses, every probe moved after step 1 and after the last,
    ``opt_step`` equal to the steps, peak memory under 80 GB and the
    family's flash launches (``want_flash``).  -> the row."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    spec = TRAIN_FAMILIES[arch]
    bundle = family_bundle(arch)
    B, S = spec["B"], spec["S"]
    t0 = time.perf_counter()
    params = bundle.init_params(SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if arch == "recurrentgemma-9b":
        train_check(params, bundle, B=B, S=S)
        torch.cuda.empty_cache()

    def probe(path):
        t = params
        for key in path:        # dict keys, then a layer index
            t = t[key]
        return t[:64, :64]

    def probes():
        return {"/".join(map(str, p)): probe(p) for p in spec["probes"]}

    def moved():
        return {k: not torch.equal(before[k], v) for k, v in probes().items()}

    after_first = {}

    def on_step(i, p, opt, m):
        if i == 0:
            after_first.update(moved())

    before = {k: v.clone() for k, v in probes().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run(bundle, steps=TRAIN_STEPS, seq_len=S, global_batch=B,
              microbatches=1, device="cuda", params=params,
              on_step=on_step)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    changed = moved()
    steps_s = out["seconds"]
    want = want_flash(bundle, TRAIN_STEPS)
    row = dict(arch=arch, kind=bundle.kind, n_layers=bundle.cfg.n_layers,
               cut=spec["cut"], params=bundle.param_count(),
               state_bytes=12 * bundle.param_count(), init_s=init_s,
               B=B, S=S, steps=len(steps_s), losses=out["losses"],
               finite=[m["finite"] for m in out["metrics"]],
               grad_norm=[m["grad_norm"] for m in out["metrics"]],
               s_per_step=steps_s,
               tok_per_s_after_first=B * S * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall, max_memory_allocated=peak,
               params_changed_after_step_1=after_first,
               params_changed=changed, opt_step=int(out["opt"]["step"]),
               flash_launches={k: launches[k] for k in FLASH_KEYS},
               want_flash_launches=want, launches=launches)
    emit("train_families", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and
            len(steps_s) == TRAIN_STEPS,
            f"train_families {arch}: a loss or finite flag is bad: {row}")
    require(len(after_first) == len(changed) == len(spec["probes"]) and
            all(after_first.values()) and all(changed.values()) and
            row["opt_step"] == TRAIN_STEPS,
            f"train_families {arch}: params did not change: after step 1 "
            f"{after_first}, after step {TRAIN_STEPS} {changed}")
    require(peak < 80e9, f"train_families {arch}: peak memory {peak} B")
    require(row["flash_launches"] == want,
            f"train_families {arch}: flash launches "
            f"{row['flash_launches']}, want {want}")
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_families() -> dict:
    """Each family of ``TRAIN_FAMILIES`` in turn on an empty card.  -> the
    train runs' launches, summed."""
    total: dict[str, int] = {}
    for arch in TRAIN_FAMILIES:
        for k, n in train_family(arch)["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# phase 6: recovery — kill and restart the full-width training
# ---------------------------------------------------------------------------

# the checkpoint metrics the recovery phase reads from the registry
CKPT_METRICS = ("checkpoint_snapshot_s", "checkpoint_save_s",
                "checkpoint_crc_s", "checkpoint_verify_s",
                "checkpoint_restore_s")


def state_fingerprint(state) -> list[list[int]]:
    """Per leaf of a train state (in flatten order), the int64 sum of its
    raw words and their sum weighted by position (1, 2, ...), both
    wrapping, taken on the card in slices: equal states give equal lists,
    a changed word changes both sums and a moved one the second."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.optim.adamw import CHUNK
    sums = []
    for _, leaf in flatten_with_paths(state):
        words = leaf.reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[leaf.element_size()])
        s = torch.zeros(2, dtype=torch.int64, device=leaf.device)
        for off in range(0, words.numel(), CHUNK):
            w = words[off:off + CHUNK].long()
            pos = torch.arange(off + 1, off + 1 + w.numel(),
                               dtype=torch.int64, device=w.device)
            s[0] += w.sum()
            s[1] += (w * pos).sum()
            del w, pos
        sums.append(s)
    return [s.tolist() for s in sums]


def ckpt_seconds() -> dict:
    """Sum and count of each checkpoint histogram since the last reset."""
    from repro_torch.obs import REGISTRY
    hists = REGISTRY.snapshot()["histograms"]
    return {k: {"s": hists[k]["sum"], "n": hists[k]["count"]}
            for k in CKPT_METRICS if k in hists}


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def recovery() -> dict:
    """qwen3-4b at full width and depth (B 2 x S 2048, one microbatch,
    bf16 params, f32 moments) through ``launch.train.run`` three times,
    each from ``init_params(SEED)`` and freed before the next:

    A, uninterrupted: 4 steps, ``nan@1`` (step 1 skipped on the card);
    B, killed: the same with a checkpoint every 2 steps and ``kill@3``,
       which lands the step-2 save and exits 43;
    C, restarted: 2 steps from the same directory: restores step 2, runs
       steps 2 and 3 and saves step 4.

    B's losses must equal A's first three and C's A's last two, bit for
    bit; C's final state (44 GB: params, moments, step) must equal A's by
    ``state_fingerprint``; the step-4 save must verify.  No fallback: a
    failed save, verify or restore fails the phase.  The checkpoints go to
    ``build/recovery_ckpt`` (git-ignored), removed at the end; where the
    disk holds one checkpoint but not two, step 2 is removed once C has
    restored it, before C writes step 4."""
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.obs import REGISTRY
    from repro_torch.runtime import KILL_EXIT_CODE, ChaosKilled
    bundle = get_bundle(ARCH)
    L = bundle.cfg.n_layers
    n = bundle.param_count()
    state_bytes = n * 2 + 2 * n * 4 + 4      # bf16 params, f32 mu/nu, step
    kw = dict(smoke=False, seq_len=2048, global_batch=2, microbatches=1,
              device="cuda")
    ckpt = ROOT / "build" / "recovery_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    free = {"before": shutil.disk_usage(ckpt).free}
    require(free["before"] >= 1.02 * state_bytes,
            f"recovery: {free['before']} bytes free under {ckpt}, a "
            f"checkpoint takes ~{state_bytes}")
    row = {"state_bytes": state_bytes}

    def flash(launches):
        return {k: launches[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_simt",
            "flash_bwd_dq_simt", "flash_bwd_dkv_simt")}

    def want_flash(steps):
        return {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                "flash_bwd_dkv": L * steps, "flash_fwd_simt": 0,
                "flash_bwd_dq_simt": 0, "flash_bwd_dkv_simt": 0}

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        REGISTRY.reset(CKPT_METRICS)
        ops.reset_launches()
        return time.perf_counter()

    total = {}
    try:
        # A: uninterrupted
        t0 = start()
        out = run(ARCH, steps=4, chaos=["nan@1"], **kw)
        row["a"] = dict(wall_s=time.perf_counter() - t0,
                        losses=out["losses"],
                        finite=[m["finite"] for m in out["metrics"]],
                        opt_step=int(out["opt"]["step"]),
                        launches=flash(ops.LAUNCHES))
        total = dict(ops.LAUNCHES)
        fp_a = state_fingerprint({"params": out["params"],
                                  "opt": out["opt"]})
        del out

        # B: killed entering step 3, after the step-2 save has landed
        seen = []

        def log_b(i, p, o, m):
            seen.append((i, m["loss"], m["finite"]))
        t0 = start()
        killed = None
        try:
            run(ARCH, steps=4, ckpt_dir=str(ckpt), ckpt_every=2,
                chaos=["nan@1", "kill@3"], on_step=log_b, **kw)
        except ChaosKilled as e:
            killed = {"code": e.code, "step": e.step}
        step_dir = ckpt / "step_00000002"
        row["b"] = dict(wall_s=time.perf_counter() - t0, killed=killed,
                        steps=[i for i, _, _ in seen],
                        losses=[x for _, x, _ in seen],
                        finite=[f for _, _, f in seen],
                        latest_step=latest_step(str(ckpt)),
                        checkpoint_bytes=dir_bytes(step_dir)
                        if step_dir.is_dir() else None,
                        seconds=ckpt_seconds(),
                        launches=flash(ops.LAUNCHES))
        total = {k: total.get(k, 0) + v for k, v in ops.LAUNCHES.items()}
        free["after_step_2"] = shutil.disk_usage(ckpt).free
        room = free["after_step_2"] >= 1.02 * state_bytes
        row["step_2_removed_for_space"] = not room

        # C: restarted from the step-2 checkpoint
        def log_c(i, p, o, m):
            if i == 2 and not room:
                shutil.rmtree(step_dir)
        t0 = start()
        out = run(ARCH, steps=2, ckpt_dir=str(ckpt), ckpt_every=2,
                  on_step=log_c, **kw)
        row["c"] = dict(wall_s=time.perf_counter() - t0,
                        steps=out["steps"], losses=out["losses"],
                        finite=[m["finite"] for m in out["metrics"]],
                        opt_step=int(out["opt"]["step"]),
                        seconds=ckpt_seconds(),
                        launches=flash(ops.LAUNCHES))
        total = {k: total.get(k, 0) + v for k, v in ops.LAUNCHES.items()}
        fp_c = state_fingerprint({"params": out["params"],
                                  "opt": out["opt"]})
        del out
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ok4, why4 = verify_checkpoint(str(ckpt), 4)
        row["verify_step_4"] = dict(ok=ok4, why=why4,
                                    seconds=time.perf_counter() - t0,
                                    checkpoint_bytes=dir_bytes(
                                        ckpt / "step_00000004"))
        free["with_checkpoints"] = shutil.disk_usage(ckpt).free
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        free["after_cleanup"] = shutil.disk_usage(ROOT / "build").free
    row.update(fingerprint_equal=fp_a == fp_c,
               fingerprint_leaves=len(fp_a),
               host_peak_rss_bytes=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024,
               disk_free=free, launches=flash(total))
    emit("recovery", **row)
    a, b, c = row["a"], row["b"], row["c"]
    require(all(math.isfinite(x) for x in a["losses"])
            and a["finite"] == [1.0, 0.0, 1.0, 1.0] and a["opt_step"] == 3,
            f"recovery A: nan@1 not skipped as it should be: {a}")
    require(b["killed"] == {"code": KILL_EXIT_CODE, "step": 3}
            and b["steps"] == [0, 1, 2] and b["latest_step"] == 2,
            f"recovery B: not killed at step 3 after the step-2 save: {b}")
    require(b["losses"] == a["losses"][:3]
            and b["finite"] == a["finite"][:3],
            f"recovery B: losses differ from A's: {b['losses']} vs "
            f"{a['losses'][:3]}")
    require(c["steps"] == [2, 3] and c["losses"] == a["losses"][2:]
            and c["opt_step"] == 3,
            f"recovery C: did not resume bit for bit: steps {c['steps']}, "
            f"losses {c['losses']} vs {a['losses'][2:]}")
    require(row["fingerprint_equal"],
            f"recovery: C's final state differs from A's: "
            f"{[i for i, (x, y) in enumerate(zip(fp_a, fp_c)) if x != y]}")
    require(row["verify_step_4"]["ok"],
            f"recovery: the step-4 save does not verify: {why4}")
    for name, steps in (("a", 4), ("b", 3), ("c", 2)):
        require(row[name]["launches"] == want_flash(steps),
                f"recovery {name}: flash launches "
                f"{row[name]['launches']}, want {want_flash(steps)}")
    return total


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=card,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel from the checkout's sources
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    # each kernel's registers, spills and shared memory; nvcc's warnings
    # (ptxas names a wgmma it had to serialise there)
    ptxas = {n: _build.ptxas_report(_build.build_log(n))
             for n in _build.SOURCES}
    warnings = [ln.strip() for n in _build.SOURCES
                for ln in _build.build_log(n).splitlines()
                if "warning" in ln.lower()]
    emit("build", seconds=time.perf_counter() - t0,
         dir=str(_build.BUILD_DIR.relative_to(ROOT)), warnings=warnings,
         spills={n: sum(r["spill_stores"] + r["spill_loads"] for r in rs)
                 for n, rs in ptxas.items()}, ptxas=ptxas)

    # phase 3: kernels against their plain versions
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = {r["name"]: r for r in (check_flash(flush),
                                   check_flash(flush, FLASH_D256_SHAPE,
                                               "recurrentgemma-9b"),
                                   *check_flash_bwd(flush),
                                   *check_flash_bwd(
                                       flush, shape=FLASH_D256_SHAPE,
                                       arch="recurrentgemma-9b"),
                                   check_paged(False, flush),
                                   check_paged(True, flush),
                                   *check_paper_kernels(flush))}
    # the CUDA-core routes at their sibling's shape in f32 beside its
    # library call in f32, and the flash pair's also at recurrentgemma's
    # shape in bf16 through a padded stride (the kernels the D-256 wgmma
    # routes replaced on that path); lines of their own, not rows of the
    # kernels line
    check_flash(flush, FLASH_SHAPE, dtype=torch.float32)
    check_flash(flush, dict(FLASH_D256_SHAPE, pad=4), "recurrentgemma-9b")
    check_flash_bwd(flush, torch.float32)
    check_flash_bwd(flush, shape=dict(FLASH_D256_SHAPE, pad=4),
                    arch="recurrentgemma-9b")
    for arch, shape in FLASH_ZOO_BWD_SHAPES.items():
        check_flash_bwd(flush, shape=shape, arch=arch)
    check_paper_kernels(flush, torch.float32)
    # every flash route at nonzero q / k offsets
    check_flash_offsets()
    # the same routes at the MoE configs' heads: lines of their own (with
    # ``arch``), not rows of the kernels line
    for arch, shape in (*FLASH_MOE_SHAPES.items(),
                        *FLASH_ZOO_SHAPES.items()):
        check_flash(flush, shape, arch)
    for arch, shape in PAGED_MOE_SHAPES.items():
        check_paged(False, flush, shape, arch)
        check_paged(True, flush, shape, arch)

    # phase 3b: the paper's workloads at their own shapes; 3c: M < 64
    paper = paper_workloads(flush)
    skinny_matmuls(flush)
    del flush
    torch.cuda.empty_cache()

    # phase 4: serve qwen3-4b at full width in the three KV modes
    params = init_params(ARCH)
    served = serve_all(params, ARCH)
    logits_check(params)
    paged_step_check(params)

    # phase 4a: the serving fleet (three hosts sharing those weights)
    fleet = serve_fleet(params)

    # phase 4b: serve olmoe-1b-7b at full width (qwen3-4b's weights stay)
    moe = serve_moe()

    # phase 4c: serve the vlm, hybrid, audio and ssm families at full width
    families = serve_families()

    # phase 5: train at full width (the served weights change in place)
    torch.cuda.empty_cache()
    train_check(params)
    torch.cuda.empty_cache()
    trained = train(params)
    del params
    torch.cuda.empty_cache()

    # phase 5a: the context-parallel ring on a (1, 4) local mesh
    ring = ring_phase()
    torch.cuda.empty_cache()

    # phase 5b: train the vlm, hybrid, audio and ssm families at full width
    families_trained = train_families()

    # phase 6: kill and restart the full-width training from a checkpoint
    recovered = recovery()

    # phase 7: the kernels line (one row per kernel route a main path runs),
    # launches from the paper-workload, serve, serve_fleet, serve_moe,
    # serve_families, train, train_ring, train_families and recovery phases
    phases = (paper, *(r["launches"] for r in served.values()), fleet, moe,
              families, trained["launches"], ring, families_trained,
              recovered)
    launches = {k: sum(ph.get(k, 0) for ph in phases) for k in rows}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms")
    kernels = [{k: ({**r, "launches": launches[r["name"]]})[k] for k in keys}
               for r in rows.values()]
    for r in kernels:
        require(all(v is None or not isinstance(v, float) or math.isfinite(v)
                    for v in r.values()), f"{r['name']}: bad number")
        require(r["launches"] > 0, f"{r['name']}: no launch on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)

    # phase 8: the card, then the result line
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
