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
for a few AdamW steps through ``repro_torch.launch.train``, counts one
more step with the op cost counter on the card and on the meta device
(``roofline``: the two counts equal, the step's share of the bf16 peak;
the live roofline's paged-decode traffic rows of the serve runs and
``conv2d_rows`` through the conv2d kernel), runs the
context-parallel ring on a (1, 4) mesh of local rings on the card (``ring``:
``ring_attention`` at qwen3-4b's and recurrentgemma-9b's heads, each hop
the flash kernels at its offsets, against the unsharded kernels, with a
wholly masked hop's zero-write; ``ring_matmul`` at qwen3-4b's MLP width
against ``torch.matmul`` and its peak against the all-gather's; qwen3-4b's
loss and grads through the ring against the unsharded step, and 3 AdamW
steps of qwen3-4b whole through the ring), the MoE layer's mesh branches
(``moe_mesh``: one layer of olmoe-1b-7b and granite-moe-3b-a800m on each
branch against its per-shard oracle, olmoe served under a (1, 4) local
mesh, granite's loss and grads under (1, 8) against the unsharded step
and 3 AdamW steps of it whole under that mesh), then the four
families (``train_families``: internvl2-26b and recurrentgemma-9b cut to
8 layers, whisper-medium and mamba2-370m whole, every width the config's
own; recurrentgemma's attention backward at head_dim 256 runs the
head_dim-256 wgmma pair, held end to end against the plain path by its
own ``train_check`` and alone at its shape in bf16), drills a kill
and a restart of qwen3-4b's training at full width cut to 1 layer
through the loop's format-v2 checkpoints (``recovery``: the restarted run
must resume bit for bit),
trains qwen3-4b cut to 1 layer with two supervised worker processes
sharing the card (``train_fleet``: a baseline, a chaos kill whose
restarted worker restores rank 0's committed checkpoint and ends
bit-identical, and a gang restart from that run's last checkpoint that
restores striped over the TCP stripe exchange; then the smoke-width
``repro_torch.launch.supervisor``
with and without ``--distributed torch`` and the three
``examples/*_torch.py``), runs the multi-process slice
(``process_mesh``: NCCL at a world of one, then four processes on the
card at the (2, 2) stand-in of ``--mesh single``, training qwen3-4b cut
to 4 layers and serving it paged), and
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
# the card's peaks and each kernel's work have one definition, in the
# package (analysis.roofline, analysis.kernel_work)
from repro_torch.analysis import kernel_work  # noqa: E402
from repro_torch.analysis.op_cost import (CollectiveMode,  # noqa: E402
                                          CostMode)
from repro_torch.analysis.roofline import PEAK_FLOPS  # noqa: E402
ARCH = "qwen3-4b"
MOE_ARCH = "olmoe-1b-7b"
SEED = 0


def _plain(o):
    return o.item() if hasattr(o, "item") else str(o)


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line of ``phase``, with the seconds since the script
    started (``at_s``)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - _T0},
                     default=_plain), flush=True)


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
    b_ms, b_by = kernel_work.flash_fwd_of(qt, kt, causal=causal,
                                          window=window).bound()
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
    works = dict(zip(("flash_bwd_dq", "flash_bwd_dkv"),
                     kernel_work.flash_bwd_of(qt, kt, causal=causal,
                                              window=window)))
    rows = []
    plan = {}
    if route == "flash_bwd_d256":
        p = katt.flash_bwd_dkv_plan(B, Hkv, H // Hkv, Sk)
        plan = dict(plan=dict(parts=p.parts, ctas=p.ctas,
                              scratch_mb=p.scratch_bytes / 2 ** 20))
    for name, work in works.items():
        b_ms, b_by = work.bound()
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
    """The least time of one paged decode call on these lengths
    (``kernel_work.paged_decode``: each live token's K and V rows, and
    scales, read once, q and the table read and out written once, against
    the 4 D H flops a token takes)."""
    q, k, _, table, _, ks, _ = args
    B, H, D = q.shape
    return kernel_work.paged_decode(
        B, H, k.shape[2], D, live_tokens=int(lens_np.sum()),
        max_pages=table.shape[1], kv_itemsize=k.element_size(),
        q_itemsize=q.element_size(), quant=ks is not None).bound()


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


def case_work(case: dict, dtype: torch.dtype = torch.bfloat16):
    """The kernel's work for one case at ``dtype`` (``analysis.kernel_work``,
    from the case's shapes alone): the flops and bytes of its bound."""
    from repro_torch.kernels.conv2d import out_hw
    sh, kind = case["shapes"], case["kernel"]
    size, name = torch.finfo(dtype).bits // 8, str(dtype).split(".")[-1]
    if kind == "matmul":
        return kernel_work.matmul(sh["M"], sh["N"], sh["K"], itemsize=size,
                                  dtype=name)
    if kind == "conv2d":
        (N, IH, IW, CI), (KH, KW, _, CO) = sh["x"], sh["w"]
        OH, OW = out_hw(IH, IW, KH, KW, sh["stride"], sh["dilation"])
        return kernel_work.conv2d(N, IH, IW, CI, KH, KW, CO, OH, OW,
                                  itemsize=size, dtype=name)
    if kind == "correlation":
        return kernel_work.correlation(sh["H"], sh["W"], sh["C"],
                                       sh["radius"], itemsize=size,
                                       dtype=name)
    return kernel_work.flash_decode(sh["B"], sh["H"], sh["Hkv"], sh["D"],
                                    live_tokens=sum(sh["lengths"]),
                                    itemsize=size, dtype=name)


def case_calls(case: dict, seed: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Inputs of one case (numpy, from ``seed``, ``dtype`` on the card,
    scaled so every output has unit variance), and its calls: ``main``
    through ``ops`` as a user calls it, ``launch`` of the kernel alone with
    the same tile (f32: ``main``, the CUDA-core route with the tile ``ops``
    gives it), ``plain`` (the plain version) and ``library`` (one PyTorch
    call of the same function, or None); with its ``work`` (the flops and
    bytes of its bound, :func:`case_work`)."""
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
    calls.setdefault("key", kind)
    if dtype != torch.bfloat16:
        calls["launch"] = calls["main"]
    calls["work"] = case_work(case, dtype)
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
    b_ms, b_by = calls["work"].bound()
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
        row["bound_ms"], row["bound_by"] = kernel_work.matmul(
            M, N, K, itemsize=2).bound()
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
        self.decode_steps = 0       # paged steps of one token a row

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

    def paged_step(self, params, tokens, *a, **kw):
        self.decode_steps += tokens.shape[1] == 1
        return self._watch(self._bundle.paged_step(params, tokens, *a, **kw))


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
    included), any other a prefill (with ``slots`` -1, every call: a
    train step's)."""

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


def serve(mode: str, params, arch: str = ARCH, mesh=None,
          phase: str | None = None, place: bool = False) -> dict:
    """Serve ``workload(mode)`` at ``arch``'s full width (under ``mesh``, a
    mesh of local rings, when given; with ``place`` on a state placed on
    it); for a MoE config the row also gives the share of assignments the
    capacity dropped.  The row's line is ``phase`` (default: ``serve``,
    ``serve_moe`` for a MoE config)."""
    import contextlib

    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    cfg = get_bundle(arch).cfg
    reqs, kw = workload(mode, cfg.vocab)
    max_new = kw["max_new"]
    engine, _ = build_engine(arch, smoke=False, max_len=2048, kv_mode=mode,
                             params=params, device="cuda", mesh=mesh,
                             place=place, **kw)
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
               steps=watch.steps, decode_steps=watch.decode_steps,
               launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               kv=engine.kv_stats(), prefix=engine.prefix_stats())
    if drops is not None:
        row["moe_capacity_drops"] = drops.shares()
    if mode != "dense":
        row["traffic_rows"] = paged_traffic_rows(engine, reqs)
    if mesh is not None:
        row["mesh"] = dict(mesh.shape)
    emit(phase or ("serve_moe" if cfg.moe else "serve"), **row)
    del engine, watch
    torch.cuda.empty_cache()
    return {"row": row, "results": results, "launches": launches}


def paged_traffic_rows(engine, reqs: list[np.ndarray]) -> list[dict]:
    """The live roofline's paged-decode rows of one serve run
    (``obs.roofline_live``): the engine's observed KV traffic against
    ``predict_paged_decode_traffic`` over the same requests, each one's
    prefix-cache hit passed as ``matched``.  The prediction assumes no
    chunk split by the tick's token budget and no early stop; the run
    must give both."""
    from repro_torch.obs.roofline_live import (paged_decode_rows,
                                               predict_paged_decode_traffic)
    cfg = engine.cfg
    require(cfg.prefill_token_budget >= cfg.prefill_chunk * cfg.batch and
            cfg.eos_id == -1, f"paged traffic: budget "
            f"{cfg.prefill_token_budget} < chunk {cfg.prefill_chunk} x "
            f"{cfg.batch} slots, or eos {cfg.eos_id}: the prediction's "
            f"assumptions do not hold")
    matched = [engine._requests[rid].matched_tokens
               for rid in range(len(reqs))]
    predicted = predict_paged_decode_traffic(
        [len(p) for p in reqs], cfg.max_new_tokens,
        page_size=cfg.page_size, page_bytes=engine.kv.cfg.page_bytes,
        prefill_chunk=cfg.prefill_chunk, matched=matched)
    return [dict(r.row(), exact_ratio=r.ratio, matched=matched)
            for r in paged_decode_rows(engine.traffic_stats(), predicted)]


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
    -> the first serve runs' launches, summed, and their tokens by mode
    (``moe_mesh`` compares its meshed runs with them)."""
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
    results = {m: r["results"] for m, r in runs.items()}
    del params, runs
    torch.cuda.empty_cache()
    return {"launches": launches, "results": results}


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
            and launches["flash_fwd"] == L * 3
            and launches["flash_fwd_simt"] == 0
            and launches["flash_bwd_dq_simt"] == 0
            and launches["flash_bwd_dkv_simt"] == 0,
            f"train: flash launches {launches}, want wgmma bwd {L * 3} each, "
            f"wgmma fwd {L * 3} (the forward only: the per-layer recompute "
            f"keeps attn_out) and no CUDA-core flash kernel")
    del out
    return row


# ---------------------------------------------------------------------------
# phase 5': the analysis slice on the card: the op cost counter's count of
# qwen3-4b's full-width train step against the same step on the meta
# device, the step's share of the bf16 peak, and the live roofline's rows
# ---------------------------------------------------------------------------

ROOFLINE_BATCH = dict(B=2, S=2048)


class OpLog(CostMode):
    """A cost counter that keeps each op that counted something (name,
    flops, bytes, operand shapes), to show where two counts of one step
    part."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        f, b = self.cost.flops, self.cost.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (self.cost.flops, self.cost.bytes) != (f, b):
            self.log.append((str(func), self.cost.flops - f,
                             self.cost.bytes - b,
                             [tuple(t.shape) for t in args
                              if isinstance(t, torch.Tensor)]))
        return out


def first_difference(a: list, b: list, n: int = 12) -> list:
    """The first ``n`` entries from where two op logs part."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return [dict(at=i + j, card=a[i + j] if i + j < len(a) else None,
                 meta=b[i + j] if i + j < len(b) else None)
            for j in range(n)]


def roofline_phase(params, served: dict) -> dict:
    """The analysis slice on the card.  One AdamW step of qwen3-4b at full
    width (B 2 x S 2048, one microbatch, the flash kernels reporting their
    own work) counted by ``analysis.op_cost`` on the card and the same step
    on the meta device: flops, bytes and collectives must be equal,
    exactly.  The step's share of the bf16 peak, by the counted flops and
    by 6 N tokens, from a step timed outside the counter.  Then the live
    roofline's rows (``obs.roofline_live``): the serve phase's paged runs
    (gb ratio 1 exactly, dram within its tolerance) and ``conv2d_rows`` at
    DL_ATROUS4 through the hand-written conv2d kernel (one launch).
    Returns the phase's launches."""
    from repro_torch.analysis.roofline import model_flops_train
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.obs.roofline_live import TOLERANCES, conv2d_rows
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHyper, make_train_step
    t0 = time.perf_counter()
    card = smi()
    bundle = get_bundle(ARCH)
    L = bundle.cfg.n_layers
    B, S = ROOFLINE_BATCH["B"], ROOFLINE_BATCH["S"]
    batch = token_batch(B, S, SEED + 13, bundle.cfg.vocab)
    step = make_train_step(bundle.forward, TrainHyper())
    opt = adamw_init(params)
    phase_launches: dict = {}

    def take_launches():
        for k, n in ops.LAUNCHES.items():
            phase_launches[k] = phase_launches.get(k, 0) + n
        return dict(ops.LAUNCHES)

    # the step timed outside the counter (the second of two)
    ops.reset_launches()
    step_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    take_launches()
    # the count on the card, then on meta tensors of the same shapes and
    # dtypes (the dry run's arguments)
    ops.reset_launches()
    t = time.perf_counter()
    with CostMode() as on_card:
        step(params, opt, batch)
    torch.cuda.synchronize()
    card_count_s = time.perf_counter() - t
    counted_launches = take_launches()
    meta_params = bundle.abstract_params()
    meta_args = (meta_params, adamw_init(meta_params),
                 {k: torch.empty_like(v, device="meta")
                  for k, v in batch.items()})
    t = time.perf_counter()
    with CostMode() as on_meta:
        step(*meta_args)
    meta_count_s = time.perf_counter() - t
    c, m = on_card.cost, on_meta.cost
    equal = c.totals() == m.totals() and c.kernels == m.kernels
    mflops = model_flops_train(bundle.active_param_count(), B * S)
    timed = step_s[-1]
    row = dict(arch=ARCH, B=B, S=S, microbatches=1, nvidia_smi=card,
               counted_flops=c.flops, counted_bytes=c.bytes,
               collectives=c.collectives, meta_flops=m.flops,
               meta_bytes=m.bytes, meta_collectives=m.collectives,
               card_equals_meta=equal, kernels=c.kernels,
               model_flops=mflops, model_over_counted=mflops / c.flops,
               step_s=step_s,
               counted_share_of_bf16_peak=c.flops / (timed * PEAK_FLOPS),
               model_share_of_bf16_peak=mflops / (timed * PEAK_FLOPS),
               intermediates_peak_bytes=on_card.peak_bytes,
               card_count_s=card_count_s, meta_count_s=meta_count_s,
               launches={k: n for k, n in counted_launches.items() if n})
    emit("roofline_step", **row)
    print(f"roofline_step: counted {c.flops:.6e} flops, model 6 N tokens "
          f"{mflops:.6e} (ratio {mflops / c.flops:.4f}); share of the bf16 "
          f"peak {row['counted_share_of_bf16_peak']:.4f} counted, "
          f"{row['model_share_of_bf16_peak']:.4f} model, step {timed:.4f} "
          f"s on {card}", flush=True)
    if not equal:
        logs = []
        for args in ((params, opt, batch), meta_args):
            mode = OpLog()
            with mode:
                step(*args)
            logs.append(mode.log)
        emit("roofline_step_diff", ops=[len(x) for x in logs],
             first=first_difference(*logs))
    del opt, meta_args, meta_params
    torch.cuda.empty_cache()
    require(equal, f"roofline: the card's count {c.totals()} "
            f"{c.kernels} differs from the meta count {m.totals()} "
            f"{m.kernels}")
    flash = {k: n for k in FLASH_ROUTE_KEYS if (n := counted_launches[k])}
    require(flash == {"flash_fwd": L, "flash_bwd_dq": L,
                      "flash_bwd_dkv": L} and
            {k: v["calls"] for k, v in c.kernels.items()} ==
            {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L},
            f"roofline: flash launches {flash} and reports "
            f"{c.kernels}, want {L} of the forward and of each backward")

    # the live roofline's rows
    for mode in ("paged", "paged_int8"):
        rows = served[mode]["row"]["traffic_rows"]
        emit("roofline_traffic", workload="paged_decode", mode=mode,
             rows=rows, nvidia_smi=card)
        gb = [r for r in rows if r["level"] == "gb"]
        dram = [r for r in rows if r["level"] == "dram"]
        require(all(r["exact_ratio"] == 1.0 for r in gb) and
                all(r["within"] and r["tolerance"] == TOLERANCES["dram"]
                    for r in dram),
                f"roofline: {mode} traffic rows {rows}")
    case = {c_["name"]: c_ for c_ in catalog_cases()}["DL_ATROUS4"]["shapes"]
    (N, IH, IW, CI), (KH, KW, _, CO) = case["x"], case["w"]
    ops.reset_launches()
    conv = conv2d_rows(N, IH, IW, CI, CO, KH, KW, dtype_bytes=2,
                       stride=case["stride"], dilation=case["dilation"],
                       device="cuda")
    torch.cuda.synchronize()
    conv_launches = take_launches()
    emit("roofline_traffic", workload="conv2d DL_ATROUS4",
         rows=[r.row() for r in conv], launches={
             k: n for k, n in conv_launches.items() if n}, nvidia_smi=card)
    require(conv_launches["conv2d"] == 1 and
            sum(conv_launches.values()) == 1 and all(r.within for r in conv),
            f"roofline: conv2d rows {[r.row() for r in conv]}, launches "
            f"{conv_launches}")
    emit("roofline", seconds=time.perf_counter() - t0, nvidia_smi=card)
    return phase_launches


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
    require(lna.get("flash_fwd") == hops and
            lna.get("flash_bwd_dq") == lna.get("flash_bwd_dkv") == hops and
            lnb.get("flash_fwd") == L,
            f"ring_train_check launches: ring {lna}, unsharded {lnb}")
    return row


def train_ring(params) -> dict:
    """Three AdamW steps of qwen3-4b at full width and depth (B 1 x S
    4,096, one microbatch) through ``launch.train.run`` under the (1,
    RING_M) local mesh, on ``params`` (updated in place): finite losses,
    probed params moved, ``opt_step`` 3, the peak under 80 GB, and the
    flash launches of the formula: each of L layers folds m ranks x m
    hops, the forward once (the per-layer recompute keeps the ring's o and
    lse), each backward kernel once."""
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
              mesh_kind=mesh, params=params, place=False)
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    changed = {k: not torch.equal(before[k], f()) for k, f in probes.items()}
    steps_s = out["seconds"]
    tokens = RING_TRAIN["B"] * RING_TRAIN["S"]
    n = L * RING_M * RING_M * TRAIN_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
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
# phase 5c: the MoE layer's mesh branches (expert parallel over a split
# sequence or replicated tokens, token split, TP in expert) on local
# meshes: one layer of each config against its per-shard oracle, olmoe-1b-7b
# served under a (1, 4) mesh, granite-moe-3b-a800m trained under (1, 8)
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-3b-a800m"
# one MoE layer at its config's full width (olmoe E 64, top 8, D 2,048,
# F 1,024; granite E 40, top 8, D 1,536, F 512), bf16, the config's
# capacity factor 1.25, under a (1, m) mesh: 64 experts split over 4 ranks,
# 40 over 8; 40 do not split over 16, so granite's 4,096 tokens take the
# token split there and its 8 decode tokens the TP-in-expert branch
MOE_MESH_CASES = {
    "olmoe_ep": dict(arch=MOE_ARCH, m=4, B=1, S=4096),
    "olmoe_ep_decode": dict(arch=MOE_ARCH, m=4, B=8, S=1),
    "granite_ep": dict(arch=GRANITE, m=8, B=1, S=4096),
    "granite_split": dict(arch=GRANITE, m=16, B=1, S=4096),
    "granite_tp": dict(arch=GRANITE, m=16, B=8, S=1),
}
MOE_SERVE_M = 4
# granite-moe-3b-a800m whole (32 layers; 40.5 GB of state at 12 bytes a
# parameter), the 4,096 tokens of one row over a (1, 8) mesh: EP for the
# MoE layers, the ring for attention (S >= 4,096, S_l 512)
MOE_TRAIN = dict(m=8, B=1, S=4096)
MOE_TOL = 2.0 ** -6


def moe_branch(E: int, S: int, m: int) -> str:
    """The branch ``moe_layer`` takes for E experts, S tokens a row, on a
    model axis of m ranks."""
    if E % m == 0:
        return "ep" if S % m == 0 else "ep_replicated"
    return "token_split" if S % m == 0 else "tp"


def moe_closeness(got: torch.Tensor, want: torch.Tensor,
                  terms: torch.Tensor | None = None,
                  elementwise: bool = True) -> dict:
    """A bf16 MoE output or gradient against its per-shard oracle (bf16
    too), rows along the last axis.  The two run the expert GEMMs on
    buffers of other shapes (the EP's (E/m, m c, D) against the oracle's
    (E, c, D); the TP on F/m columns), so their f32 sums run in other
    orders and a rounded bf16 intermediate (the SwiGLU's h, the experts'
    outputs) may differ by one ulp, 2^-8 of itself, which the sums after
    it carry; the TP also rounds each rank's partial output to bf16 before
    the sum, as the reference does, an error that scales with the
    partials' magnitudes (``terms``: the sum of their absolute values).
    Each element within 2^-6 (|want| + its row's RMS + terms), each row's
    L2 error within 2^-6 (its norm + the tensor's RMS row norm: a dropped
    token's row is ~0), the tensor's relative L2 under 2^-7.  A token
    sent to another expert or slot moves its row by O(1).  Without
    ``elementwise`` (the experts' gradients: the oracle adds m shards'
    gradients, each rounded to bf16, where the EP forms each in one
    product over all its slots, so an element may move by 2^-9 of each
    shard's part, which its row and the tensor do not show), the element
    bound is not applied."""
    got, want = got.float(), want.float()
    if want.dim() < 2:
        got, want = got.reshape(1, -1), want.reshape(1, -1)
    diff = (got - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    scale = want.abs() + rms + (0 if terms is None else terms.float())
    ratio = (diff / (MOE_TOL * scale).clamp_min(1e-30)).max().item()
    rows = want.norm(dim=-1)
    row_tol = MOE_TOL * (rows + rows.pow(2).mean().sqrt())
    row_ratio = (diff.norm(dim=-1) / row_tol.clamp_min(1e-30)).max().item()
    rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    return dict(max_abs_err=diff.max().item(), worst_tol_ratio=ratio,
                worst_row_tol_ratio=row_ratio, tensor_rel_l2=rel,
                within_tol=(ratio <= 1.0 or not elementwise) and
                row_ratio <= 1.0 and rel <= MOE_TOL / 2)


def check_moe_layer(name: str, arch: str, m: int, B: int, S: int,
                    dims: tuple | None = None) -> dict:
    """One MoE layer of ``arch`` (or at ``dims`` = (E, K, D, F)) with
    random bf16 weights (std 0.02, as the model's init) and unit-normal
    tokens from ``SEED``, under a (1, m) local mesh against its oracle:
    ``_moe_local`` on each rank's own tokens, concatenated, where the
    tokens split (per-rank capacity: the drops differ from a global
    dispatch), else ``_moe_local`` on all of them.  Drops (each rank's,
    in rank order) must equal the oracle's
    exactly, aux within 1e-6 relative, out (and, where the tokens split,
    the grads of sum(out g) + aux for x and the four weights) by
    :func:`moe_closeness`.  ``ms_mesh`` / ``ms_oracle`` time the layer's
    forward under the mesh and the oracle's, both bf16."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.models import layers
    from repro_torch.parallel import make_mesh, set_mesh
    mcfg = get_bundle(arch).cfg
    cfg, D = mcfg.moe, mcfg.d_model
    if dims is not None:
        E, K, D, Fe = dims
        cfg = dataclasses.replace(cfg, n_experts=E, top_k=K, d_ff=Fe)
    E, K, Fe = cfg.n_experts, cfg.top_k, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def nrm(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(torch.bfloat16)
    p = {"router": nrm(D, E, scale=0.02), "w_gate": nrm(E, D, Fe, scale=0.02),
         "w_up": nrm(E, D, Fe, scale=0.02),
         "w_down": nrm(E, Fe, D, scale=0.02)}
    x, dout = nrm(B, S, D), nrm(B, S, D)
    branch = moe_branch(E, S, m)
    split = S % m == 0
    mesh = make_mesh((1, m), ("data", "model"))
    ring = mesh.transport("model")
    a2a = {"calls": 0, "bytes": 0}
    inner_a2a = ring.all_to_all

    def counted_a2a(xs):
        a2a["calls"] += 1
        a2a["bytes"] += sum(t.numel() * t.element_size() for t in xs)
        return inner_a2a(xs)
    ring.all_to_all = counted_a2a

    def meshed(pp, xx):
        with set_mesh(mesh):
            return layers.moe_layer(xx, pp, cfg)

    def oracle(pp, xx):
        if not split:
            return layers._moe_local(xx, pp, cfg)
        runs = [layers._moe_local(x_r, pp, cfg) for x_r in xx.chunk(m, 1)]
        aux = runs[0][1]
        for _, a in runs[1:]:
            aux = aux + a
        return torch.cat([o for o, _ in runs], 1), aux / m

    def run(fn):
        """``fn``'s out, aux, each call's drops and the grads."""
        drops, inner = [], layers._moe_slots

        def counted(gate_idx, E_, C):
            pos, keep = inner(gate_idx, E_, C)
            drops.append((~keep).sum())
            return pos, keep
        leaves = [x, *p.values()] if split else []
        layers._moe_slots = counted
        try:
            for t in leaves:
                t.requires_grad_(True)
            out, aux = fn(p, x)
            grads = torch.autograd.grad(
                (out.float() * dout.float()).sum() + aux, leaves) \
                if leaves else ()
        finally:
            layers._moe_slots = inner
            for t in leaves:
                t.requires_grad_(False)
        return (out.detach(), aux.detach(), [int(d) for d in drops],
                list(grads))

    t0 = time.perf_counter()
    got, want = run(meshed), run(oracle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    terms = None
    if branch == "tp":
        # the partials the TP rounds before its sum, by magnitude
        with torch.no_grad():
            terms = sum(layers._moe_local(x, {
                "router": p["router"], "w_gate": wg, "w_up": wu,
                "w_down": wd}, cfg)[0].float().abs()
                for wg, wu, wd in zip(p["w_gate"].chunk(m, 2),
                                      p["w_up"].chunk(m, 2),
                                      p["w_down"].chunk(m, 1)))
    calls, a2a_bytes = a2a["calls"], a2a["bytes"]
    with torch.no_grad():
        ms = (time_ms(lambda: meshed(p, x), 3)[0],
              time_ms(lambda: oracle(p, x), 3)[0])
    want_drops = want[2] if split else want[2] * m
    names = ["x", *p]
    row = dict(case=name, arch=arch, branch=branch, E=E, K=K, D=D, F=Fe,
               capacity_factor=cfg.capacity_factor, m=m, B=B, S=S,
               drops=got[2], oracle_drops=want[2],
               dropped_share=sum(got[2]) / (len(got[2]) * B * S * K //
                                            (m if split else 1)),
               aux=got[1].item(), oracle_aux=want[1].item(),
               all_to_all_calls=calls, all_to_all_bytes=a2a_bytes,
               out=moe_closeness(got[0], want[0], terms),
               grads={n: moe_closeness(a, b, elementwise=not
                                       n.startswith("w_"))
                      for n, a, b in zip(names, got[3], want[3])},
               ms_mesh=ms[0], ms_oracle=ms[1], seconds=seconds,
               tol=f"drops equal; aux rel 1e-6; |err| <= 2^-6 (|want| + "
                   f"row RMS + the TP partials' |sum|); row L2 <= 2^-6 "
                   f"(row norm + RMS row norm); tensor rel L2 <= 2^-7")
    emit("moe_layer_mesh", **row)
    require(got[2] == want_drops, f"{name}: drops {got[2]}, oracle "
            f"{want_drops}")
    require(abs(row["aux"] - row["oracle_aux"]) <=
            1e-6 * abs(row["oracle_aux"]), f"{name}: aux {row['aux']} vs "
            f"{row['oracle_aux']}")
    require(row["out"]["within_tol"] and
            all(c["within_tol"] for c in row["grads"].values()),
            f"{name}: out or grads beyond the bound: {row}")
    require(calls == (2 if branch.startswith("ep") else 0),
            f"{name}: {calls} all-to-alls on the {branch} branch")
    return row


def moe_logits_check(params, mesh, n: int = 1536) -> dict:
    """The first token's logits of one ``n``-token prompt served by a
    paged olmoe-1b-7b engine under ``mesh`` against the same engine with
    no mesh, at capacity factor E / K, where no assignment drops (so the
    rows a call batches cannot change a token's experts): ``logits_check``'s
    limits, cosine > 0.99 and finite."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import build_engine
    bundle = get_bundle(MOE_ARCH)
    moe = bundle.cfg.moe
    bundle = dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k)))
    prompt = prompts(1, n, n, SEED + 9, bundle.cfg.vocab)[0]
    out, drops = {}, {}
    with torch.no_grad():
        for name, msh in (("mesh", mesh), ("unsharded", None)):
            engine, _ = build_engine(
                bundle, max_len=2048, kv_mode="paged", slots=4, max_new=2,
                page_size=16, prefill_chunk=256, prefill_token_budget=1024,
                params=params, device="cuda", mesh=msh)
            with DropWatch(4) as dw:
                out[name] = token_logits(engine, prompt, 1)[0]
            drops[name] = dw.shares()
            del engine
    a, b = out["mesh"], out["unsharded"]
    cos = F.cosine_similarity(a, b, dim=0).item()
    row = dict(arch=MOE_ARCH, prompt=n, mesh=dict(mesh.shape),
               capacity_factor=moe.n_experts / moe.top_k, cosine=cos,
               max_abs_diff=(a - b).abs().max().item(),
               top1_equal=bool(a.argmax() == b.argmax()),
               finite=bool(torch.isfinite(a).all()), drops=drops)
    emit("moe_mesh_logits_check", **row)
    require(row["finite"] and cos > 0.99 and
            all(d["dropped"] == 0 for v in drops.values()
                for d in v.values()),
            f"moe_mesh: meshed vs unsharded first-token logits: {row}")
    return row


def serve_moe_mesh(unsharded: dict) -> dict:
    """olmoe-1b-7b at full width served under a (1, MOE_SERVE_M) local
    mesh in ``paged`` and ``paged_int8`` with ``serve_moe``'s requests
    (EP on prefill chunks, split over ``model``, so each rank holds a
    quarter of a chunk's capacity; EP on replicated decode tokens), then
    ``paged`` again (same tokens and drops required); both paged decode
    kernels must launch more than once.  The tokens' agreement with
    ``serve_moe``'s unsharded runs is printed, not required: the per-rank
    capacity drops other assignments.  -> the first runs' launches."""
    from repro_torch.parallel import make_mesh
    params = init_params(MOE_ARCH)
    mesh = make_mesh((1, MOE_SERVE_M), ("data", "model"))
    with torch.no_grad():
        runs = {m: serve(m, params, MOE_ARCH, mesh=mesh,
                         phase="serve_moe_mesh")
                for m in ("paged", "paged_int8")}
        again = serve("paged", params, MOE_ARCH, mesh=mesh,
                      phase="serve_moe_mesh")
    launches: dict[str, int] = {}
    for r in runs.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    same = (again["results"] == runs["paged"]["results"] and
            again["row"]["moe_capacity_drops"] ==
            runs["paged"]["row"]["moe_capacity_drops"])
    emit("serve_moe_mesh_repeat", arch=MOE_ARCH, mode="paged", equal=same,
         agreement_with_unsharded={m: agreement(runs[m]["results"],
                                                unsharded[m])
                                   for m in runs})
    for key in ("paged_decode_bf16", "paged_decode_int8"):
        require(launches.get(key, 0) > 1,
                f"serve_moe_mesh: {key} launched {launches.get(key, 0)} "
                f"times, want more than once")
    require(same, "serve_moe_mesh: paged served again under the mesh gave "
            "other tokens or drops")
    moe_logits_check(params, mesh)
    del params, runs, again
    torch.cuda.empty_cache()
    return launches


def moe_train_check(params, mesh) -> dict:
    """granite-moe-3b-a800m's loss and gradients of one B 1 x S 4,096
    batch under ``mesh`` (EP over 8 ranks, the ring for attention, each
    hop the flash kernels) against the same batch with no mesh (the local
    dispatch, the unsharded flash kernels), at capacity factor E / K,
    where nothing drops, by ``ring_train_check``'s leaves and limits: loss
    rel diff < 1e-3, per leaf cosine > 0.99 and |norm ratio - 1| <
    NORM_TOL, for the embedding and wq, wk and wv of the first and the
    last layer.  The aux loss under a mesh is the mean of the ranks' own
    balance terms (the reference's), not the term of all tokens, so both
    losses take it at weight 0 here; both values are printed.  The MoE
    leaves (router, w_gate, w_down of the first and the last layer) are
    printed, not held: top-k routing is discontinuous, and the two paths'
    bf16 hidden states (the ring against the unsharded kernels, the
    experts' GEMMs over other buffers) part by rounding, which swaps
    near-tied experts of some tokens, more of them with depth
    (``route_flips``: tokens whose experts differ, a layer, in the step's
    forward); the layer cases hold them where the routes are the same."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.parallel import set_mesh
    from repro_torch.training import loss_fn
    bundle = get_bundle(GRANITE)
    moe = bundle.cfg.moe
    bundle = dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k)))
    stack = params["layers"]
    batch = token_batch(MOE_TRAIN["B"], MOE_TRAIN["S"], SEED + 11,
                        bundle.cfg.vocab)
    L = stack["wq"].shape[0]
    held = ("wq", "wk", "wv")
    names = (*held, "router", "w_gate", "w_down")
    leaves = [params["embed"], *(stack[n] for n in names)]
    out = {}
    for msh in (mesh, None):
        ranks = msh.shape["model"] if msh else 1
        routes, inner = [], layers._moe_slots

        def logged(gate_idx, E, C):
            # the forward's calls come first: L layers x the ranks
            if len(routes) < L * ranks:
                routes.append(gate_idx.sort(-1).values)
            return inner(gate_idx, E, C)
        for p in leaves:
            p.requires_grad_(True)
        ops.reset_launches()
        layers._moe_slots = logged
        try:
            with set_mesh(msh), DropWatch(-1) as dw:
                loss, (ce, aux) = loss_fn(bundle.forward, params, batch,
                                          aux_weight=0.0)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            layers._moe_slots = inner
        launches = {n: c for n, c in ops.LAUNCHES.items() if c}
        for p in leaves:
            p.requires_grad_(False)
        got = {"embed": grads[0]}
        for n, gr in zip(names, grads[1:]):
            got[f"{n}[0]"], got[f"{n}[{L - 1}]"] = gr[0].clone(), \
                gr[L - 1].clone()
        per_layer = [torch.cat(routes[i * ranks:(i + 1) * ranks])
                     for i in range(L)]
        out["mesh" if msh else "unsharded"] = (
            loss.item(), aux.item(), got, launches,
            dw.shares()["prefill"]["dropped"], per_layer)
        del grads, loss
    (la, xa, ga, lna, da, ra), (lb, xb, gb, lnb, db, rb) = out["mesh"], \
        out["unsharded"]
    flips = [int((a != b).any(-1).sum()) for a, b in zip(ra, rb)]
    cos = {k: F.cosine_similarity(ga[k].float().flatten(),
                                  gb[k].float().flatten(), dim=0).item()
           for k in ga}
    ratio = {k: (ga[k].float().norm() / gb[k].float().norm()).item()
             for k in ga}
    rel = abs(la - lb) / abs(lb)
    required = [k for k in ga if k == "embed" or k.split("[")[0] in held]
    row = dict(arch=GRANITE, **MOE_TRAIN, capacity_factor=moe.n_experts /
               moe.top_k, loss_mesh=la, loss_unsharded=lb,
               loss_rel_diff=rel, aux_mesh=xa, aux_unsharded=xb,
               dropped=[da, db], route_flips=flips, cosine=cos,
               norm_ratio=ratio, held=required, launches_mesh=lna,
               launches_unsharded=lnb,
               tol=f"loss rel diff < 1e-3; per held leaf cosine > 0.99 and "
                   f"|norm ratio - 1| < {NORM_TOL}; aux at weight 0")
    emit("moe_train_check", **row)
    require(math.isfinite(la) and rel < 1e-3 and da == db == 0 and
            all(cos[k] > 0.99 for k in required) and
            all(abs(ratio[k] - 1.0) < NORM_TOL for k in required),
            f"moe_mesh: meshed vs unsharded loss/grads: {row}")
    return row


def train_moe_mesh(params, mesh) -> dict:
    """Three AdamW steps of granite-moe-3b-a800m at full width and depth
    (B 1 x S 4,096, the config's capacity) through ``launch.train.run``
    under ``mesh``, on ``params`` (updated in place): finite losses,
    ``opt_step`` 3, the peak under 80 GB, and the flash kernels of the
    ring launched (L x m x m a pass, the forward once: the recompute
    keeps attn_out)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    L = params["layers"]["wq"].shape[0]
    m = MOE_TRAIN["m"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with DropWatch(-1) as dw:
        out = run(GRANITE, smoke=False, steps=TRAIN_STEPS,
                  seq_len=MOE_TRAIN["S"], global_batch=MOE_TRAIN["B"],
                  microbatches=1, device="cuda", mesh_kind=mesh,
                  params=params, place=False)
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    steps_s = out["seconds"]
    tokens = MOE_TRAIN["B"] * MOE_TRAIN["S"]
    n = L * m * m * TRAIN_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    row = dict(arch=GRANITE, **MOE_TRAIN, steps=len(steps_s),
               losses=out["losses"],
               finite=[x["finite"] for x in out["metrics"]],
               aux=[float(x["aux"]) for x in out["metrics"]],
               grad_norm=[x["grad_norm"] for x in out["metrics"]],
               s_per_step=steps_s,
               tok_per_s_after_first=tokens * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall, max_memory_allocated=peak,
               opt_step=int(out["opt"]["step"]),
               drops=dw.shares()["prefill"], launches=launches,
               want_flash=want, nvidia_smi=smi())
    emit("train_moe_mesh", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and
            len(steps_s) == TRAIN_STEPS and row["opt_step"] == TRAIN_STEPS,
            f"train_moe_mesh: a loss, finite flag or step count is bad: "
            f"{row}")
    require(peak < 80e9, f"train_moe_mesh: peak {peak} bytes")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} ==
            dict(dict.fromkeys(FLASH_KEYS, 0), **want),
            f"train_moe_mesh: flash launches {launches}, want {want}")
    del out
    return launches


def moe_mesh_phase(unsharded: dict) -> dict:
    """Phase 5c: the five layer cases, olmoe-1b-7b served under a (1, 4)
    mesh (``unsharded``: ``serve_moe``'s tokens by mode), granite's meshed
    train check and its three steps under (1, 8); returns the served and
    trained runs' launches (the main path's) for the kernels line."""
    from repro_torch.parallel import make_mesh
    t0 = time.perf_counter()
    for name, case in MOE_MESH_CASES.items():
        check_moe_layer(name, **case)
        torch.cuda.empty_cache()
    served = serve_moe_mesh(unsharded)
    params = init_params(GRANITE)
    mesh = make_mesh((1, MOE_TRAIN["m"]), ("data", "model"))
    moe_train_check(params, mesh)
    torch.cuda.empty_cache()
    trained = train_moe_mesh(params, mesh)
    del params
    torch.cuda.empty_cache()
    emit("moe_mesh", seconds=time.perf_counter() - t0)
    return {k: served.get(k, 0) + trained.get(k, 0)
            for k in served.keys() | trained.keys()}


# ---------------------------------------------------------------------------
# phase 5d: the sharded state: qwen3-4b's params and AdamW moments placed by
# param_specs on meshes of local rings (heads, features and vocab split
# over "model", rows over "data"), trained under (2, 4), served under (1, 4)
# ---------------------------------------------------------------------------

SHARDED = dict(train=(2, 4), serve=(1, 4), B=2, S=2048)
SHARDED_LEAVES = ("embed", "lm_head", "wq", "wk", "wv", "wo", "w_down")


def sharded_mesh(kind: str):
    from repro_torch.parallel import make_mesh
    return make_mesh(SHARDED[kind], ("data", "model"))


def sp_collectives(mode, mesh, S: int) -> dict:
    """A step's collective bytes by kind from the op cost counter (a local
    ring's counted at every rank), and whether its residual was
    sequence-sharded (the model axis divides S: ``layers.shard_seq``'s
    rule)."""
    m = mesh.shape.get("model", 1)
    return {"by_kind": {k: int(v) for k, v in mode.cost.collectives.items()},
            "seq_sharded": m > 1 and S % m == 0}


def sharded_train_check(params, mesh, bundle=None) -> dict:
    """Loss and gradients of one (B 2, S 2048) batch on qwen3-4b's state
    placed on ``mesh`` (each data rank's row in turn, each model rank's
    heads through the flash kernels) against the unsharded step's, both
    under per-layer recompute: ``train_check``'s limits (loss rel diff <
    1e-3; per leaf cosine > 0.99 and |norm ratio - 1| < NORM_TOL) on the
    embedding, the lm_head, and wq, wk, wv, wo and w_down of the first and
    the last layer; the flash kernels launched L x nd x m times a pass
    (the forward once: the recompute keeps attn_out), none of them
    CUDA-core.  ``bundle``: qwen3-4b's
    (default) or one cut in depth (the card tests)."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import (Placed, gather_leaf,
                                               param_specs, shard_tree)
    from repro_torch.training import TrainHyper, loss_fn
    from repro_torch.training.step import placed_grads
    bundle = bundle or get_bundle(ARCH)
    L = bundle.cfg.n_layers
    batch = token_batch(SHARDED["B"], SHARDED["S"], SEED + 11,
                        bundle.cfg.vocab)

    def pick(tree):
        return [tree[n] if n in ("embed", "lm_head") else tree["layers"][n]
                for n in SHARDED_LEAVES]

    def slices(grads) -> dict:
        out = {}
        for n, g in zip(SHARDED_LEAVES, grads):
            if n in ("embed", "lm_head"):
                out[n] = g
            else:
                out[f"{n}[0]"], out[f"{n}[{L - 1}]"] = g[0].clone(), \
                    g[L - 1].clone()
        return out

    leaves = pick(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_u, _ = loss_fn(bundle.forward, params, batch)
    grads = torch.autograd.grad(loss_u, leaves)
    for p in leaves:
        p.requires_grad_(False)
    want, loss_u = slices(grads), loss_u.item()
    del grads
    torch.cuda.empty_cache()

    placed = shard_tree(params, param_specs(bundle.kind, params, mesh), mesh)
    sel = pick(placed)
    shards = [t for leaf in sel for t in leaf.tensors()]
    for t in shards:
        t.requires_grad_(True)
    ops.reset_launches()
    with CollectiveMode() as coll:
        loss_s, _, _, gs = placed_grads(bundle.forward, TrainHyper(),
                                        placed, shards, batch)
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    for t in shards:
        t.requires_grad_(False)
    it = iter(gs)
    got = slices([gather_leaf(Placed(leaf.shape, leaf.dtype, leaf.spec,
                                     mesh, {k: next(it) for k in
                                            sorted(leaf.shards)}))
                  for leaf in sel])
    loss_s = loss_s.item()
    del placed, sel, shards, gs
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(got[k].float().flatten(),
                                  want[k].float().flatten(), dim=0).item()
           for k in want}
    ratio = {k: (got[k].float().norm() / want[k].float().norm()).item()
             for k in want}
    rel = abs(loss_s - loss_u) / abs(loss_u)
    nd, m = SHARDED["train"]
    n = L * nd * m
    flash = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    row = dict(arch=ARCH, n_layers=L, mesh=dict(mesh.shape), B=SHARDED["B"],
               S=SHARDED["S"], loss_sharded=loss_s, loss_unsharded=loss_u,
               loss_rel_diff=rel, cosine=cos, norm_ratio=ratio,
               launches=launches, want_flash=flash,
               collective_bytes=sp_collectives(coll, mesh, SHARDED["S"]),
               tol=f"loss rel diff < 1e-3; per leaf cosine > 0.99 and "
                   f"|norm ratio - 1| < {NORM_TOL}")
    emit("sharded_train_check", **row)
    require(math.isfinite(loss_s) and rel < 1e-3 and
            all(c > 0.99 for c in cos.values()) and
            all(abs(r - 1.0) < NORM_TOL for r in ratio.values()),
            f"sharded: placed vs unsharded loss/grads: {row}")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} ==
            dict(dict.fromkeys(FLASH_KEYS, 0), **flash),
            f"sharded: flash launches {launches}, want {flash}")
    coll = row["collective_bytes"]
    require(coll["seq_sharded"] and
            coll["by_kind"].get("reduce-scatter", 0) > 0,
            f"sharded: the sequence-sharded residual's reduce-scatter is "
            f"missing: {coll}")
    return row


def sharded_logits_check(params, mesh, n: int = 1536, arch=ARCH) -> dict:
    """The first token's logits of one ``n``-token prompt served by a paged
    engine on the state placed on ``mesh`` against the same engine on the
    unsharded state: cosine > 0.99, the same top-1, finite.  ``arch``: a
    name or a bundle (one cut in depth)."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import build_engine
    bundle = get_bundle(arch) if isinstance(arch, str) else arch
    prompt = prompts(1, n, n, SEED + 9, bundle.cfg.vocab)[0]
    out = {}
    with torch.no_grad():
        for name, msh in (("sharded", mesh), ("unsharded", None)):
            engine, _ = build_engine(
                arch, smoke=False, max_len=2048, kv_mode="paged", slots=4,
                max_new=2, page_size=16, prefill_chunk=256,
                prefill_token_budget=1024, params=params, device="cuda",
                mesh=msh, place=msh is not None)
            out[name] = token_logits(engine, prompt, 1)[0]
            del engine
            torch.cuda.empty_cache()
    a, b = out["sharded"], out["unsharded"]
    cos = F.cosine_similarity(a, b, dim=0).item()
    row = dict(arch=ARCH, prompt=n, mesh=dict(mesh.shape), cosine=cos,
               n_layers=bundle.cfg.n_layers,
               max_abs_diff=(a - b).abs().max().item(),
               top1_equal=bool(a.argmax() == b.argmax()),
               finite=bool(torch.isfinite(a).all()))
    emit("sharded_logits_check", **row)
    require(row["finite"] and cos > 0.99 and row["top1_equal"],
            f"sharded: placed vs unsharded first-token logits: {row}")
    return row


def serve_sharded(params, mesh) -> dict:
    """qwen3-4b served ``paged`` and ``paged_int8`` on its state placed on
    ``mesh`` (the pool placed with it: each model rank's kv heads its own
    tensor): every request reaches its token count (``serve``), each
    decode tick launches the paged kernel L x m times (each rank's heads),
    and the first-token logits hold against the unsharded engine's.  ->
    the runs' launches."""
    from repro_torch.configs import get_bundle
    L = get_bundle(ARCH).cfg.n_layers
    m = mesh.shape["model"]
    launches: dict[str, int] = {}
    with torch.no_grad():
        for mode, key in (("paged", "paged_decode_bf16"),
                          ("paged_int8", "paged_decode_int8")):
            run = serve(mode, params, ARCH, mesh=mesh, phase="serve_sharded",
                        place=True)
            ticks = run["row"]["decode_steps"]
            require(ticks > 0 and run["launches"].get(key, 0) ==
                    L * m * ticks,
                    f"serve_sharded {mode}: {key} launched "
                    f"{run['launches'].get(key, 0)} times over {ticks} "
                    f"decode ticks, want {L * m} a tick")
            for k, c in run["launches"].items():
                launches[k] = launches.get(k, 0) + c
    sharded_logits_check(params, mesh)
    return launches


def train_sharded(mesh, unsharded_peak: int | None) -> dict:
    """Three AdamW steps of qwen3-4b at full width (B 2 x S 2048) through
    ``launch.train.run`` under ``mesh``, on the weights it draws from its
    seed and places (params and moments by ``param_specs``): finite
    losses, probed params moved, ``opt_step`` 3, the peak under 80 GB
    (printed beside the unsharded ``train`` phase's), and L x nd x m of
    each flash kernel a step (the recompute keeps attn_out).  s/step,
    tok/s and each rank's state bytes are printed, not held."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SEED as TRAIN_SEED, run
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import (held_nbytes, local_nbytes,
                                               param_specs)
    bundle = get_bundle(ARCH)
    L = bundle.cfg.n_layers
    nd, m = SHARDED["train"]

    def probes(get):
        return {"wq[0]": get("wq")[0, :64, :64],
                f"w_gate[{L - 1}]": get("w_gate")[L - 1, :64, :64],
                "embed": get("embed")[:64, :64]}

    start = [bundle.init_params(TRAIN_SEED, device="cuda")]
    before = {k: v.clone() for k, v in probes(
        lambda n: start[0][n] if n == "embed" else
        start[0]["layers"][n]).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run(ARCH, smoke=False, steps=TRAIN_STEPS, seq_len=SHARDED["S"],
              global_batch=SHARDED["B"], microbatches=1, device="cuda",
              mesh_kind=mesh, params=start.pop())
    wall = time.perf_counter() - t0
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    p = out["params"]
    after = probes(lambda n: (p[n] if n == "embed" else
                              p["layers"][n]).at(model=0))
    changed = {k: not torch.equal(before[k], after[k]) for k in before}
    specs = param_specs(bundle.kind, p, mesh)
    state = {"params": p, "opt": out["opt"]}
    abstract = bundle.abstract_params()
    moments = adamw_init(abstract)
    per_rank = local_nbytes(
        {"p": abstract, "mu": moments["mu"], "nu": moments["nu"]},
        {"p": specs, "mu": specs, "nu": specs}, mesh)
    steps_s = out["seconds"]
    tokens = SHARDED["B"] * SHARDED["S"]
    n = L * nd * m * TRAIN_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    row = dict(arch=ARCH, mesh=dict(mesh.shape), B=SHARDED["B"],
               S=SHARDED["S"], steps=len(steps_s), losses=out["losses"],
               finite=[x["finite"] for x in out["metrics"]],
               grad_norm=[x["grad_norm"] for x in out["metrics"]],
               s_per_step=steps_s,
               tok_per_s_after_first=tokens * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall, max_memory_allocated=peak,
               unsharded_max_memory_allocated=unsharded_peak,
               state_bytes_held=held_nbytes(state),
               state_bytes_per_rank=per_rank, params_changed=changed,
               opt_step=int(out["opt"]["step"]), launches=launches,
               want_flash=want, nvidia_smi=smi())
    emit("train_sharded", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and
            len(steps_s) == TRAIN_STEPS and row["opt_step"] == TRAIN_STEPS
            and all(changed.values()),
            f"train_sharded: a loss, finite flag, step count or probe is "
            f"bad: {row}")
    require(peak < 80e9, f"train_sharded: peak {peak} bytes")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} ==
            dict(dict.fromkeys(FLASH_KEYS, 0), **want),
            f"train_sharded: flash launches {launches}, want {want}")
    del out, p, state
    torch.cuda.empty_cache()
    return launches


def sharded_phase(unsharded_peak: int | None = None) -> dict:
    """Phase 5d: qwen3-4b's (2, 4) placed step against the unsharded one,
    served on a (1, 4) placed state, then trained three steps under (2, 4),
    all at full width and depth; returns the served and trained runs'
    launches (the main path's) for the kernels line."""
    t0 = time.perf_counter()
    params = init_params(ARCH)
    sharded_train_check(params, sharded_mesh("train"))
    torch.cuda.empty_cache()
    served = serve_sharded(params, sharded_mesh("serve"))
    del params
    torch.cuda.empty_cache()
    trained = train_sharded(sharded_mesh("train"), unsharded_peak)
    emit("sharded", seconds=time.perf_counter() - t0, depth_cut=None)
    return {k: served.get(k, 0) + trained.get(k, 0)
            for k in served.keys() | trained.keys()}


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
    """The flash launches ``steps`` train steps must make: the forward once
    per attention call where the family's recompute keeps ``attn_out``
    (the transformer's ``SAVED``), else twice (the step's forward and the
    per-unit recompute), each backward kernel once, all on the family's
    routes."""
    n = attention_calls(bundle) * steps
    fwd = n if "attn_out" in getattr(bundle.family, "SAVED", ()) else 2 * n
    want = dict.fromkeys(FLASH_KEYS, 0)
    if bundle.kind == "hybrid":         # head_dim 256
        want.update(flash_fwd_d256=fwd, flash_bwd_dq_d256=n,
                    flash_bwd_dkv_d256=n)
    elif n:
        want.update(flash_fwd=fwd, flash_bwd_dq=n, flash_bwd_dkv=n)
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
# phase 5e: the placed state of the other families: mamba2-370m,
# recurrentgemma-9b and whisper-medium placed by param_specs on meshes of
# local rings, each step through its tensor-parallel body
# ---------------------------------------------------------------------------

# per family: the depth run (None: the config's own), the batch (B splits
# over the data axis), why a depth is cut, the first-token check's prompt,
# and the leaves held against the unsharded step: (keys..., layer index,
# ...) of the first and the last unit, the vocabulary tables whole
SHARDED_FAMILIES = {
    "mamba2-370m": dict(
        n_layers=12, B=2, S=2048, check_len=1536, cfg=dict(sp=True),
        cut="12 of 48 layers: a placed step at full depth takes 19-22 s "
            "(8 rank bodies a layer in turn, each with its SSD chunk loop, "
            "on the host), which would take the script past 1,100 s",
        leaves=(("embed",), ("lm_head",), ("layers", "in_proj", 0),
                ("layers", "in_proj", -1), ("layers", "out_proj", 0),
                ("layers", "out_proj", -1), ("layers", "conv_w", 0),
                ("layers", "gnorm", -1))),
    "recurrentgemma-9b": dict(
        n_layers=8, B=2, S=2048, check_len=3072,
        cut="8 of 38 layers (TRAIN_FAMILIES'): 2 (rec, rec, attn) groups "
            "and the 2-layer rec tail; the full 10.45 B params need 125 GB "
            "of state",
        leaves=(("embed",), ("lm_head",), ("rec_groups", "w_x", 0, 0),
                ("rec_groups", "w_a", 0, 0), ("attn_groups", "wq", 0),
                ("attn_groups", "wk", 0), ("attn_groups", "wv", -1),
                ("attn_groups", "wo", -1), ("rec_tail", "w_out", -1),
                ("rec_tail", "lam", -1))),
    "whisper-medium": dict(
        n_layers=None, B=2, S=1024, cut=None, check_len=1536,
        leaves=(("embed",), ("enc", "attn", "wq", 0), ("enc", "mlp_w2", -1),
                ("dec", "self", "wk", 0), ("dec", "self", "bo", 0),
                ("dec", "cross", "wv", -1), ("dec", "mlp_w1", -1))),
}
SHARDED_FAMILY_MESH = dict(train=(2, 4), serve=(1, 4))


def sharded_family_bundle(arch: str):
    """``arch``'s full-width bundle, cut in depth where SHARDED_FAMILIES
    says so."""
    import dataclasses

    from repro_torch.configs import get_bundle
    bundle = get_bundle(arch)
    spec = SHARDED_FAMILIES[arch]
    over = dict(spec.get("cfg", {}))
    if spec["n_layers"] is not None:
        over["n_layers"] = spec["n_layers"]
    return dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, **over)) if over else bundle


def _keys(path: tuple) -> tuple:
    return tuple(k for k in path if isinstance(k, str))


def _leaf(tree, path: tuple):
    for k in _keys(path):
        tree = tree[k]
    return tree


def family_batch(bundle, B: int, S: int, seed: int) -> dict:
    """A (B, S) token batch on the card with random f32 ``frames`` for the
    audio kind (the encoder then sees more than its positions)."""
    batch = token_batch(B, S, seed, bundle.cfg.vocab)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    for k, v in bundle.zero_extras(B, torch.float32, "cuda").items():
        batch[k] = torch.randn(v.shape, generator=g, device="cuda")
    return batch


def sharded_family_check(params, bundle, mesh, leaves: tuple, B: int,
                         S: int) -> dict:
    """Loss and gradients of one (B, S) batch on ``bundle``'s state placed
    on ``mesh`` (each data rank's rows in turn, each model rank's share
    through its family's placed body) against the unsharded step's, both
    under per-unit recompute: ``train_check``'s limits (loss rel diff <
    1e-3; per leaf cosine > 0.99 and |norm ratio - 1| < NORM_TOL) on
    ``leaves`` (SHARDED_FAMILIES' paths: a layer index after the keys
    picks that unit's slice); the flash kernels launched the family's
    attention calls x nd x m times a pass (the forward twice, or once
    where the recompute keeps attn_out: ``want_flash``) on its wgmma
    routes, none CUDA-core."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import (Placed, gather_leaf,
                                               param_specs, shard_tree)
    from repro_torch.training import TrainHyper, loss_fn
    from repro_torch.training.step import placed_grads
    batch = family_batch(bundle, B, S, SEED + 11)
    names = list(dict.fromkeys(_keys(p) for p in leaves))

    def slices(grads: dict) -> dict:
        out = {}
        for path in leaves:
            g = grads[_keys(path)]
            idx = tuple(i for i in path if isinstance(i, int))
            out["/".join(map(str, path))] = g[idx].clone() if idx else g
        return out

    full = [_leaf(params, k) for k in names]
    for p in full:
        p.requires_grad_(True)
    loss_u, _ = loss_fn(bundle.forward, params, batch)
    grads = torch.autograd.grad(loss_u, full)
    for p in full:
        p.requires_grad_(False)
    want, loss_u = slices(dict(zip(names, grads))), loss_u.item()
    del grads
    torch.cuda.empty_cache()

    placed = shard_tree(params, param_specs(bundle.kind, params, mesh), mesh)
    sel = [_leaf(placed, k) for k in names]
    shards = [t for leaf in sel for t in leaf.tensors()]
    for t in shards:
        t.requires_grad_(True)
    ops.reset_launches()
    with CollectiveMode() as coll:
        loss_s, _, _, gs = placed_grads(bundle.forward, TrainHyper(),
                                        placed, shards, batch)
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    for t in shards:
        t.requires_grad_(False)
    it = iter(gs)
    got = slices({k: gather_leaf(Placed(leaf.shape, leaf.dtype, leaf.spec,
                                        mesh, {c: next(it) for c in
                                               sorted(leaf.shards)}))
                  for k, leaf in zip(names, sel)})
    loss_s = loss_s.item()
    del placed, sel, shards, gs
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(got[k].float().flatten(),
                                  want[k].float().flatten(), dim=0).item()
           for k in want}
    ratio = {k: (got[k].float().norm() / want[k].float().norm()).item()
             for k in want}
    rel = abs(loss_s - loss_u) / abs(loss_u)
    flash = want_flash(bundle, 1)
    for k, n in flash.items():      # each data and model rank's calls
        flash[k] = n * math.prod(mesh.shape.values())
    row = dict(arch=bundle.arch_id, kind=bundle.kind,
               n_layers=bundle.cfg.n_layers, mesh=dict(mesh.shape), B=B,
               S=S, loss_sharded=loss_s, loss_unsharded=loss_u,
               loss_rel_diff=rel, cosine=cos, norm_ratio=ratio,
               launches=launches, want_flash=flash,
               sp=getattr(bundle.cfg, "sp", True),
               collective_bytes=sp_collectives(coll, mesh, S),
               tol=f"loss rel diff < 1e-3; per leaf cosine > 0.99 and "
                   f"|norm ratio - 1| < {NORM_TOL}")
    emit("sharded_family_check", **row)
    require(math.isfinite(loss_s) and rel < 1e-3 and
            all(c > 0.99 for c in cos.values()) and
            all(abs(r - 1.0) < NORM_TOL for r in ratio.values()),
            f"sharded_families {bundle.arch_id}: placed vs unsharded "
            f"loss/grads: {row}")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} == flash,
            f"sharded_families {bundle.arch_id}: flash launches "
            f"{launches}, want {flash}")
    coll = row["collective_bytes"]
    require(not (row["sp"] and coll["seq_sharded"]) or
            coll["by_kind"].get("reduce-scatter", 0) > 0,
            f"sharded_families {bundle.arch_id}: the sequence-sharded "
            f"residual's reduce-scatter is missing: {coll}")
    return row


class PrefillTap(FiniteWatch):
    """FiniteWatch that keeps the last row of every prefill's logits."""

    def __init__(self, bundle):
        super().__init__(bundle)
        self.rows = []

    def prefill(self, *a, **kw):
        out = super().prefill(*a, **kw)
        self.rows.append(out[0][0, -1].float())
        return out


def sharded_family_logits(params, bundle, mesh, n: int) -> dict:
    """The first token's logits of one ``n``-token prompt served by a
    dense engine on the state placed on ``mesh`` (its cache placed by the
    family's rule) against the same engine on the unsharded state: cosine
    > 0.99, the same top-1, finite; both engines then serve it to 4
    tokens.  -> the row, with the placed engine's launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    prompt = prompts(1, n, n, SEED + 9, bundle.cfg.vocab)[0]
    out, launches = {}, {}
    with torch.no_grad():
        for name, msh in (("sharded", mesh), ("unsharded", None)):
            engine, _ = build_engine(
                bundle, kv_mode="dense", slots=1, max_len=n + 4, max_new=4,
                params=params, device="cuda", mesh=msh,
                place=msh is not None)
            tap = PrefillTap(engine.bundle)
            engine.bundle = tap
            ops.reset_launches()
            engine.submit(prompt)
            res = engine.run()
            if msh is not None:
                launches = {k: c for k, c in ops.LAUNCHES.items() if c}
            require(len(res[0]) == 4 and bool(tap.finite.item()),
                    f"sharded_families {bundle.arch_id} {name}: {res}")
            out[name] = tap.rows[0]
            del engine, tap
            torch.cuda.empty_cache()
    a, b = out["sharded"], out["unsharded"]
    cos = F.cosine_similarity(a, b, dim=0).item()
    row = dict(arch=bundle.arch_id, kind=bundle.kind, prompt=n,
               mesh=dict(mesh.shape), n_layers=bundle.cfg.n_layers,
               cosine=cos, max_abs_diff=(a - b).abs().max().item(),
               top1_equal=bool(a.argmax() == b.argmax()),
               finite=bool(torch.isfinite(a).all()), launches=launches)
    emit("sharded_family_logits", **row)
    require(row["finite"] and cos > 0.99 and row["top1_equal"],
            f"sharded_families {bundle.arch_id}: placed vs unsharded "
            f"first-token logits: {row}")
    return row


def train_sharded_family(bundle, mesh, B: int, S: int,
                         probes: tuple) -> dict:
    """``TRAIN_STEPS`` AdamW steps of ``bundle`` through
    ``launch.train.run`` under ``mesh`` on the weights drawn from its
    seed, placed (params and moments by ``param_specs``): finite losses,
    every probe (TRAIN_FAMILIES' paths; model rank 0's shard after) moved,
    ``opt_step`` equal to the steps, the peak under 80 GB, the family's
    flash launches x nd x m a step.  s/step, tok/s and the state's bytes a
    rank are printed, not held.  -> the row."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SEED as TRAIN_SEED, run
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import (held_nbytes, local_nbytes,
                                               param_specs)

    def probe(tree, path, placed):
        t = tree
        for key in path:
            if isinstance(key, str):
                t = t[key]
        t = t.at(model=0) if placed else t
        idx = [i for i in path if isinstance(i, int)]
        return (t[idx[0]] if idx else t)[:64, :64]

    start = [bundle.init_params(TRAIN_SEED, device="cuda")]
    before = {"/".join(map(str, p)): probe(start[0], p, False).clone()
              for p in probes}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run(bundle, steps=TRAIN_STEPS, seq_len=S, global_batch=B,
              microbatches=1, device="cuda", mesh_kind=mesh,
              params=start.pop())
    wall = time.perf_counter() - t0
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    p = out["params"]
    changed = {k: not torch.equal(before[k], probe(p, path, True))
               for k, path in zip(before, probes)}
    specs = param_specs(bundle.kind, p, mesh)
    abstract = bundle.abstract_params()
    moments = adamw_init(abstract)
    per_rank = local_nbytes(
        {"p": abstract, "mu": moments["mu"], "nu": moments["nu"]},
        {"p": specs, "mu": specs, "nu": specs}, mesh)
    steps_s = out["seconds"]
    want = want_flash(bundle, TRAIN_STEPS)
    for k, n in want.items():
        want[k] = n * math.prod(mesh.shape.values())
    row = dict(arch=bundle.arch_id, kind=bundle.kind,
               n_layers=bundle.cfg.n_layers, mesh=dict(mesh.shape), B=B, S=S,
               steps=len(steps_s), losses=out["losses"],
               finite=[x["finite"] for x in out["metrics"]],
               grad_norm=[x["grad_norm"] for x in out["metrics"]],
               s_per_step=steps_s,
               tok_per_s_after_first=B * S * (len(steps_s) - 1) /
               sum(steps_s[1:]), wall_s=wall, max_memory_allocated=peak,
               state_bytes_held=held_nbytes({"params": p,
                                             "opt": out["opt"]}),
               state_bytes_per_rank=per_rank, params_changed=changed,
               opt_step=int(out["opt"]["step"]), launches=launches,
               want_flash=want)
    emit("train_sharded_family", **row)
    require(all(math.isfinite(x) for x in out["losses"]) and
            all(f == 1.0 for f in row["finite"]) and
            len(steps_s) == TRAIN_STEPS and row["opt_step"] == TRAIN_STEPS
            and all(changed.values()),
            f"train_sharded_family {bundle.arch_id}: a loss, finite flag, "
            f"step count or probe is bad: {row}")
    require(peak < 80e9,
            f"train_sharded_family {bundle.arch_id}: peak {peak} bytes")
    require({k: launches.get(k, 0) for k in FLASH_KEYS} == want,
            f"train_sharded_family {bundle.arch_id}: flash launches "
            f"{launches}, want {want}")
    del out, p
    gc.collect()
    torch.cuda.empty_cache()
    return row


def sharded_family(arch: str, bundle=None, B: int | None = None,
                   S: int | None = None, check_len: int | None = None,
                   train: bool = True) -> dict:
    """One family of SHARDED_FAMILIES (``bundle``, B, S and the check's
    prompt override its row, as the card tests' small depths do): the
    (2, 4) placed step against the unsharded one, the (1, 4) placed dense
    engine's first token against the unsharded engine's, then (``train``)
    3 steps under (2, 4) through ``launch.train.run``.  -> the served and
    trained runs' launches (the main path's)."""
    from repro_torch.parallel import make_mesh
    spec = SHARDED_FAMILIES[arch]
    cut = spec["cut"] if bundle is None else \
        f"{bundle.cfg.n_layers} layers (given)"
    bundle = bundle or sharded_family_bundle(arch)
    B, S = B or spec["B"], S or spec["S"]
    meshes = {k: make_mesh(v, ("data", "model"))
              for k, v in SHARDED_FAMILY_MESH.items()}
    t0 = time.perf_counter()
    params = bundle.init_params(SEED, device="cuda")
    sharded_family_check(params, bundle, meshes["train"], spec["leaves"],
                         B, S)
    torch.cuda.empty_cache()
    served = sharded_family_logits(params, bundle, meshes["serve"],
                                   check_len or spec["check_len"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(served["launches"])
    if train:
        trained = train_sharded_family(bundle, meshes["train"], B, S,
                                       TRAIN_FAMILIES[arch]["probes"])
        for k, c in trained["launches"].items():
            launches[k] = launches.get(k, 0) + c
    emit("sharded_family", arch=arch, n_layers=bundle.cfg.n_layers,
         cut=cut, seconds=time.perf_counter() - t0)
    return launches


def sharded_families_phase() -> dict:
    """Phase 5e: each family of SHARDED_FAMILIES in turn on an empty card.
    -> the served and trained runs' launches, summed (the kernels line)."""
    t0 = time.perf_counter()
    total: dict[str, int] = {}
    for arch in SHARDED_FAMILIES:
        for k, n in sharded_family(arch).items():
            total[k] = total.get(k, 0) + n
    emit("sharded_families", seconds=time.perf_counter() - t0,
         depth_cut={a: s["cut"] for a, s in SHARDED_FAMILIES.items()
                    if s["cut"]})
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


# the checkpoint drills' depth.  A run's machine may write 45 GiB to its
# disk in all, deleted files included, and a save of qwen3-4b at full width
# is 8.2 GiB at one layer (its embedding and head alone 7.2 GiB), 41.1 GiB
# whole: ``recovery`` writes two saves and ``train_fleet`` three, 40.9 GiB
# at one layer each
RECOVERY_LAYERS = 1


def recovery_bundle():
    """qwen3-4b's full bundle cut to ``RECOVERY_LAYERS`` (every width the
    config's own)."""
    import dataclasses

    from repro_torch.configs import get_bundle
    b = get_bundle(ARCH)
    return dataclasses.replace(b, cfg=dataclasses.replace(
        b.cfg, n_layers=RECOVERY_LAYERS))


def recovery() -> dict:
    """qwen3-4b at full width cut to ``RECOVERY_LAYERS`` (B 2 x S 2048,
    one microbatch, bf16 params, f32 moments) through ``launch.train.run``
    three times, each from ``init_params(SEED)`` and freed before the
    next:

    A, uninterrupted: 4 steps, ``nan@1`` (step 1 skipped on the card);
    B, killed: the same with a checkpoint every 2 steps and ``kill@3``,
       which lands the step-2 save and exits 43;
    C, restarted: 2 steps from the same directory: restores step 2, runs
       steps 2 and 3 and saves step 4.

    B's losses must equal A's first three and C's A's last two, bit for
    bit; C's final state (params, moments, step) must equal A's by
    ``state_fingerprint``; the step-4 save must verify.  No fallback: a
    failed save, verify or restore fails the phase.  The checkpoints go to
    ``build/recovery_ckpt`` (git-ignored), removed at the end; where the
    disk holds one checkpoint but not two, step 2 is removed once C has
    restored it, before C writes step 4."""
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.obs import REGISTRY
    from repro_torch.runtime import KILL_EXIT_CODE, ChaosKilled
    bundle = recovery_bundle()
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
    row = {"n_layers": L, "state_bytes": state_bytes}

    def flash(launches):
        return {k: launches[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_simt",
            "flash_bwd_dq_simt", "flash_bwd_dkv_simt")}

    def want_flash(steps):
        return {"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
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
        out = run(bundle, steps=4, chaos=["nan@1"], **kw)
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
            run(bundle, steps=4, ckpt_dir=str(ckpt), ckpt_every=2,
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
        out = run(bundle, steps=2, ckpt_dir=str(ckpt), ckpt_every=2,
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


# ---------------------------------------------------------------------------
# phase 6a: the train side of the fleet (supervised worker processes)
# ---------------------------------------------------------------------------

# qwen3-4b at full width cut to 1 of its 36 layers (the disk's budget:
# RECOVERY_LAYERS), registered in the workers under an id of its own; two
# workers share the one card and each computes the whole global batch (the
# reference's deterministic redundancy)
TRAIN_FLEET = dict(arch="qwen3-4b-1l", layers=1, nprocs=2, seq_len=2048,
                   global_batch=2, ckpt_every=4, steps=8, restart_steps=12)
TRAIN_FLEET_WORKER = "--train-fleet-worker"
# the supervisor's default policy (a 30 s hang detector: a worker keeps
# its heartbeat fresh while checkpoint I/O blocks its loop), with a
# ceiling on a drill's wall time
TRAIN_FLEET_POLICY = dict(max_wall_s=600.0)
# B's restarted worker waits for rank 0's commit of this step before it
# starts, so it restores a checkpoint (not step 0) whatever the disk's
# speed, and still has steps to run after it
TRAIN_FLEET_RESTORE_STEP = 4
FLASH_ROUTE_KEYS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "flash_fwd_simt", "flash_bwd_dq_simt",
                    "flash_bwd_dkv_simt")


def train_fleet_bundle():
    """qwen3-4b's full bundle cut in depth only, under its own id."""
    import dataclasses
    from repro_torch.configs import get_bundle
    b = get_bundle(ARCH)
    return dataclasses.replace(
        b, arch_id=TRAIN_FLEET["arch"],
        cfg=dataclasses.replace(b.cfg, n_layers=TRAIN_FLEET["layers"]))


def watch_rss(period_s: float = 0.2) -> dict:
    """Sample this process's resident set from ``/proc/self/statm`` every
    ``period_s`` on a daemon thread; ``["peak"]`` holds the largest seen
    (None where the file is missing).  ``ru_maxrss`` will not do: a child
    reports the peak of the process that spawned it (the card machine's
    kernel carries it across fork and exec), so it cannot tell a worker's
    own memory from the parent's."""
    import os
    import threading
    page = os.sysconf("SC_PAGE_SIZE")
    seen = {"peak": None}

    def sample() -> bool:
        try:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page
        except (OSError, ValueError, IndexError):
            return False
        seen["peak"] = max(seen["peak"] or 0, rss)
        return True

    def loop():
        while sample():
            time.sleep(period_s)
    threading.Thread(target=loop, daemon=True).start()
    seen["sample"] = sample
    return seen


def wait_for_commit(argv: list[str], step: int,
                    timeout_s: float = 300.0) -> None:
    """Block until step ``step`` has committed in the ``--ckpt-dir`` of
    the train ``argv``; raise after ``timeout_s``."""
    from repro_torch.checkpoint import latest_step
    ckpt = argv[argv.index("--ckpt-dir") + 1]
    t0 = time.perf_counter()
    while (latest_step(ckpt) or 0) < step:
        require(time.perf_counter() - t0 < timeout_s,
                f"step {step} did not commit in {ckpt} in {timeout_s} s")
        time.sleep(0.2)


def train_fleet_worker(argv: list[str]) -> int:
    """One supervised train worker: registers the cut bundle in
    ``repro_torch.configs.REGISTRY`` (the workers are processes, so the
    cut reaches them here, not through a flag of the package), runs
    ``repro_torch.launch.train.main(argv)``, and prints, whatever the
    exit, a ``[train-fleet-worker]`` line with its exit code, peak device
    memory, peak host RSS (:func:`watch_rss`) and kernel launches.
    ``argv`` may start with ``--after-commit N``: the worker first waits
    for step N's commit (:func:`wait_for_commit`).  Returns the exit code
    (43 on a kill)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    if argv[:1] == ["--after-commit"]:
        wait_for_commit(argv[2:], int(argv[1]))
        argv = argv[2:]
    bundle = train_fleet_bundle()
    configs.REGISTRY[bundle.arch_id] = type(
        "CutConfig", (), {"ARCH_ID": bundle.arch_id,
                          "full_bundle": staticmethod(lambda: bundle),
                          "smoke_bundle": staticmethod(lambda: bundle)})
    rss = watch_rss()
    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:
        code = 1
        raise
    finally:
        rss["sample"]()
        peak = torch.cuda.max_memory_allocated() \
            if torch.cuda.is_initialized() else 0
        print("[train-fleet-worker] " + json.dumps(
            {"exit": code, "peak_device_bytes": peak,
             "peak_host_rss_bytes": rss["peak"],
             "launches": {k: v for k, v in ops.LAUNCHES.items() if v}}),
            flush=True)
    return code


def _json_file(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def run_train_fleet(name: str, root: Path, ckpt: Path | None, steps: int,
                    chaos=(), striped: str = "auto",
                    restart_after: int | None = None) -> dict:
    """One supervised 2-worker fleet of the cut bundle: the port's
    ``Supervisor`` over the argv of ``launch.supervisor.make_cmd_builder``
    with only its head swapped (``python -m repro_torch.launch.train`` ->
    ``python chip_smoke.py --train-fleet-worker``); a relaunch waits for
    step ``restart_after``'s commit when it is given.  Returns what the
    report, the result and metrics files and the workers' lines hold."""
    import argparse
    from repro_torch.launch.supervisor import make_cmd_builder
    from repro_torch.runtime.chaos import split_spec_strings
    from repro_torch.runtime.supervisor import RestartPolicy, Supervisor
    fleet_dir = root / f"fleet_{name}"
    a = argparse.Namespace(
        arch=TRAIN_FLEET["arch"], steps=steps,
        seq_len=TRAIN_FLEET["seq_len"],
        global_batch=TRAIN_FLEET["global_batch"],
        ckpt_dir=str(ckpt) if ckpt else None,
        ckpt_every=TRAIN_FLEET["ckpt_every"], smoke=False, chaos_seed=0,
        distributed="none", device=None)
    _, worker_chaos = split_spec_strings(list(chaos))
    build = make_cmd_builder(a, str(fleet_dir), worker_chaos, None)

    def cmd(spec):
        argv = build(spec)
        head = [sys.executable, "-m", "repro_torch.launch.train"]
        require(argv[:3] == head, f"worker argv head {argv[:3]}")
        wait = ["--after-commit", str(restart_after)] \
            if restart_after is not None and spec.attempt > 1 else []
        return [sys.executable, str(ROOT / "chip_smoke.py"),
                TRAIN_FLEET_WORKER, *wait, *argv[3:]]

    sup = Supervisor(TRAIN_FLEET["nprocs"], cmd, fleet_dir=str(fleet_dir),
                     policy=RestartPolicy(**TRAIN_FLEET_POLICY),
                     chaos_specs=list(chaos),
                     ckpt_dir=str(ckpt) if ckpt else None,
                     striped_restore=striped)
    t0 = time.perf_counter()
    report = sup.run()
    wall = time.perf_counter() - t0
    tokens = TRAIN_FLEET["global_batch"] * TRAIN_FLEET["seq_len"]
    ranks = {}
    for w in report["workers"]:
        tag = w["tag"]
        res = _json_file(fleet_dir / f"result_rank{tag}.json")
        snap = _json_file(fleet_dir / f"metrics_rank{tag}.json")
        c, h = snap.get("counters", {}), snap.get("histograms", {})
        step = h.get("train_step_s", {})
        attempts = []
        for k in range(1, w["attempts"] + 1):
            log = fleet_dir / f"log_rank{tag}_a{k}.log"
            lines = [ln for ln in log.read_text(errors="replace")
                     .splitlines()
                     if ln.startswith("[train-fleet-worker] ")] \
                if log.is_file() else []
            w_row = json.loads(lines[-1].split(" ", 1)[1]) \
                if lines else None
            if w_row is None or w_row["exit"] not in (0, 43):
                # a crash: keep the end of its log for the failure line
                w_row = dict(w_row or {}, log_tail=log.read_text(
                    errors="replace")[-1500:] if log.is_file() else None)
            attempts.append(w_row)
        dispatch = {k.split("{", 1)[1].rstrip("}"): v for k, v in c.items()
                    if k.startswith("kernel_dispatch{")
                    and "kernel=flash_attention" in k}
        ranks[tag] = dict(
            exit_history=w["exit_history"], attempts=w["attempts"],
            start_step=res.get("start_step"), end_step=res.get("end_step"),
            params_crc=res.get("params_crc"),
            first_loss=res.get("first_loss"),
            final_loss=res.get("final_loss"), device=res.get("device"),
            steps=step.get("count", 0),
            s_per_step=dict(mean=step.get("mean"), p50=step.get("p50"),
                            min=step.get("min"), max=step.get("max")),
            tok_per_s=tokens / step["p50"] if step.get("p50") else None,
            restore_s=h.get("checkpoint_restore_s", {}).get("sum"),
            # the restore's parts: full = verify (a CRC pass) + leaves;
            # striped = stripe read + exchange + CRC + leaves
            restore_parts_s={k: h[f"checkpoint_{k}_s"]["sum"] for k in (
                "verify", "stripe_read", "stripe_exchange", "stripe_crc")
                if f"checkpoint_{k}_s" in h},
            read_bytes={m: c.get(f"checkpoint_read_bytes{{mode={m}}}", 0)
                        for m in ("full", "striped")},
            stripe_bytes={d: c.get(f"checkpoint_stripe_bytes{{dir={d}}}",
                                   0) for d in ("recv", "sent")},
            restore_ops={op: c.get(f"checkpoint_ops{{op={op}}}", 0)
                         for op in ("restore", "restore_striped")},
            save_s=h.get("checkpoint_save_s", {}).get("sum"),
            snapshot_s=h.get("checkpoint_snapshot_s", {}).get("sum"),
            flash_dispatch=dispatch, workers=attempts)
    return dict(name=name, outcome=report["outcome"],
                total_failures=report["total_failures"],
                final_checkpoint_step=report["final_checkpoint_step"],
                hang_kills=sum(e["kind"] == "hang_kill"
                               for e in report["events"]),
                wall_s=wall, ranks=ranks)


def start_train_fleet_cli(root: Path) -> dict:
    """Start the smoke-width supervisor CLI with ``kill@5`` and with
    ``--distributed torch``, and the three ``examples/*_torch.py``, as
    subprocesses on the card, all at once (:func:`finish_train_fleet_cli`
    waits for them)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    sup = [sys.executable, "-m", "repro_torch.launch.supervisor",
           "--nprocs", "2", "--steps", "8", "--seq-len", "32",
           "--global-batch", "4", "--ckpt-every", "4"]
    runs = {
        "supervisor_kill": sup + [
            "--chaos", "kill@5", "--ckpt-dir", str(root / "cli_kill_ckpt"),
            "--fleet-dir", str(root / "cli_kill"),
            "--report-out", str(root / "cli_kill" / "report.json")],
        "supervisor_torch": sup + [
            "--distributed", "torch",
            "--ckpt-dir", str(root / "cli_torch_ckpt"),
            "--fleet-dir", str(root / "cli_torch"),
            "--report-out", str(root / "cli_torch" / "report.json")],
        "quickstart_torch": [sys.executable,
                             str(ROOT / "examples" / "quickstart_torch.py")],
        "serve_lm_torch": [sys.executable,
                           str(ROOT / "examples" / "serve_lm_torch.py")],
        "train_lm_torch": [sys.executable,
                           str(ROOT / "examples" / "train_lm_torch.py"),
                           "--ckpt-dir", str(root / "train_lm_ckpt")],
    }
    return dict(t0=time.perf_counter(),
                procs={k: subprocess.Popen(v, cwd=ROOT, env=env, text=True,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           start_new_session=True)
                       for k, v in runs.items()})


def stop_train_fleet_cli(started: dict | None) -> None:
    """Kill whatever :func:`start_train_fleet_cli` started that still
    runs, each with its process group (a supervisor's workers too)."""
    import os
    import signal
    for p in (started or {}).get("procs", {}).values():
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def finish_train_fleet_cli(root: Path, started: dict) -> list[dict]:
    """Wait for :func:`start_train_fleet_cli`'s runs: each must exit 0;
    the ``kill@5`` run must complete with worker 1's exits [43, 0] and
    equal CRCs, the gloo run with ``dist_ok`` and 2 processes on both
    ranks."""
    t0 = started["t0"]
    rows = []
    for k, p in started["procs"].items():
        try:
            out, err = p.communicate(timeout=max(1.0, 400 - (
                time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_train_fleet_cli({"procs": {k: p}})
            out, err = p.communicate()
        row = dict(run=k, rc=p.returncode,
                   wall_s=time.perf_counter() - t0,
                   last=out.strip().splitlines()[-1:] if out else [])
        if k.startswith("supervisor"):
            d = root / ("cli_" + k.split("_")[1])
            rep = _json_file(d / "report.json")
            res = {t: _json_file(d / f"result_rank{t}.json")
                   for t in (0, 1)}
            row.update(outcome=rep.get("outcome"),
                       exit_history={w["tag"]: w["exit_history"]
                                     for w in rep.get("workers", ())},
                       final_checkpoint_step=rep.get(
                           "final_checkpoint_step"),
                       dist_ok=[r.get("dist_ok") for r in res.values()],
                       process_count=[r.get("process_count")
                                      for r in res.values()],
                       devices=[r.get("device") for r in res.values()],
                       params_crc=[r.get("params_crc")
                                   for r in res.values()])
        emit("train_fleet_cli", **row)
        require(p.returncode == 0,
                f"train_fleet_cli {k}: exit {p.returncode}: "
                f"{err[-2000:] if err else ''}")
        rows.append(row)
    kill, dist = rows[0], rows[1]
    require(kill["outcome"] == "completed"
            and kill["exit_history"].get(1) == [43, 0]
            and len(set(kill["params_crc"])) == 1,
            f"train_fleet_cli supervisor kill@5: {kill}")
    require(dist["outcome"] == "completed"
            and dist["dist_ok"] == [True, True]
            and dist["process_count"] == [2, 2],
            f"train_fleet_cli --distributed torch: {dist}")
    return rows


def train_fleet() -> dict:
    """qwen3-4b at full width, cut to ``TRAIN_FLEET["layers"]`` of its 36
    layers (0.88 B params at one, 8.8 GB of state: bf16 params, f32
    moments), trained by two supervised worker processes sharing the
    card, each on the whole global batch of B 2 x S 2048:

    A, baseline: 8 steps with no checkpoint directory (the disk's budget:
       ``RECOVERY_LAYERS``): completed, both ranks' ``params_crc`` equal;
    B, kill: the same with ``kill@5`` and a checkpoint every 4: tag 1
       exits [43, 0] (2 attempts; restarted alone, it waits for rank 0's
       step-4 commit, restores step 4 with full reads and runs steps 4-7),
       tag 0 runs once, final checkpoint step 8, every rank's
       ``params_crc`` equals A's;
    C, striped gang restart: over B's checkpoint to 12 steps with
       ``--striped-restore always``: each rank restores striped once,
       reads fewer checkpoint bytes than the shard holds and receives its
       peer's stripe; both start at step 8 and end on equal states.

    Every worker's flash attention dispatches with ``impl=cuda`` only and
    launches the wgmma keys alone.  The smoke-width CLI runs and the
    examples (``start_train_fleet_cli``) run beside B.  The
    checkpoints go under ``build/train_fleet`` (git-ignored); B's step 4
    goes once B is done, the rest at the end."""
    gc.collect()
    torch.cuda.empty_cache()
    bundle = train_fleet_bundle()
    n = bundle.param_count()
    L = TRAIN_FLEET["layers"]
    state_bytes = n * 2 + 2 * n * 4 + 4      # bf16 params, f32 mu/nu, step
    root = ROOT / "build" / "train_fleet"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = {"before": shutil.disk_usage(root).free}
    # B's steps 4 and 8 at most, then its 8 and C's 12
    require(free["before"] >= 2.2 * state_bytes,
            f"train_fleet: {free['before']} bytes free under {root}, the "
            f"phase holds two checkpoints of ~{state_bytes}")
    row = dict(params=n, state_bytes=state_bytes, layers=L,
               device_free_before=torch.cuda.mem_get_info()[0],
               parent_reserved_bytes=torch.cuda.memory_reserved())
    ckpt_b = root / "ckpt_b"
    started = None
    try:
        a = run_train_fleet("a", root, None, TRAIN_FLEET["steps"])
        emit("train_fleet_a", **a)
        # the small runs share the card with B, whose numbers matter
        # least: its restart's timing is a race by design
        started = start_train_fleet_cli(root)
        b = run_train_fleet("b", root, ckpt_b, TRAIN_FLEET["steps"],
                            chaos=("kill@5",),
                            restart_after=TRAIN_FLEET_RESTORE_STEP)
        cli = finish_train_fleet_cli(root, started)
        free["with_b"] = shutil.disk_usage(root).free
        shard_bytes = (ckpt_b / "step_00000008" / "shard_0.npz").stat() \
            .st_size if (ckpt_b / "step_00000008").is_dir() else None
        shutil.rmtree(ckpt_b / "step_00000004", ignore_errors=True)
        emit("train_fleet_b", shard_bytes=shard_bytes, **b)
        c = run_train_fleet("c", root, ckpt_b,
                            TRAIN_FLEET["restart_steps"], striped="always")
        free["with_c"] = shutil.disk_usage(root).free
        emit("train_fleet_c", shard_bytes=shard_bytes, **c)
        shutil.rmtree(ckpt_b, ignore_errors=True)
    finally:
        stop_train_fleet_cli(started)
        shutil.rmtree(root, ignore_errors=True)
        free["after_cleanup"] = shutil.disk_usage(ROOT / "build").free

    def worker_launches(run):
        return {t: [w and {k: w.get("launches", {}).get(k, 0)
                           for k in FLASH_ROUTE_KEYS} for w in r["workers"]]
                for t, r in run["ranks"].items()}
    row.update(disk_free=free, shard_bytes=shard_bytes,
               wall_s={r["name"]: r["wall_s"] for r in (a, b, c)},
               worker_peak_rss_bytes={r["name"]: max(
                   (w or {}).get("peak_host_rss_bytes") or 0
                   for rank in r["ranks"].values() for w in rank["workers"])
                   for r in (a, b, c)},
               launches={r["name"]: worker_launches(r) for r in (a, b, c)},
               cli_wall_s={r["run"]: r["wall_s"] for r in cli})
    emit("train_fleet", **row)

    def crcs(run):
        return {t: r["params_crc"] for t, r in run["ranks"].items()}
    # at the default hang timeout no save is taken for a hang
    require(all(r["hang_kills"] == 0 for r in (a, b, c)),
            f"train_fleet: hang kills {[r['hang_kills'] for r in (a, b, c)]}")
    want = a["ranks"][0]["params_crc"]
    require(a["outcome"] == "completed" and a["final_checkpoint_step"] is None
            and want and set(crcs(a).values()) == {want},
            f"train_fleet A: {a['outcome']}, final step "
            f"{a['final_checkpoint_step']}, crcs {crcs(a)}")
    require(b["outcome"] == "completed" and b["final_checkpoint_step"] == 8
            and b["ranks"][1]["exit_history"] == [43, 0]
            and b["ranks"][1]["attempts"] == 2
            and b["ranks"][0]["attempts"] == 1
            and set(crcs(b).values()) == {want},
            f"train_fleet B: {b['outcome']}, final step "
            f"{b['final_checkpoint_step']}, exits "
            f"{[r['exit_history'] for r in b['ranks'].values()]}, crcs "
            f"{crcs(b)} vs A's {want}")
    # the restarted rank resumed from a checkpoint, not from step 0
    back = b["ranks"][1]
    require(back["start_step"] == TRAIN_FLEET_RESTORE_STEP
            and back["restore_ops"] == {"restore": 1, "restore_striped": 0}
            and back["read_bytes"]["full"] > 0,
            f"train_fleet B rank 1 restart: start {back['start_step']}, "
            f"restores {back['restore_ops']}, read {back['read_bytes']}")
    for t, r in c["ranks"].items():
        require(r["restore_ops"]["restore_striped"] == 1
                and 0 < r["read_bytes"]["striped"] < shard_bytes
                and r["stripe_bytes"]["recv"] > 0
                and r["start_step"] == 8,
                f"train_fleet C rank {t}: striped restores "
                f"{r['restore_ops']}, read {r['read_bytes']} of "
                f"{shard_bytes}, stripes {r['stripe_bytes']}, start "
                f"{r['start_step']}")
    require(c["outcome"] == "completed" and len(set(crcs(c).values())) == 1,
            f"train_fleet C: {c['outcome']}, crcs {crcs(c)}")
    for run in (a, b, c):
        for t, r in run["ranks"].items():
            require(r["steps"] > 0 and set(r["flash_dispatch"]) == {
                "impl=cuda,kernel=flash_attention"},
                f"train_fleet {run['name']} rank {t}: flash dispatch "
                f"{r['flash_dispatch']} over {r['steps']} steps")
            for w in r["workers"]:
                fl = w and w.get("launches")
                require(fl is not None
                        and all(fl.get(k, 0) == 0 for k in (
                            "flash_fwd_simt", "flash_bwd_dq_simt",
                            "flash_bwd_dkv_simt"))
                        and fl.get("flash_fwd", 0)
                        == fl.get("flash_bwd_dq", 0)
                        == fl.get("flash_bwd_dkv", 0),
                        f"train_fleet {run['name']} rank {t}: worker "
                        f"launches {w}")
        # the steps each attempt runs: B's rank 1 dies at step 5 and
        # runs steps 4-7 again from the step-4 checkpoint
        want_steps = {"a": {0: [8], 1: [8]}, "b": {0: [8], 1: [5, 4]},
                      "c": {0: [4], 1: [4]}}[run["name"]]
        for t, per_attempt in want_steps.items():
            got = [(w or {}).get("launches", {}).get("flash_bwd_dq", 0)
                   for w in run["ranks"][t]["workers"]]
            require(got == [L * s for s in per_attempt],
                    f"train_fleet {run['name']} rank {t}: backward "
                    f"launches {got} an attempt, want "
                    f"{[L * s for s in per_attempt]}")
    return row


# ---------------------------------------------------------------------------
# phase 6b: the multi-process slice: NCCL at a world of one, then four
# processes on the one card at the (2, 2) stand-in of ``--mesh single``
# (gloo by the backend rule: four local ranks share one card)
# ---------------------------------------------------------------------------

PROCESS_MESH_WORKER = "--process-mesh-worker"
# the production meshes' stand-ins, set in each worker's own process
PROCESS_MESH_SHAPES = {False: ((2, 2), ("data", "model")),
                       True: ((2, 1, 2), ("pod", "data", "model"))}
# qwen3-4b at full width cut to 4 of its 36 layers.  Memory allows 8: the
# state is 12 bytes a param (bf16 params and grads, f32 moments), half of
# it a rank at model 2, so 8 layers (1.59 B params) take ~9.5 GB a process
# (11.9 GB peak, one H100), where 36 (4.4 B) would need ~105 GB for four
# processes.  Time cut it to 4: at 8 the phase took 108.7-132.7 s and the
# script 850-1,120 s, over its 1,100 s aim in a slow call; the step's
# gloo sums and a decode tick's scale with the depth
PROCESS_MESH = dict(arch="qwen3-4b-4l", layers=4, world=4, B=2, S=2048,
                    steps=3, timeout_s=400, logits_prompt=1536)
PROCESS_MESH_LEAVES = SHARDED_LEAVES
PROCESS_MESH_MODES = (("paged", "paged_decode_bf16"),
                      ("paged_int8", "paged_decode_int8"))


def process_mesh_bundle():
    """qwen3-4b's full bundle cut in depth only, under its own id."""
    import dataclasses
    from repro_torch.configs import get_bundle
    b = get_bundle(ARCH)
    return dataclasses.replace(
        b, arch_id=PROCESS_MESH["arch"],
        cfg=dataclasses.replace(b.cfg, n_layers=PROCESS_MESH["layers"]))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_world_one() -> dict:
    """(a) NCCL alone: ``init_process_group("nccl")`` at world 1, a (1, 1)
    process mesh, and each of ``ProcessRing``'s c10d paths applied
    directly (the ring skips a size-1 axis) to bf16 and f32 tensors on the
    card: the sum (in f32), the all-gather, the reduce-scatter (in f32),
    the all-to-all and a ``batch_isend_irecv`` to itself; each result must
    equal its input bit for bit."""
    import os

    import torch.distributed as dist
    from repro_torch.parallel.mesh import (ProcessRing, _AllGather, _AllSum,
                                           _AllToAll, _ReduceScatter,
                                           make_process_mesh)
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://",
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_process_mesh((1, 1), ("data", "model"))
        ring = ProcessRing()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        ops_ = {}
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(4, 256, 128, generator=g, device="cuda").to(dt)
            back = torch.empty_like(x)
            ring._send_recv([x], [back], 0, 0)
            got = {"all_sum": _AllSum.apply(x, ring),
                   "all_gather": _AllGather.apply(x, 1, ring),
                   "reduce_scatter": _ReduceScatter.apply(x, 1, ring),
                   "all_to_all": _AllToAll.apply(x, ring),
                   "send_recv_self": back}
            torch.cuda.synchronize()
            for k, v in got.items():
                ops_[f"{k}/{str(dt).replace('torch.', '')}"] = \
                    same_bits(v, x)
        return dict(backend=str(dist.get_backend()),
                    nccl=".".join(map(str, torch.cuda.nccl.version())),
                    ring_backend=ring.backend,
                    stages_hop=ring.stages_hop, staged=ring.staged,
                    mesh=repr(mesh), bit_equal=ops_)
    finally:
        dist.destroy_process_group()


def _held(tree, L: int, keep: bool = True) -> dict:
    """The first and last layer's slices of ``PROCESS_MESH_LEAVES`` (and
    the embedding and lm_head whole) of a tree, gathered where placed (a
    collective on a process mesh: every rank calls it), as f32 host
    tensors; nothing is kept unless ``keep``."""
    from repro_torch.parallel.sharding import Placed, gather_leaf
    out = {}
    for n in PROCESS_MESH_LEAVES:
        leaf = tree[n] if n in ("embed", "lm_head") else tree["layers"][n]
        whole = gather_leaf(leaf) if isinstance(leaf, Placed) else leaf
        if keep and n in ("embed", "lm_head"):
            out[n] = whole.float().cpu()
        elif keep:
            out[f"{n}[0]"] = whole[0].float().cpu()
            out[f"{n}[{L - 1}]"] = whole[L - 1].float().cpu()
        del whole
    return out


def _probes(get) -> dict:
    return {"wq[0]": get("wq")[0, :64, :64].clone(),
            "w_gate[last]": get("w_gate")[-1, :64, :64].clone(),
            "embed": get("embed")[:64, :64].clone()}


def process_mesh_rank(out_dir: Path) -> dict:
    """(b) One of the four processes (torchrun's variables set by the
    parent): the production meshes' stand-ins in this process, then
    ``launch.train.run(mesh_kind="single")`` (it joins the group: gloo by
    the rule) for 3 AdamW steps at B 2 x S 2048, the first moments after
    step 1 of the held leaves gathered, then placed ``paged`` and
    ``paged_int8`` engines on the same mesh.  Rank 0 writes its held
    leaves and first-token logits to ``out_dir``."""
    import os

    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import gather_leaf, tree_mesh
    lmesh.PRODUCTION_SHAPES.update(PROCESS_MESH_SHAPES)
    rank = int(os.environ["RANK"])
    bundle = process_mesh_bundle()
    L, cfg = bundle.cfg.n_layers, bundle.cfg
    start = [bundle.init_params(SEED, device="cuda")]
    before = _probes(lambda n: start[0][n] if n == "embed" else
                     start[0]["layers"][n])
    held, marks = {}, {}
    # step 0's saved-for-backward bytes: what autograd's saved-tensor hooks
    # see outside the remat units (each distinct tensor once, parameters
    # not counted) and the units' own inputs (``layers.unit_inputs``)
    outside = {"on": True, "seen": set(), "bytes": 0}

    def pack(t):
        if outside["on"] and not (t.is_leaf and t.requires_grad):
            key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                   tuple(t.shape), t.dtype)
            if key not in outside["seen"]:
                outside["seen"].add(key)
                outside["bytes"] += t.numel() * t.element_size()
        return t

    def on_step(i, p, opt, m):
        if i == 0:
            outside["on"] = False
            marks["units"] = list(units)
            held.update(_held(opt["mu"], L, keep=rank == 0))
        # the counter's totals after steps 0 and 1 (the held leaves'
        # gathers in step 0's): step 1's collectives are their difference
        if i < 2:
            marks[i] = dict(coll.cost.collectives)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with CollectiveMode() as coll, layers.unit_inputs() as units, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ltrain.run(bundle, smoke=False, steps=PROCESS_MESH["steps"],
                         seq_len=PROCESS_MESH["S"],
                         global_batch=PROCESS_MESH["B"], microbatches=1,
                         mesh_kind="single", params=start.pop(),
                         on_step=on_step, log_every=100)
    train_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    D = cfg.d_model
    unit_bytes = [sum(math.prod(sh) * dt.itemsize for sh, dt in seen)
                  for seen in marks["units"]]
    # each unit's residual rows: its saved (B_rank, rows, D) inputs
    residual = [sum(math.prod(sh) for sh, dt in seen
                    if dt.is_floating_point and len(sh) == 3
                    and sh[-1] == D) for seen in marks["units"]]
    p = out["params"]
    mesh = tree_mesh(p)
    after = _probes(lambda n: gather_leaf(p[n] if n == "embed" else
                                          p["layers"][n]))
    moved = {k: not torch.equal(before[k], after[k]) for k in before}
    row = dict(rank=rank, backend=out["backend"], mesh=repr(mesh),
               losses=out["losses"],
               finite=[m["finite"] for m in out["metrics"]],
               grad_norm=[m["grad_norm"] for m in out["metrics"]],
               s_per_step=out["seconds"],
               tok_per_s_after_first=PROCESS_MESH["B"] * PROCESS_MESH["S"]
               * (len(out["seconds"]) - 1) / sum(out["seconds"][1:]),
               params_moved=moved, opt_step=int(out["opt"]["step"]),
               train_launches=train_launches,
               train_peak_bytes=torch.cuda.max_memory_allocated(),
               collective_bytes_step1={k: int(v - marks[0].get(k, 0))
                                       for k, v in marks[1].items()},
               saved_bytes_step0=outside["bytes"] + sum(unit_bytes),
               saved_outside_units_bytes=outside["bytes"],
               unit_saved_bytes=unit_bytes,
               residual_elems_per_unit=residual)
    if rank == 0:
        torch.save(held, out_dir / "held_r0.pt")
    del out, p, held, before, after
    gc.collect()
    torch.cuda.empty_cache()

    serves = {}
    for mode, key in PROCESS_MESH_MODES:
        reqs, kw = workload(mode, cfg.vocab)
        engine, _ = build_engine(bundle, smoke=False, max_len=2048,
                                 kv_mode=mode, device="cuda", mesh=mesh,
                                 place=True, **kw)
        watch = FiniteWatch(engine.bundle)
        engine.bundle = watch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for q in reqs:
            engine.submit(q)
        results = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine.check_kv()
        n_tok = sum(len(v) for v in results.values())
        serves[mode] = dict(
            tokens=results, outcomes=sorted(set(engine.outcomes.values())),
            max_new=kw["max_new"], generated_tokens=n_tok, wall_s=wall,
            tok_per_s=n_tok / wall, decode_steps=watch.decode_steps,
            finite=bool(watch.finite.item()),
            launches={k: v for k, v in ops.LAUNCHES.items() if v},
            key=key, owner=[engine.owner, engine.owners],
            pages_held=engine.pool["k"].shape[1],
            pages_total=engine.kv.cfg.total_pages,
            prefix=engine.prefix_stats(),
            peak_bytes=torch.cuda.max_memory_allocated())
        del engine, watch
        torch.cuda.empty_cache()
    # the first token's logits of one prompt alone: slot 0 is data rank
    # 0's, so ranks 0 and 1 hold its row
    prompt = prompts(1, PROCESS_MESH["logits_prompt"],
                     PROCESS_MESH["logits_prompt"], SEED + 9, cfg.vocab)[0]
    engine, _ = build_engine(bundle, smoke=False, max_len=2048,
                             kv_mode="paged", slots=4, max_new=2,
                             page_size=16, prefill_chunk=256,
                             prefill_token_budget=1024, device="cuda",
                             mesh=mesh, place=True)
    with torch.no_grad():
        logits = token_logits(engine, prompt, 1)[0]
    if rank == 0:
        torch.save(logits.cpu(), out_dir / "logits_r0.pt")
    del engine
    row.update(serve=serves, staged_bytes={
        a: t.staged for a, t in mesh.transports.items()
        if hasattr(t, "staged")},
        stages_hop={a: t.stages_hop for a, t in mesh.transports.items()
                    if hasattr(t, "stages_hop")})
    dist.destroy_process_group()
    return row


def process_mesh_worker(argv: list[str]) -> int:
    """``python chip_smoke.py --process-mesh-worker nccl|rank OUT_DIR``:
    one worker of the ``process_mesh`` phase; prints its row as one
    ``[process-mesh-worker]`` JSON line and returns 0, or 1 after
    printing the error."""
    from repro_torch.kernels import ops
    code = 0
    try:
        row = nccl_world_one() if argv[0] == "nccl" else \
            process_mesh_rank(Path(argv[1]))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback
        traceback.print_exc()
        row, code = {"error": f"{type(e).__name__}: {e}"}, 1
    row["exit"] = code
    row.setdefault("launches", {k: v for k, v in ops.LAUNCHES.items() if v})
    print("[process-mesh-worker] " + json.dumps(row, default=_plain),
          flush=True)
    return code


def _start_workers(cmds: list[tuple[list[str], dict]]) -> list:
    """Start every (argv, env) at once, their output piped."""
    import os
    return [subprocess.Popen(argv, env={**os.environ, **env},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv, env in cmds]


def _collect_workers(procs: list, timeout_s: float) -> list[dict]:
    """Wait up to ``timeout_s`` for every started worker, kill what is
    left; each one's ``[process-mesh-worker]`` row (with the end of its
    output when it has none)."""
    outs, t0 = [], time.perf_counter()
    try:
        for pr in procs:
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            try:
                outs.append(pr.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                pr.kill()
                outs.append(pr.communicate()[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    rows = []
    for text in outs:
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("[process-mesh-worker] ")]
        rows.append(json.loads(lines[-1].split(" ", 1)[1]) if lines else
                    {"exit": None, "log_tail": text[-3000:]})
    return rows


def process_mesh_refs(bundle, ref_dir: Path) -> dict:
    """In the parent, before the workers: the unsharded step at the same
    depth (its loss and the held leaves' first moments after step 1), the
    same 3 steps on a (2, 2) mesh of local rings (its losses), and the
    unsharded engines' tokens and first-token logits."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.train import run
    from repro_torch.parallel import make_mesh
    L = bundle.cfg.n_layers
    kw = dict(smoke=False, seq_len=PROCESS_MESH["S"],
              global_batch=PROCESS_MESH["B"], microbatches=1,
              device="cuda", log_every=100)
    held = {}

    def on_step(i, p, opt, m):
        if i == 0:
            held.update(_held(opt["mu"], L))
    one = run(bundle, steps=1, on_step=on_step, **kw)
    torch.save(held, ref_dir / "held_unsharded.pt")
    loss_unsharded = one["losses"][0]
    del one, held
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    local = run(bundle, steps=PROCESS_MESH["steps"],
                mesh_kind=make_mesh(*PROCESS_MESH_SHAPES[False]), **kw)
    local_row = dict(losses=local["losses"], s_per_step=local["seconds"],
                     grad_norm=[m["grad_norm"] for m in local["metrics"]],
                     wall_s=time.perf_counter() - t0)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    params = bundle.init_params(SEED, device="cuda")
    tokens = {}
    with torch.no_grad():
        for mode, _ in PROCESS_MESH_MODES:
            reqs, skw = workload(mode, bundle.cfg.vocab)
            engine, _ = build_engine(bundle, smoke=False, max_len=2048,
                                     kv_mode=mode, params=params,
                                     device="cuda", **skw)
            for q in reqs:
                engine.submit(q)
            tokens[mode] = engine.run()
            del engine
        prompt = prompts(1, PROCESS_MESH["logits_prompt"],
                         PROCESS_MESH["logits_prompt"], SEED + 9,
                         bundle.cfg.vocab)[0]
        engine, _ = build_engine(bundle, smoke=False, max_len=2048,
                                 kv_mode="paged", slots=4, max_new=2,
                                 page_size=16, prefill_chunk=256,
                                 prefill_token_budget=1024, params=params,
                                 device="cuda")
        logits = token_logits(engine, prompt, 1)[0].cpu()
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_unsharded=loss_unsharded, local=local_row,
                tokens=tokens, logits=logits)


def process_mesh_phase() -> dict:
    """Phase 6b: (a) NCCL at world 1 in a subprocess (every ring path bit
    for bit; backend and NCCL version printed); (b) four processes on the
    one card, started through this script's worker entry with torchrun's
    variables, at the (2, 2) stand-in of ``--mesh single`` (gloo by the
    rule, the ring staging only the point-to-point hop through pinned
    host memory): qwen3-4b at full width cut to ``PROCESS_MESH["layers"]``
    trained 3 steps at B 2 x S 2048 (finite losses, probed params moved,
    each step's loss within 1e-5 relative of the same (2, 2) mesh of local
    rings, the held leaves' first moments after step 1 within
    ``train_check``'s limits of the unsharded step's, flash launches L x
    (2 fwd + dq + dkv) a step on the wgmma routes in each process), then
    placed ``paged`` and ``paged_int8`` engines (every request its tokens,
    half the pages a rank, the pool's invariants, L paged-decode launches
    a decoding tick in each process, the first token's logits cosine >
    0.99 and top-1 equal against the unsharded engine; token agreement
    printed).  The workers' launches stay on this phase's line."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    bundle = process_mesh_bundle()
    L = bundle.cfg.n_layers
    root = ROOT / "build" / "process_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    me = [sys.executable, str(ROOT / "chip_smoke.py"), PROCESS_MESH_WORKER]
    # (a) runs beside the parent's references and then the four ranks (it
    # moves a few MB), and is collected with the ranks
    procs = _start_workers([(me + ["nccl"], {})])
    try:
        refs = process_mesh_refs(bundle, root)
        torch.cuda.empty_cache()
        t_refs = time.perf_counter() - t0
        world, port = PROCESS_MESH["world"], free_port()
        env = lambda r: dict(RANK=str(r), WORLD_SIZE=str(world),  # noqa
                             LOCAL_RANK=str(r),
                             LOCAL_WORLD_SIZE=str(world),
                             MASTER_ADDR="localhost", MASTER_PORT=str(port))
        t1 = time.perf_counter()
        procs += _start_workers(
            [(me + ["rank", str(root)], env(r)) for r in range(world)])
        nccl, *ranks = _collect_workers(procs, PROCESS_MESH["timeout_s"])
        t_ranks = time.perf_counter() - t1
        held = torch.load(root / "held_r0.pt") \
            if (root / "held_r0.pt").is_file() else None
        want_held = torch.load(root / "held_unsharded.pt")
        logits = torch.load(root / "logits_r0.pt") \
            if (root / "logits_r0.pt").is_file() else None
    finally:
        for pr in procs:                    # stopped if still running
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(root, ignore_errors=True)

    require(nccl.get("exit") == 0 and nccl["backend"] == "nccl" and
            all(nccl["bit_equal"].values()),
            f"process_mesh (a) NCCL at world 1: {nccl}")
    require(all(r.get("exit") == 0 for r in ranks),
            f"process_mesh (b): workers {ranks}")
    local = refs["local"]["losses"]
    rel = [max(abs(a - b) / abs(b) for a, b in zip(r["losses"], local))
           for r in ranks]
    bits = [r["losses"] == local for r in ranks]
    cos, ratio, t2 = None, None, time.perf_counter()
    if held is not None:
        # in f64 (an f32 dot of the 389 M embedding terms reads above 1),
        # on the card: on the host the two 389 M leaves take seconds
        cos, ratio = {}, {}
        for k in list(want_held):
            a = held.pop(k).cuda().double().flatten()
            b = want_held.pop(k).cuda().double().flatten()
            cos[k] = F.cosine_similarity(a, b, dim=0).item()
            ratio[k] = (a.norm() / b.norm()).item()
            del a, b
        torch.cuda.empty_cache()
    t_compare = time.perf_counter() - t2
    loss_rel = abs(ranks[0]["losses"][0] - refs["loss_unsharded"]) / \
        abs(refs["loss_unsharded"])
    gbits = [r["grad_norm"] == refs["local"]["grad_norm"] for r in ranks]
    (nd, m), _ = PROCESS_MESH_SHAPES[False]
    # a process's rows of the residual: its B / d rows x S / m positions
    want_res = PROCESS_MESH["B"] // nd * PROCESS_MESH["S"] // m * \
        process_mesh_bundle().cfg.d_model
    want_flash = {"flash_fwd": L * PROCESS_MESH["steps"],
                  "flash_bwd_dq": L * PROCESS_MESH["steps"],
                  "flash_bwd_dkv": L * PROCESS_MESH["steps"]}
    lg = None
    if logits is not None:
        a, b = logits.float(), refs["logits"].float()
        lg = dict(cosine=F.cosine_similarity(a, b, dim=0).item(),
                  top1_equal=bool(a.argmax() == b.argmax()),
                  max_abs_diff=(a - b).abs().max().item(),
                  finite=bool(torch.isfinite(a).all()))
    agree = {mode: [agreement({int(k): v for k, v in
                               r["serve"][mode]["tokens"].items()},
                              refs["tokens"][mode]) for r in ranks]
             for mode, _ in PROCESS_MESH_MODES}
    row = dict(
        arch=ARCH, n_layers=L, depth_cut=f"{L} of 36 layers: the "
        f"script's time (memory allows 8)", world=world,
        shapes={str(k): v for k, v in PROCESS_MESH_SHAPES.items()},
        B=PROCESS_MESH["B"], S=PROCESS_MESH["S"], nccl=nccl,
        backend=[r["backend"] for r in ranks],
        stages_hop=ranks[0]["stages_hop"],
        losses=[r["losses"] for r in ranks], local_losses=local,
        grad_norm=[r["grad_norm"] for r in ranks],
        local_grad_norm=refs["local"]["grad_norm"],
        loss_rel_diff_vs_local=rel, loss_bit_equal_vs_local=bits,
        local_s_per_step=refs["local"]["s_per_step"],
        loss_unsharded_step0=refs["loss_unsharded"],
        loss_rel_diff_vs_unsharded=loss_rel, held_cosine=cos,
        held_norm_ratio=ratio,
        s_per_step=[r["s_per_step"] for r in ranks],
        tok_per_s_after_first=[r["tok_per_s_after_first"] for r in ranks],
        train_peak_bytes=[r["train_peak_bytes"] for r in ranks],
        grad_norm_bit_equal_vs_local=gbits,
        collective_bytes_step1=[r["collective_bytes_step1"] for r in ranks],
        saved_bytes_step0=[r["saved_bytes_step0"] for r in ranks],
        saved_outside_units_bytes=[r["saved_outside_units_bytes"]
                                   for r in ranks],
        residual_elems_per_unit=[r["residual_elems_per_unit"]
                                 for r in ranks],
        want_residual_elems=want_res,
        serve={mode: [{k: v for k, v in r["serve"][mode].items()
                       if k != "tokens"} for r in ranks]
               for mode, _ in PROCESS_MESH_MODES},
        token_agreement_vs_unsharded=agree, logits=lg,
        staged_bytes=[r["staged_bytes"] for r in ranks],
        launches=[{"train": r["train_launches"],
                   **{m: r["serve"][m]["launches"]
                      for m, _ in PROCESS_MESH_MODES}} for r in ranks],
        want_flash=want_flash, refs_s=t_refs, ranks_s=t_ranks,
        compare_s=t_compare,
        seconds=time.perf_counter() - t0, nvidia_smi=smi())
    emit("process_mesh", **row)
    require(all(b == "gloo" for b in row["backend"]),
            f"process_mesh: backends {row['backend']}, want gloo (four "
            f"local ranks on one card)")
    require(all(all(math.isfinite(x) for x in r["losses"]) and
                all(f == 1.0 for f in r["finite"]) and
                len(r["losses"]) == PROCESS_MESH["steps"] and
                r["opt_step"] == PROCESS_MESH["steps"] and
                all(r["params_moved"].values()) for r in ranks),
            "process_mesh: a loss, finite flag, step or probe is bad: "
            + str([(r['losses'], r['finite'], r['params_moved'])
                   for r in ranks]))
    require(max(rel) < 1e-5,
            f"process_mesh: loss vs the local (2, 2) mesh: rel {rel}")
    require(all(bits) and all(gbits),
            f"process_mesh: losses {bits} and grad norms {gbits} not bit "
            f"for bit the local (2, 2) mesh's")
    require(all(r["residual_elems_per_unit"] == [want_res] * L
                for r in ranks) and
            all(r["collective_bytes_step1"].get("reduce-scatter", 0) > 0
                for r in ranks),
            f"process_mesh: each unit must keep its process's {want_res} "
            f"residual elements and the step reduce-scatter: "
            f"{[r['residual_elems_per_unit'] for r in ranks]} "
            f"{[r['collective_bytes_step1'] for r in ranks]}")
    require(cos is not None and loss_rel < 1e-3 and
            all(c > 0.99 for c in cos.values()) and
            all(abs(x - 1.0) < NORM_TOL for x in ratio.values()),
            f"process_mesh: step 1 vs unsharded: loss rel {loss_rel}, "
            f"cosine {cos}, norm ratio {ratio}")
    for r in ranks:
        fl = r["train_launches"]
        require({k: fl.get(k, 0) for k in FLASH_KEYS} ==
                dict(dict.fromkeys(FLASH_KEYS, 0), **want_flash),
                f"process_mesh rank {r['rank']}: flash launches {fl}, "
                f"want {want_flash}")
        for mode, key in PROCESS_MESH_MODES:
            s = r["serve"][mode]
            require(s["outcomes"] == ["ok"] and s["finite"] and
                    len(s["tokens"]) == len(workload(mode, 2)[0]) and
                    all(len(v) == s["max_new"] for v in s["tokens"].values())
                    and s["pages_held"] * 2 == s["pages_total"]
                    and s["decode_steps"] > 0
                    and s["launches"].get(key, 0) == L * s["decode_steps"],
                    f"process_mesh rank {r['rank']} {mode}: {s}")
    require(lg is not None and lg["finite"] and lg["cosine"] > 0.99 and
            lg["top1_equal"],
            f"process_mesh: first-token logits vs unsharded: {lg}")
    return row


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
    torch.cuda.empty_cache()

    # phase 5': the op cost counter at full width, the live roofline rows
    roofline = roofline_phase(params, served)
    del params
    torch.cuda.empty_cache()

    # phase 5a: the context-parallel ring on a (1, 4) local mesh
    ring = ring_phase()
    torch.cuda.empty_cache()

    # phase 5c: the MoE's expert-parallel, token-split and TP-in-expert
    # branches on local meshes: olmoe served, granite-moe trained
    moe_mesh = moe_mesh_phase(moe["results"])
    torch.cuda.empty_cache()

    # phase 5d: the sharded state: qwen3-4b placed by param_specs, trained
    # under (2, 4) and served under (1, 4) on local rings
    sharded = sharded_phase(trained["max_memory_allocated"])
    torch.cuda.empty_cache()

    # phase 5e: the placed state of mamba2-370m, recurrentgemma-9b and
    # whisper-medium: each family's (2, 4) step against the unsharded one,
    # its (1, 4) placed dense engine, 3 steps under (2, 4)
    sharded_families = sharded_families_phase()
    torch.cuda.empty_cache()

    # phase 5b: train the vlm, hybrid, audio and ssm families at full width
    families_trained = train_families()

    # phase 6: kill and restart the full-width training from a checkpoint
    recovered = recovery()

    # phase 6a: the train side of the fleet: supervised worker processes
    # (their launches are on the phase's own line, not the kernels line)
    train_fleet()

    # phase 6b: the multi-process slice: NCCL at world 1, four processes
    # at the (2, 2) stand-in of --mesh single (launches on its own line)
    process_mesh_phase()

    # phase 7: the kernels line (one row per kernel route a main path runs),
    # launches from the paper-workload, serve, serve_fleet, serve_moe,
    # serve_families, train, roofline, train_ring, moe_mesh, sharded,
    # sharded_families, train_families and recovery phases
    phases = (paper, *(r["launches"] for r in served.values()), fleet,
              moe["launches"], families, trained["launches"], roofline, ring,
              moe_mesh, sharded, sharded_families, families_trained,
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
    if sys.argv[1:2] == [TRAIN_FLEET_WORKER]:
        sys.exit(train_fleet_worker(sys.argv[2:]))
    if sys.argv[1:2] == [PROCESS_MESH_WORKER]:
        sys.exit(process_mesh_worker(sys.argv[2:]))
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
