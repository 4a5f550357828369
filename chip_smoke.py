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
gather path over bf16 and int8 pools, does the same for olmoe-1b-7b, a
top-8-of-64 MoE (``serve_moe``: the flash forward at MHA, the paged decode
at 16 kv heads, the share of expert assignments the capacity drops; the
two kernels are also checked alone at olmoe's and granite-moe's heads),
serves internvl2-26b (vlm: a 256-token vision prefix, GQA group 6),
recurrentgemma-9b (hybrid: RG-LRU and local MQA at head_dim 256 through the
flash forward's CUDA-core route, one prompt past its 2048-token window),
whisper-medium (audio: a non-causal encoder over 1500 frames and
cross-attention to them) and mamba2-370m (ssm: no kernel) at full width in
the dense KV mode, one family's weights at a time (``serve_families``,
each with its flash-vs-plain ``logits_check``; the flash forward is also
checked alone at their shapes), holds the flash kernels' loss and
gradients against the plain attention path, trains qwen3-4b at full width
for a few AdamW steps through ``repro_torch.launch.train``, drills a kill
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
# HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
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


def closeness(got: torch.Tensor, want: torch.Tensor, atol: float) -> dict:
    """How far a bf16 kernel output lies from its f32-arithmetic plain
    version, row by row over the last axis.  Each element must satisfy
    |got - want| <= 2^-7 |want| + atol (one bf16 ulp of the value, since
    the two sum in different orders before rounding, plus ``atol``), and
    each row's relative L2 error must stay under 2^-6, which a wrong
    score or PV accumulation in any row exceeds by far."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ratio = (diff / (2.0 ** -7 * want.abs() + atol)).max().item()
    row_rel = (diff.norm(dim=-1) /
               want.norm(dim=-1).clamp_min(1e-30)).max().item()
    return dict(max_abs_err=diff.max().item(), worst_tol_ratio=ratio,
                max_row_rel_l2=row_rel, mean_abs_out=want.abs().mean().item(),
                tol=f"|err| <= 2^-7|want| + {atol}; row rel L2 <= 2^-6",
                within_tol=ratio <= 1.0 and row_rel <= 2.0 ** -6)


def closeness_rounded(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far the wgmma backward's f32 output lies from its plain version,
    which rounds p and ds to bf16 as the kernel does.  Where the two f32
    values (summed in other orders) straddle a bf16 rounding boundary, one
    term of a sum moves by one bf16 ulp, at most 2^-7 of itself: each
    element within 2^-7 (|want| + its row's RMS) + 1e-5 max|want|, each
    row's L2 error within 2^-7 of its norm + 1e-5 max|want| sqrt(D) (a row
    dominated by one term moves by up to 2^-7; a row that cancels to 0
    keeps the floor), and the whole tensor's relative L2 error under
    2^-10, as flips are rare and unbiased."""
    diff = (got - want).abs()
    atol = 1e-5 * want.abs().max().item()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = (diff / (2.0 ** -7 * (want.abs() + rms) + atol)).max().item()
    row_ratio = (diff.norm(dim=-1) / (2.0 ** -7 * want.norm(dim=-1) +
                                      atol * want.shape[-1] ** 0.5)
                 ).max().item()
    rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    return dict(max_abs_err=diff.max().item(), worst_tol_ratio=ratio,
                worst_row_tol_ratio=row_ratio, tensor_rel_l2=rel,
                mean_abs_out=want.abs().mean().item(),
                tol="|err| <= 2^-7 (|want| + row RMS) + 1e-5 max|want|; row "
                    "L2 <= 2^-7 |want row| + 1e-5 max|want| sqrt(D); tensor "
                    "rel L2 <= 2^-10",
                within_tol=ratio <= 1.0 and row_ratio <= 1.0 and
                rel <= 2.0 ** -10)


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
# 128); recurrentgemma-9b's local MQA at head_dim 256, the CUDA-core route
# (its kernels-line row)
FLASH_ZOO_SHAPES = {
    "internvl2-26b": dict(B=2, S=2048, H=48, Hkv=8, D=128),
    "whisper-medium encoder": dict(B=1, S=1500, H=16, Hkv=16, D=64,
                                   causal=False),
    "whisper-medium cross 1024": dict(B=1, S=1024, Sk=1500, H=16, Hkv=16,
                                      D=64, causal=False),
    "whisper-medium cross 16": dict(B=1, S=16, Sk=1500, H=16, Hkv=16, D=64,
                                    causal=False),
}
FLASH_SIMT_SHAPE = dict(B=1, S=4096, H=16, Hkv=1, D=256, window=2048)


def attended_pairs(Sq: int, Sk: int, causal: bool,
                   window: int | None) -> int:
    """(q, k) pairs a query head attends under the kernels' masks (local
    positions: k <= q when causal, q - k < window)."""
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def check_flash(flush, shape: dict = FLASH_SHAPE,
                arch: str | None = None) -> dict:
    """The forward kernel at ``shape`` (default the train phase's: B 2, S
    2048, 32/8 heads, causal), (B, S, H, D) tensors read through transposed
    views; ``shape`` may give ``Sk`` (default S), ``causal`` (default True)
    and ``window``.  bf16 at head_dim 64 or 128 must take the wgmma route,
    head_dim 256 the CUDA-core one; the row is named by its route.
    ``arch`` names the config whose heads an extra shape takes."""
    from repro_torch.kernels import attention as katt
    B, S, H, Hkv, D = (shape[k] for k in ("B", "S", "H", "Hkv", "D"))
    Sk = shape.get("Sk", S)
    causal, window = shape.get("causal", True), shape.get("window")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, n, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for n, h in ((S, H), (Sk, Hkv), (Sk, Hkv)))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    route = katt.flash_fwd_route(qt, kt, vt)
    want = "flash_fwd" if D in (64, 128) else "flash_fwd_simt"
    require(route == want, f"flash forward: bf16 at {shape} takes route "
            f"{route}, not {want}")
    bq, bk = katt.flash_fwd_blocks(route)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
        o_ref, lse_ref = katt.flash_attention_fwd_plain(
            qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D), **kw, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        # atol 2e-3 covers p's bf16 rounding before PV flipping where the
        # two score sums differ in their last f32 bits
        close = closeness(o.reshape(B * H, S, D), o_ref, atol=2e-3)
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
        if window is None:
            sdpa_kw = dict(is_causal=causal)
        else:       # a bool mask (True = attend) of the kernels' band
            qp = torch.arange(S, device="cuda")[:, None]
            kp = torch.arange(Sk, device="cuda")[None, :]
            sdpa_kw = dict(attn_mask=(qp - kp < window) &
                           ((qp >= kp) if causal else True))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **sdpa_kw)
        lib_ms, _ = time_ms(sdpa, 20, flush)
        lib_dev_ms = device_ms(sdpa, 20, flush)
    pairs = B * H * attended_pairs(S, Sk, causal, window)
    bytes_ = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) + \
        4 * lse.numel()
    b_ms, b_by = bound(bytes_, 4 * D * pairs, PEAK_BF16)
    row = dict(name=route, route="cuda",
               source="src/repro_torch/kernels/csrc/flash_fwd.cu",
               replaces="src/repro/kernels/attention.py:153",
               **close, lse_max_abs_err=lse_err, lse_tol=lse_tol,
               ms=ms, ms_spread=ms_spread, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, library_device_ms=lib_dev_ms,
               blocks=[bq, bk],
               shape=dict(B=B, S=S, Sk=Sk, H=H, Hkv=Hkv, D=D,
                          causal=causal, window=window),
               **({} if arch is None else {"arch": arch}))
    emit("kernel_check", **row)
    return row


def check_flash_bwd(flush) -> list[dict]:
    """The dq and dk/dv kernels at the train phase's shape (B 2, S 2048,
    32/8 heads), reached as the train path reaches them: the grads that
    ``flash_attention_train``'s backward returns for (B, S, H, D) leaves
    fed a transposed ``do``.  The shape must take the wgmma route.  That
    backward is ``flash_attention_bwd`` (delta from the strided o and do,
    then the kernels) cast to bf16, so its f32 results on the same
    residuals are held against the plain backward at the route's blocks
    and rounding, and the autograd grads must equal them cast, bit for bit
    (no atomics: every run sums in one order)."""
    from repro_torch.kernels import attention as katt
    B, S, H, Hkv, D = 2, 2048, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    route = katt.flash_bwd_route(qt, kt, vt, dot)
    require(route == "flash_bwd", f"flash backward: the bf16 train shape "
            f"takes route {route}, not the wgmma kernels")
    plain_kw = dict(causal=True, **katt.flash_bwd_plain_kw(route))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o_fn = katt.flash_attention_train(*(x.transpose(1, 2) for x in leaves),
                                      causal=True)
    grads = torch.autograd.grad(o_fn, leaves, dot)
    flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
            vt.reshape(B * Hkv, S, D), dot.reshape(B * H, S, D))
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=True)
        f32 = katt.flash_attention_bwd(qt, kt, vt, o, lse, dot, causal=True)
        delta = (o.float() * dot.float()).sum(-1).reshape(B * H, S) \
            .contiguous()
        dq_ref, dk_ref, dv_ref = katt.flash_attention_bwd_plain(
            *flat, lse, delta, **plain_kw)
        torch.cuda.synchronize()
        dq, dk, dv = f32
        close = {"flash_bwd_dq": closeness_rounded(dq.reshape(B * H, S, D),
                                                   dq_ref)}
        ck = closeness_rounded(dk.reshape(B * Hkv, S, D), dk_ref)
        cv = closeness_rounded(dv.reshape(B * Hkv, S, D), dv_ref)
        close["flash_bwd_dkv"] = {
            **{key: max(ck[key], cv[key]) for key in
               ("max_abs_err", "worst_tol_ratio", "worst_row_tol_ratio",
                "tensor_rel_l2")},
            "mean_abs_out": ck["mean_abs_out"],
            "mean_abs_dv": cv["mean_abs_out"], "tol": ck["tol"],
            "within_tol": ck["within_tol"] and cv["within_tol"]}
        for name, c in close.items():
            require(c["within_tol"], f"{name} disagrees: {c}")
        require(all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)),
                "flash backward: non-finite out")
        # the autograd grads are the f32 results cast, leaf by leaf
        cast_err = [(gr.float() - f.transpose(1, 2).to(torch.bfloat16)
                     .float()).abs().max().item()
                    for gr, f in zip(grads, f32)]
        require(torch.equal(o_fn, o) and all(e == 0.0 for e in cast_err),
                f"flash_attention_train: o equal {torch.equal(o_fn, o)}, "
                f"grads vs f32 results cast, max|err| {cast_err}")
        args = (qt, kt, vt, dot, lse, delta)
        launch = {"flash_bwd_dq": lambda: katt.flash_bwd_dq_cuda(
            *args, causal=True), "flash_bwd_dkv": lambda:
            katt.flash_bwd_dkv_cuda(*args, causal=True)}
        ms = {n: time_ms(f, 20, flush) for n, f in launch.items()}
        dev_ms = {n: device_ms(f, 20, flush) for n, f in launch.items()}
        dq_kw = {k: plain_kw[k] for k in ("causal", "block_q", "block_k",
                                          "rounded")}
        bq, bk = plain_kw["dkv_blocks"]
        dkv_kw = dict(dq_kw, block_q=bq, block_k=bk)
        plain = {"flash_bwd_dq": time_ms(lambda: katt.flash_bwd_dq_plain(
            *flat, lse, delta, **dq_kw), 3, flush)[0],
                 "flash_bwd_dkv": time_ms(lambda: katt.flash_bwd_dkv_plain(
            *flat, lse, delta, **dkv_kw), 3, flush)[0]}
    del grads, o_fn, f32, dq_ref, dk_ref, dv_ref
    # the library's yardstick: SDPA's backward alone, one call for the pair
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (qs, ks, vs), dot, retain_graph=True)
    lib_ms, _ = time_ms(sdpa_bwd, 20, flush)
    lib_dev_ms = device_ms(sdpa_bwd, 20, flush)
    del out, qs, ks, vs
    pairs = B * H * S * (S + 1) // 2               # unmasked (q, k) pairs
    inputs = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + \
        4 * (lse.numel() + delta.numel())
    rows = []
    for name, flops, out_bytes in (
            ("flash_bwd_dq", 6 * D * pairs, 4 * dq.numel()),
            ("flash_bwd_dkv", 8 * D * pairs, 4 * (dk.numel() + dv.numel()))):
        b_ms, b_by = bound(inputs + out_bytes, flops, PEAK_BF16)
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/csrc/flash_bwd.cu",
                   replaces="src/repro/kernels/attention.py:" +
                   ("311" if name == "flash_bwd_dq" else "360"),
                   **close[name], autograd_cast_max_abs_err=cast_err,
                   ms=ms[name][0], ms_spread=ms[name][1],
                   device_ms=dev_ms[name], plain_ms=plain[name],
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_device_ms=lib_dev_ms,
                   library="SDPA backward (causal, GQA), dq+dk+dv in one call",
                   blocks=(plain_kw["block_q"], plain_kw["block_k"])
                   if name == "flash_bwd_dq" else plain_kw["dkv_blocks"],
                   shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, causal=True))
        emit("kernel_check", **row)
        rows.append(row)
    return rows


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


def case_calls(case: dict, seed: int) -> dict:
    """Inputs of one case (numpy, from ``seed``, bf16 on the card, scaled so
    every output has unit variance), and its calls: ``main`` through
    ``ops`` as a user calls it, ``launch`` of the kernel alone with the same
    tile, ``plain`` (the plain version) and ``library`` (one PyTorch call of
    the same function, or None); with the bytes and flops of its bound."""
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
        return torch.from_numpy(x).to("cuda", torch.bfloat16)

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
    if "bytes" not in calls:
        calls["bytes"] = 2 * (in_numel + out_numel)
    calls["flops"] = 2 * case["macs"]
    return calls


def run_case(case: dict, flush, seed: int, iters: int = 20) -> dict:
    """One case through ``ops`` on the card, with the launch counts reset
    just before and read just after (exactly one launch, of the case's
    route); then its output against the plain version, and the kernel's,
    the plain version's and the library call's times (means over ``iters``
    calls, the plain version 3; ``ms`` as a caller waits for it,
    ``device_ms`` the device work alone: ``time_ms``)."""
    from repro_torch.kernels import ops
    kind = case["kernel"]
    calls = case_calls(case, seed)
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
        close = closeness(out, ref, atol=PAPER_ATOL[kind])
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
    b_ms, b_by = bound(calls["bytes"], calls["flops"], PEAK_BF16)
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


def check_paper_kernels(flush) -> list[dict]:
    """The kernel routes of the paper-workload path against their plain
    versions: the matmul's wgmma route at GEMM_1K and its GEMV route at
    GEMM_FC, conv2d's wgmma route at DL_ATROUS4, correlation's wgmma route
    at FLOWNET_CORR, flash decode at qwen3-4b's decode shape.  Each row is
    named by its launch key."""
    by = {c["name"]: c for c in catalog_cases()}
    rows = []
    for i, case in enumerate((by["GEMM_1K"], by["GEMM_FC"], by["DL_ATROUS4"],
                              by["FLOWNET_CORR"], decode_case())):
        r = run_case(case, flush, SEED + 20 + i)
        require(case["kernel"] != "correlation" or r["key"] == "correlation",
                f"{case['name']} took route {r['key']}, not the wgmma "
                f"correlation")
        source, replaces = PAPER_SOURCES[case["kernel"]]
        row = dict(name=r["key"], route="cuda", source=source,
                   replaces=replaces, workload=case["name"],
                   library=PAPER_LIBRARY[case["kernel"]],
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
    from repro_torch.launch.serve import serve_extras
    bundle = get_bundle(arch)
    tok = torch.from_numpy(prompts(1, n, n, SEED + 9,
                                   bundle.cfg.vocab)[0][None]) \
        .long().to("cuda")
    extras = serve_extras(bundle, 1, "cuda") or None
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
# the flash route each family's prefill must launch (mamba2 runs no kernel)
FAMILY_ROUTE = {"internvl2-26b": "flash_fwd",
                "recurrentgemma-9b": "flash_fwd_simt",
                "whisper-medium": "flash_fwd", "mamba2-370m": None}
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
               flash_launches={k: launches[k] for k in
                               ("flash_fwd", "flash_fwd_simt")},
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
    require(flash == 0 if route is None else launches[route] > 0,
            f"{arch}: flash launches {row['flash_launches']}, want "
            f"{route or 'none'}")
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


def train_check(params) -> dict:
    """Loss and gradients of one B 1, S 2048 batch through the flash
    kernels (forward and backward) against the plain attention path, both
    under per-layer recompute: bf16 over 36 layers is not bit-stable across
    attention paths, so this asserts a relative loss difference under 1e-3
    and, per leaf, a cosine over 0.99 and a norm within ``NORM_TOL`` of
    the plain path's."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.models import transformer
    from repro_torch.training import loss_fn
    bundle = get_bundle(ARCH)
    batch = token_batch(1, 2048, SEED + 11, bundle.cfg.vocab)
    L = bundle.cfg.n_layers
    names = ("wq", "wk", "wv")
    leaves = [params["embed"], *(params["layers"][n] for n in names)]
    out = {}
    for impl in ("pallas", "xla"):
        cfg = dataclasses.replace(bundle.cfg, attn_impl=impl)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(lambda p, b: transformer.forward(cfg, p,
                                                           b["tokens"]),
                          params, batch)
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
    row = dict(loss_flash=la, loss_plain=lb, loss_rel_diff=rel, cosine=cos,
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
                                   check_flash(flush, FLASH_SIMT_SHAPE,
                                               "recurrentgemma-9b"),
                                   *check_flash_bwd(flush),
                                   check_paged(False, flush),
                                   check_paged(True, flush),
                                   *check_paper_kernels(flush))}
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

    # phase 6: kill and restart the full-width training from a checkpoint
    recovered = recovery()

    # phase 7: the kernels line (one row per kernel route a main path runs),
    # launches from the paper-workload, serve, serve_moe, serve_families,
    # train and recovery phases
    phases = (paper, *(r["launches"] for r in served.values()), moe,
              families, trained["launches"], recovered)
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
