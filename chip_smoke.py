#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port, run from the repository root
on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/kernels/`` (and prints ``ptxas``'s registers, spills and
shared memory of each), holds each kernel route on a main path against its
plain PyTorch version at the serving, training and paper-workload paths'
full-width shapes (the flash forward's and backward's wgmma routes; the
matmul's wgmma route at GEMM_1K and its split-K GEMV at GEMM_FC), runs
the paper's workload catalog (24 convolution, correlation and GEMM layers
at their own shapes, bf16, batch 1) and qwen3-4b's dense decode shape
through ``repro_torch.kernels.ops``, times both of the matmul's bf16 routes at
GEMM_FC's N and K for M below 64, serves qwen3-4b at full width (bf16,
random weights from a seed) through ``repro_torch.launch.serve`` in the
dense, paged and paged_int8 KV modes, holds the flash kernels' loss and
gradients against the plain attention path, trains qwen3-4b at full width
for a few AdamW steps through ``repro_torch.launch.train``, and checks what
comes out.  Each phase prints JSON lines (``paper_workloads`` one per
workload); a failed phase exits non-zero before the result line.  Each
kernel time is given twice: ``ms``, the span a caller waits for (the
wrapper's host work included where it outlasts the flush before it), and
``device_ms``, the device work alone.  The last two lines are the card's
name and power limit (``nvidia-smi``) and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import math
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

def check_flash(flush) -> dict:
    """The forward kernel at the train phase's shape (B 2, S 2048, 32/8
    heads), (B, S, H, D) tensors read through transposed views."""
    from repro_torch.kernels import attention as katt
    B, S, H, Hkv, D = 2, 2048, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    route = katt.flash_fwd_route(qt, kt, vt)
    require(route == "flash_fwd", f"flash_fwd: the bf16 train shape takes "
            f"route {route}, not the wgmma kernel")
    bq, bk = katt.flash_fwd_blocks(route)
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=True)
        o_ref, lse_ref = katt.flash_attention_fwd_plain(
            qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
            vt.reshape(B * Hkv, S, D), causal=True, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        # atol 2e-3 covers p's bf16 rounding before PV flipping where the
        # two score sums differ in their last f32 bits
        close = closeness(o.reshape(B * H, S, D), o_ref, atol=2e-3)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = 1e-4
        require(bool(torch.isfinite(o).all()), "flash_fwd: non-finite out")
        require(close["within_tol"] and lse_err <= lse_tol,
                f"flash_fwd disagrees: {close}, max|lse| err {lse_err} "
                f"(tol {lse_tol})")
        fwd = lambda: katt.flash_attention_fwd_cuda(  # noqa: E731
            qt, kt, vt, causal=True)
        ms, ms_spread = time_ms(fwd, 20, flush)
        dev_ms = device_ms(fwd, 20, flush)
        plain_ms, _ = time_ms(lambda: katt.flash_attention_fwd_plain(
            qt.reshape(B * H, S, D), kt.reshape(B * Hkv, S, D),
            vt.reshape(B * Hkv, S, D), causal=True, block_q=bq, block_k=bk),
            3, flush)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ms, _ = time_ms(sdpa, 20, flush)
        lib_dev_ms = device_ms(sdpa, 20, flush)
    pairs = B * H * S * (S + 1) // 2               # unmasked (q, k) pairs
    bytes_ = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) + \
        4 * lse.numel()
    b_ms, b_by = bound(bytes_, 4 * D * pairs, PEAK_BF16)
    row = dict(name="flash_fwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_fwd.cu",
               replaces="src/repro/kernels/attention.py:153",
               **close, lse_max_abs_err=lse_err, lse_tol=lse_tol,
               ms=ms, ms_spread=ms_spread, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, library_device_ms=lib_dev_ms,
               blocks=[bq, bk],
               shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, causal=True))
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


def check_paged(quant: bool, flush) -> dict:
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.layers import quantize_kv
    B, H, Hkv, D, page, max_len = 4, 32, 8, 128, 16, 2048
    MP = max_len // page
    P = B * MP + 1
    rng = np.random.default_rng(SEED + 1)
    lens_np = rng.integers(1, max_len + 1, B).astype(np.int32)
    perm = rng.permutation(np.arange(1, P)).reshape(B, MP)
    table_np = np.zeros((B, MP), np.int32)
    for b in range(B):
        n = -(-int(lens_np[b]) // page)
        table_np[b, :n] = perm[b, :n]
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(torch.bfloat16)
    kf = torch.randn((P, page, Hkv, D), generator=g, device="cuda")
    vf = torch.randn((P, page, Hkv, D), generator=g, device="cuda")
    if quant:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    del kf, vf
    table = torch.from_numpy(table_np).to("cuda")
    lens = torch.from_numpy(lens_np).to("cuda")
    args = (q, k, v, table, lens, ks, vs)
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
    n_tok = int(lens_np.sum())
    kv_item = 1 if quant else 2
    bytes_ = (2 * n_tok * Hkv * D * kv_item + (2 * n_tok * Hkv * 4 if quant
                                               else 0)
              + 2 * 2 * q.numel() + 4 * (table.numel() + lens.numel()))
    b_ms, b_by = bound(bytes_, 4 * D * H * n_tok,
                       PEAK_INT8 if quant else PEAK_BF16)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/paged_decode.cu",
               replaces="src/repro/kernels/paged_attention.py:42",
               **close, ms=ms, ms_spread=ms_spread, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, library_device_ms=None,
               shape=dict(B=B, H=H, Hkv=Hkv, D=D, page=page, max_pages=MP,
                          lengths=lens_np.tolist()))
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
    from repro_torch.core.cuda_bridge import gemv_plan, matmul_block_shapes
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
        boh, bco = min(8, OH), min(128, CO)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out_numel, in_numel = OH * OW * CO, x.numel() + w.numel()
        calls = dict(
            tile=dict(block_oh=boh, block_co=bco),
            main=lambda: ops.conv2d(x, w, stride=s, dilation=dil),
            launch=lambda: kconv.conv2d_cuda(x, w, stride=s, dilation=dil,
                                             block_oh=boh, block_co=bco),
            plain=lambda: kconv.conv2d_plain(x, w, stride=s, dilation=dil),
            library=lambda: F.conv2d(x.permute(0, 3, 1, 2), w_cl, stride=s,
                                     dilation=dil))
    elif kind == "correlation":
        H, W, C, R = sh["H"], sh["W"], sh["C"], sh["radius"]
        i1, i2 = t((H, W, C), C ** -0.25), t((H, W, C), C ** -0.25)
        by = min(8, H)
        D = 2 * R + 1
        out_numel, in_numel = H * W * D * D, 2 * H * W * C
        calls = dict(
            tile=dict(block_y=by, strip=32, channels=32),
            main=lambda: ops.correlation(i1, i2, radius=R),
            launch=lambda: kcorr.correlation_cuda(i1, i2, radius=R,
                                                  block_y=by),
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
        calls = dict(
            tile=dict(step=32, plain_block_k=katt.decode_block_k(S, 512)),
            main=lambda: ops.flash_decode(q, kc, vc, lens),
            launch=lambda: katt.flash_decode_cuda(q, kc, vc, lens),
            plain=lambda: katt.flash_decode_plain(q, kc, vc, lens),
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
    GEMM_FC, conv2d at DL_ATROUS4, correlation at FLOWNET_CORR, flash
    decode at qwen3-4b's decode shape.  Each row is named by its launch
    key."""
    by = {c["name"]: c for c in catalog_cases()}
    rows = []
    for i, case in enumerate((by["GEMM_1K"], by["GEMM_FC"], by["DL_ATROUS4"],
                              by["FLOWNET_CORR"], decode_case())):
        r = run_case(case, flush, SEED + 20 + i)
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
# routes (GEMM_1K, GEMM_FC), conv2d, correlation, dense decode
PAPER_KEYS = ("matmul", "matmul_gemv", "conv2d", "correlation",
              "flash_decode")


def paper_workloads(flush) -> dict:
    """Phase 3b: the 24 catalog workloads and qwen3-4b's decode shape
    through ``ops`` on the card, one line each (with the route and tile of
    each matmul); every kernel route of the path must have launched."""
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


def prompts(n: int, lo: int, hi: int, seed: int, share: float = 0.0,
            vocab: int = 151936) -> list[np.ndarray]:
    """``n`` random prompts of lengths in [lo, hi]; a ``share`` fraction of
    them start with one common prefix of lo // 2 tokens."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, lo // 2)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        if share > 0 and i % max(1, round(1 / share)) == 0:
            p[:len(common)] = common
        out.append(p.astype(np.int32))
    return out


def workload(mode: str) -> tuple[list[np.ndarray], dict]:
    """The serve phase's requests and engine settings for one KV mode:
    dense takes 4 long prompts (the flash kernel's prefill path), the
    paged modes 8 shorter ones over 4 slots, half sharing a prefix."""
    if mode == "dense":
        return prompts(4, 1024, 1900, SEED + 3), dict(max_new=16, slots=4)
    return (prompts(8, 256, 1024, SEED + 4, share=0.5),
            dict(max_new=32, slots=4, page_size=16, prefill_chunk=256,
                 prefill_token_budget=1024))


def serve(mode: str, params) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    reqs, kw = workload(mode)
    max_new = kw["max_new"]
    engine, _ = build_engine(ARCH, smoke=False, max_len=2048, kv_mode=mode,
                             params=params, device="cuda", **kw)
    watch = FiniteWatch(engine.bundle)
    engine.bundle = watch
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
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
    row = dict(mode=mode, requests=len(reqs), slots=engine.cfg.batch,
               prompt_tokens=int(sum(len(p) for p in reqs)),
               generated_tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               steps=watch.steps, launches=launches,
               kv=engine.kv_stats(), prefix=engine.prefix_stats())
    emit("serve", **row)
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


def logits_check(params) -> dict:
    """Full-width prefill logits of one 1536-token prompt through the flash
    kernel against the plain attention path (the reference's XLA path):
    bf16 at full width is not bit-stable across attention paths, so this
    asserts a cosine similarity, not equality."""
    import dataclasses

    from repro_torch.configs import get_bundle
    bundle = get_bundle(ARCH)
    tok = torch.from_numpy(prompts(1, 1536, 1536, SEED + 9)[0][None]) \
        .long().to("cuda")
    out = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            cfg = dataclasses.replace(bundle.cfg, attn_impl=impl)
            cache = bundle.family.init_cache(cfg, 1, 1536, device="cuda")
            logits, _ = bundle.family.prefill(cfg, params, tok, cache)
            out[impl] = logits.float().flatten()
            del cache
    a, b = out["pallas"], out["xla"]
    cos = F.cosine_similarity(a, b, dim=0).item()
    row = dict(cosine=cos, max_abs_diff=(a - b).abs().max().item(),
               top1_equal=bool(a.argmax() == b.argmax()),
               finite=bool(torch.isfinite(a).all()))
    emit("logits_check", **row)
    require(row["finite"] and cos > 0.99,
            f"flash vs plain prefill logits: cosine {cos}")
    return row


# ---------------------------------------------------------------------------
# phase 5: train qwen3-4b at full width
# ---------------------------------------------------------------------------

def token_batch(B: int, S: int, seed: int) -> dict:
    t = torch.from_numpy(np.stack(prompts(B, S + 1, S + 1, seed))).long() \
        .to("cuda")
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
    batch = token_batch(1, 2048, SEED + 11)
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
                                   *check_flash_bwd(flush),
                                   check_paged(False, flush),
                                   check_paged(True, flush),
                                   *check_paper_kernels(flush))}

    # phase 3b: the paper's workloads at their own shapes; 3c: M < 64
    paper = paper_workloads(flush)
    skinny_matmuls(flush)
    del flush
    torch.cuda.empty_cache()

    # phase 4: serve qwen3-4b at full width in the three KV modes
    from repro_torch.configs import get_bundle
    t0 = time.perf_counter()
    params = get_bundle(ARCH).init_params(SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init_params", seconds=time.perf_counter() - t0,
         params=get_bundle(ARCH).param_count(),
         bytes=sum(t.numel() * t.element_size() for t in
                   [params["embed"], params["ln_f"], params["lm_head"],
                    *params["layers"].values()]))
    with torch.no_grad():
        dense, paged, int8 = (serve(m, params)
                              for m in ("dense", "paged", "paged_int8"))
    require(dense["launches"]["flash_fwd"] > 0,
            "dense mode never launched the wgmma flash_fwd")
    require(paged["launches"]["paged_decode_bf16"] > 0,
            "paged mode never launched paged_decode_bf16")
    require(int8["launches"]["paged_decode_int8"] > 0,
            "paged_int8 mode never launched paged_decode_int8")
    emit("agreement", paged_vs_paged_int8=agreement(paged["results"],
                                                    int8["results"]))
    logits_check(params)

    # phase 5: train at full width (the served weights change in place)
    torch.cuda.empty_cache()
    train_check(params)
    torch.cuda.empty_cache()
    trained = train(params)
    del params
    torch.cuda.empty_cache()

    # phase 6: the kernels line (one row per kernel route a main path runs),
    # launches from the paper-workload, serve and train phases
    phases = (paper, dense["launches"], paged["launches"], int8["launches"],
              trained["launches"])
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

    # phase 7: the card, then the result line
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
