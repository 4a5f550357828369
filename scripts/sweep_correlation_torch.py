#!/usr/bin/env python3
"""Sweep the correlation wgmma kernel's plan on one H100, from the
repository root:

    python3 scripts/sweep_correlation_torch.py [--iters 10]

At both catalog correlations (FLOWNET_CORR, EVA2_MATCH; ``chip_smoke.py``'s
shapes and inputs), every (rows a CTA, dy group, band width N) that fits
the shared-memory budget, at the plan's ring depth and at the shortest
ring (3 stages: small enough for two one-row CTAs an SM), and the ring
depths at the plan's (rows, dy group, N); each point held against the plain version
(``chip_smoke.PAPER_ATOL``).  Beside them, as yardsticks only (off every
path): the CUDA-core route (``correlation_simt``) and the same row-pair
products as one batched ``torch.matmul`` of the (H, 1, W, C) I1 rows by
the (H, D, C, W + 2R) I2 row windows, which gives the GEMM's share of the
kernel's time apart from the band epilogue's.  The plan's tiling is also
timed on the first H / 2, H / 4 and H / 8 rows (as many times fewer CTAs,
each with the same work), which tells a CTA's own chain from contention
between CTAs.  Then ``ptxas``'s registers and spills of each kernel in
``csrc/correlation.cu``.

Times are device time (``chip_smoke.device_ms``: CUDA events after an L2
flush, the wrapper's host work covered).  One JSON line per shape, one for
ptxas, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SHAPES = ("FLOWNET_CORR", "EVA2_MATCH")
GROUPS = (1, 2, 3, 4, 5, 6, 7, 9, 11, 17, 21)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep(cs, name: str, flush, iters: int) -> None:
    from repro_torch.core.cuda_bridge import (correlation_block_n,
                                              correlation_plan)
    from repro_torch.kernels import correlation as kcorr
    case = {c["name"]: c for c in cs.catalog_cases()}[name]
    sh = case["shapes"]
    H, W, C, R = sh["H"], sh["W"], sh["C"], sh["radius"]
    D = 2 * R + 1
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    i1, i2 = ((torch.randn((H, W, C), generator=g, device="cuda") *
               C ** -0.25).bfloat16() for _ in range(2))
    want = kcorr.correlation_plain(i1, i2, radius=R)
    plan = correlation_plan(H, W, C, R)

    def timed(p) -> dict:
        f = lambda: kcorr.correlation_cuda(i1, i2, radius=R,  # noqa: E731
                                           plan=p)
        close = cs.closeness(f(), want, atol=cs.PAPER_ATOL["correlation"])
        cs.require(close["within_tol"], f"{name} {p}: {close}")
        return dict(device_ms=cs.device_ms(f, iters, flush), **p._asdict())

    n0 = correlation_block_n(R)
    points = []
    for rows in (1, 2):
        for grp in sorted({x for x in GROUPS if x <= D} | {D}):
            for n in sorted({n0, -(-n0 // 16) * 16, 128}):
                # the plan's ring, and the shortest (small enough for two
                # CTAs of one row on an SM)
                for st in (None, 3):
                    try:
                        p = correlation_plan(H, W, C, R, rows=rows,
                                             dy_group=grp, block_n=n,
                                             stages=st)
                    except ValueError:      # does not fit the budget
                        continue
                    points.append(timed(p))
    points.sort(key=lambda r: r["device_ms"])
    ring = [timed(correlation_plan(H, W, C, R, rows=plan.rows,
                                   dy_group=plan.dy_group,
                                   block_n=plan.block_n, stages=s))
            for s in (3, 4, 5, 6, 7, 8)]
    by = min(8, H)
    simt = lambda: kcorr.correlation_simt_cuda(i1, i2,  # noqa: E731
                                               radius=R, block_y=by)
    # the yardstick: every (y, dy) row pair's full (W, W + 2R) product
    i2p = F.pad(i2, (0, 0, R, R, R, R))              # (H + 2R, W + 2R, C)
    rows2 = i2p.unfold(0, D, 1).permute(0, 3, 2, 1).contiguous()
    rows1 = i1[:, None]                              # (H, 1, W, C)
    gemm = lambda: torch.matmul(rows1, rows2)  # noqa: E731
    band = torch.arange(W, device="cuda")[:, None] + \
        torch.arange(D, device="cuda")[None, :]
    got = gemm().float().gather(
        3, band.expand(H, D, W, D)).permute(0, 2, 1, 3)
    cs.require(cs.closeness(got, want, atol=1e-3)["within_tol"],
               f"{name}: the yardstick's band is not the correlation")
    # the plan's tiling on fewer output rows (fewer CTAs, each the same
    # work): a time that stays put is each CTA's own chain, one that falls
    # is the CTAs contending for L2
    scaling = []
    for h in (H, H // 2, H // 4, H // 8):
        a, b = i1[:h].contiguous(), i2[:h].contiguous()
        p = correlation_plan(h, W, C, R, rows=plan.rows,
                             dy_group=plan.dy_group, block_n=plan.block_n,
                             stages=plan.stages)
        scaling.append(dict(H=h, ctas=p.ctas, device_ms=cs.device_ms(
            lambda: kcorr.correlation_cuda(a, b, radius=R, plan=p), iters,
            flush)))
    print(json.dumps(dict(
        sweep="correlation", workload=name, shapes=sh, scaling=scaling,
        plan=plan._asdict(), plan_device_ms=timed(plan)["device_ms"],
        best=points[:10], worst=points[-3:], points=len(points), ring=ring,
        simt_device_ms=cs.device_ms(simt, iters, flush),
        batched_matmul_device_ms=cs.device_ms(gemm, iters, flush),
        batched_matmul_flop=2 * H * D * W * (W + 2 * R) * C)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_correlation_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all(("correlation",))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for name in SHAPES:
            sweep(cs, name, flush, args.iters)
    print(json.dumps(dict(ptxas=_build.ptxas_report(
        _build.build_log("correlation")))), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
