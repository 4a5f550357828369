#!/usr/bin/env python3
"""Sweep the paged decode kernel's split length on one H100, from the
repository root:

    python3 scripts/sweep_paged_decode_torch.py [--iters 10]

For the bf16 pool and the int8 pool with scales, times ``pages_per_split``
in {1, 2, 4, 8, 16, 32, 64, the whole table}, the lengths that cut the
table into 3 to 8 splits, and the split
``paged_attention.paged_decode_plan`` picks, at two shapes of qwen3-4b's
widths (4 slots, 32 query and 8 kv heads, head_dim 128, pages of 16):

* ``check``: ``chip_smoke.py``'s ``check_paged`` (128 pages a slot, the
  same random lengths);
* ``serve``: the paged serving run's decode ticks (lengths 256-1024, the
  longest slot past half the engine's page view: 64 pages, and 128 with
  the longest slot at 1056 tokens).

Each point is held against the plain version at the same split first
(``chip_smoke.closeness``, atol 1e-4), then timed by device time
(``chip_smoke.device_ms``: CUDA events after an L2 flush, the wrapper's host
work covered), ``--iters`` launches a point.  One JSON line per shape and
pool, then the card's name and power limit.  These are the readings behind
``paged_decode_plan``'s rule (PERF.md §6).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SPLITS = (1, 2, 4, 8, 16, 32, 64)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(cs) -> list[tuple[str, int, np.ndarray]]:
    """(name, pages a slot, lengths) of each swept shape."""
    sh = cs.PAGED_SHAPE
    B, page, MP = sh["B"], sh["page"], sh["max_pages"]
    check = np.random.default_rng(cs.SEED + 1).integers(
        1, MP * page + 1, B).astype(np.int32)
    # the engine's view is the power of two of pages that covers its
    # longest slot: 64 pages for slots of 513-1024 tokens, 128 once one
    # slot passes 1024 (the workload's longest: a 1024-token prompt and 32
    # new tokens)
    serve = np.random.default_rng(cs.SEED + 5).integers(
        256, 1025, B).astype(np.int32)
    serve[np.argmax(serve)] = max(serve.max(), 64 * page // 2 + 1)
    longest = serve.copy()
    longest[np.argmax(longest)] = 1056
    return [("check", MP, check), ("serve", 64, serve),
            ("serve", 128, longest)]


def sweep(cs, name: str, mp: int, lens_np: np.ndarray, quant: bool, flush,
          iters: int) -> None:
    from repro_torch.kernels import paged_attention as kpa
    sh = cs.PAGED_SHAPE
    args = cs.paged_inputs(quant, lens_np, mp, cs.SEED + 2)
    plan, _ = kpa.paged_decode_plan(sh["B"], sh["Hkv"], mp, sh["page"])
    points = []
    # power-of-two split lengths, the whole table, the plan's choice, and
    # the split lengths of 3 to 8 splits (where the grid crosses a wave)
    for pps in sorted({*(s for s in SPLITS if s < mp), mp, plan,
                       *(-(-mp // n) for n in range(3, 9))}):
        f = lambda: kpa.paged_flash_decode_cuda(  # noqa: E731
            *args, pages_per_split=pps)
        close = cs.closeness(f(), kpa.paged_flash_decode_plain(
            *args, pages_per_split=pps), atol=1e-4)
        cs.require(close["within_tol"], f"{name} pps {pps}: {close}")
        points.append(dict(pages_per_split=pps, splits=-(-mp // pps),
                           device_ms=cs.device_ms(f, iters, flush)))
    best = min(points, key=lambda p: p["device_ms"])
    b_ms, _ = cs.paged_bound(args, lens_np)
    print(json.dumps(dict(
        sweep="paged_decode_int8" if quant else "paged_decode_bf16",
        shape=name, max_pages=mp, lengths=lens_np.tolist(), plan=plan,
        plan_device_ms=next(p["device_ms"] for p in points
                            if p["pages_per_split"] == plan),
        best=best, bound_ms=b_ms, points=points)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_paged_decode_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from repro_torch.kernels import _build
    _build.build_all(("paged_decode",))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for name, mp, lens_np in shapes(cs):
            for quant in (False, True):
                sweep(cs, name, mp, lens_np, quant, flush, args.iters)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
