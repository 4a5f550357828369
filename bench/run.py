"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cell's cards.  It
makes its inputs and weights from ``--seed``, builds or loads the
program's kernels (``build/kernels/`` in the checkout), warms up, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: the
end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``.  The numbers compared are printed beside their limits, last
on standard error and under ``checks`` in the line.  Without enough cards
it exits 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# every cache of the program inside the checkout, at fixed paths; JAX kept
# out of any library that would load it by itself
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness.cell import forbidden_modules, run_cell
    from bench.harness.spec import BENCH, load_cell

    cell = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA card: nothing measured", file=sys.stderr)
        return 3
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    def build():
        from repro_torch.kernels import _build
        _build.build_all()

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_start=T_START, bench_dir=BENCH, build=build)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules loaded that a measured run may not load: "
              f"{bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
