"""The readings the limits of a cell's correctness check are set from, on
the card at the cell's own size, several seeds in one process.

    python3 bench/control.py --workload <name> --seeds 11,12,13 \
        [--seconds 20] [--faults]

For each seed it prints one JSON line: the program's numbers against the
plain reference (the lower readings) and the control's, the reference put
in the program's place in the precision below the configuration's (float8
e4m3 products for bfloat16; the upper readings).  A training cell needs no
measured window: the program runs its three checked steps.  ``--faults``
adds a training cell's planted faults (a step that returns its state
unchanged reads 1 by its measure; half the batch left out runs the
program again).  The
benchmark's own runs run none of this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402  (the environment and sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from bench.harness import faults, serve_cell, train_cell
    from bench.harness.checks import train_numbers
    from bench.harness.spec import load_cell
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(bench_run.ROOT, args.workload)
    dev = torch.device("cuda", 0)
    _build.build_all()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed}
        if cell.runner == "train":
            rec = train_cell.run(cell, seed, 0.0, False, dev)
            rows = rec["check_inputs"]["rows"]
            ref = train_cell.reference_readings(cell, seed, dev, rows)
            ctl = train_cell.reference_readings(cell, seed, dev, rows, "fp8")
            line["program"] = train_numbers(rec["check_inputs"]["prog"], ref)
            line["control"] = train_numbers(ctl, ref)
            if args.faults:
                # a state left unchanged reads 1 by the change's measure
                # and needs no run (its copy would not fit beside it)
                bad = train_cell.run(cell, seed, 0.0, False, dev,
                                     break_step=faults.half_batch)
                line["faults"] = {"half_batch": train_numbers(
                    bad["check_inputs"]["prog"], ref)}
                del bad
        else:
            rec = serve_cell.run(cell, seed, args.seconds, False, dev)
            ci = rec["check_inputs"]
            n = int(cell.workload["check"].get("sample", 8))
            sample = serve_cell.sample_requests(ci["requests"], seed, n)
            gaps = serve_cell.reference_gaps(cell, seed, dev, sample,
                                             ("f32", "fp8"))
            line["program"] = serve_cell.gap_numbers(gaps["f32"])
            line["control"] = serve_cell.gap_numbers(gaps["fp8"])
            line["finished"] = len(ci["requests"])
        del rec
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
