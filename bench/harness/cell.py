"""One run of one cell, from set-up to the result line.

:func:`run_cell` takes the device it is given: ``bench/run.py`` looks for
the card first and hands it the card; the tests hand it the CPU and a
cell cut to a tiny size.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any

from . import serve_cell, train_cell
from .checks import verdict
from .spec import Cell, load_metric, model_sizes
from .util import log

RUNNERS = {"train": train_cell, "serve": serve_cell}

# top-level module names that may not be loaded in a measured process: JAX
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Of the module ``names`` (those loaded in this process), the
    top-level names (before the first dot) that are one of
    :data:`FORBIDDEN`, compared whole."""
    tops = {m.split(".", 1)[0] for m in (names if names is not None
                                         else list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads: the cell, its sizes, the
    window's counts and, in a traced run, the profiled slice."""
    cell: Cell
    sizes: dict
    window: dict
    window_s: float
    slice: Any = None


def per_layer(rec: Record, metrics: list, bench_dir) -> dict:
    """Each metric's reading, left out where its reader finds nothing."""
    out = {}
    for m in metrics:
        reader = load_metric(m["name"], bench_dir)
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device, peak: int | None) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak or 0)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             *, t_start: float, bench_dir, build=None, fault=None) -> dict:
    """Set up, measure, check.  ``t_start``: the process's start on
    ``time.perf_counter``'s clock (set-up runs from it to the window's
    start).  ``build()``: builds or loads the program's kernels.
    ``fault``: keyword arguments for the runner that plant a fault in the
    timed path.  -> the result line as a dict (``checks`` last)."""
    runner = RUNNERS[cell.runner]
    if build is not None:
        build()
    log(f"set-up: {cell.name}, seed {seed}")
    rec = runner.run(cell, seed, seconds, trace, device, **(fault or {}))
    setup_s = rec["window_start"] - t_start
    log(f"window: {rec['window_s']:.3f} s after {setup_s:.3f} s of set-up, "
        f"{rec['attempted']} attempted")
    t_check = time.perf_counter()
    numbers = runner.check(cell, seed, device, rec)
    ok, checks = verdict(numbers, cell.workload["check"]["limits"])
    check_s = time.perf_counter() - t_check
    log(f"check: {check_s:.3f} s")
    ok = ok and rec["failed"] == 0 and rec["attempted"] > 0

    if trace:
        record = Record(cell, model_sizes(cell.config), rec["window"],
                        rec["window_s"], rec.get("slice"))
        metrics = per_layer(record, cell.per_layer, bench_dir)
    else:
        metrics = {}
        e2e = dict(rec["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_info(device, rec.get("memory_peak_bytes"))
    out = {"correct": bool(ok), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics, "device": dev,
           "window": {"seconds": rec["window_s"], "setup_s": setup_s,
                      "check_s": check_s, **rec["window"],
                      "check_where": {k: w for k, (_, w) in numbers.items()}}}
    sl = rec.get("slice")
    if trace and sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
        out["breakdown"] = {"device_ops": sl.top_ops(),
                            "idle_gaps": sl.idle_gaps()}
    out["checks"] = checks
    return out
