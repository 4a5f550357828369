"""Dry run: count every (arch x shape x mesh) cell's step on the meta
device.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 256 or 512 virtual TPU devices.  Here each cell builds its step's
arguments as meta tensors (``launch.specs.step_in_shardings``: shapes and
dtypes, no storage), runs the step once under the op cost counter
(``analysis.op_cost``) inside a mesh of local rings at the production shape
((16, 16) "data" x "model", or (2, 16, 16) with "pod"), so that
``models.layers.attention`` routes as it would under that mesh (the ring
over the model axis for long sequences, each hop the flash kernels' meta
route), and records:

  * global ``flops`` and ``hlo_bytes`` (the reference's key names, so
    ``roofline_from_cell`` reads both packages' cells), ``collective_bytes``
    and ``collectives`` by kind, ``model_flops`` and ``model_bytes``;
  * ``memory_analysis``: ``argument_size_gb`` per device, exact from each
    argument's local shard (``parallel.sharding.local_shape`` of params,
    AdamW moments, batch and cache); ``temp_size_gb``, the counter's peak
    of the step's own storages divided by the data-axis size;
    ``peak_gb_per_device``, their sum; ``output_size_gb``, what the step's
    outputs still hold, divided likewise.

Every family's cells count the step on a placed state
(``parallel.sharding.shard_tree`` of params, moments and cache by their
specs; the cache by the family's rule, ``parallel.sharding.store_specs``):
the model axis splits heads, features and vocab and issues every
collective of tensor parallelism, and the data ranks run in turn, so
``collectives_complete`` is true, and the temporaries are one data rank's
divided by the model axis (``temp_sharded_by: "model"``; a serving step
runs all rows at once, divided by data x model).  The placed train step
at (16, 16) costs about 130 s of CPU time a cell, so train cells count it
on a (2, 4) mesh of local rings (``counted_on``); flops and kernel
calls do not depend on the mesh, the collectives' bytes do (a kind
whose family has no placed body is an error cell).  ``state="whole"``
keeps the whole state on every rank: there only the ring's hops are
issued (``collectives_complete: false``, ``note`` says why) and
``temp_sharded_by: "data"``.

Results stream into results/dryrun_torch/<cell>.json so an interrupted
sweep resumes where it stopped.  Nothing here touches a card.

Usage:
    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--mesh single|multi|both] [--force] [--ring MODE]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.op_cost import CostMode
from repro_torch.analysis.roofline import (RooflineReport, collective_bytes,
                                           model_flops_decode,
                                           model_flops_train)
from repro_torch.configs import ARCH_IDS, SHAPES, get_bundle
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.launch.specs import step_in_shardings
from repro_torch.optim import adamw_init
from repro_torch.parallel.mesh import make_mesh, set_mesh
from repro_torch.parallel.sharding import local_nbytes, shard_tree

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


# where a placed train step is counted: (16, 16) costs ~130 s of CPU
PLACED_TRAIN_MESH = ((2, 4), ("data", "model"))
WHOLE_NOTE = ("the state is whole on every rank (state='whole'): only "
              "the context-parallel ring's hops are issued, not the data "
              "axis's gradient sum nor the model axis's tensor-parallel "
              "collectives")


def _placed_args(bundle, kind: str, args, specs, mesh):
    """The step's arguments placed on ``mesh`` by their specs: params,
    the AdamW state (train) or the cache (serving)."""
    args = list(args)
    args[0] = shard_tree(args[0], specs[0], mesh)
    if kind == "train":
        args[1] = adamw_init(args[0])
    else:
        args[2] = shard_tree(args[2], bundle.store_specs(args[2], mesh),
                             mesh)
    return args


def _cell_path(arch, shape, mesh_name, ring=None):
    safe = arch.replace(".", "_")
    # ring-pinned cells cache separately, so mode comparisons never read
    # stale cells counted under a different attention mode
    suffix = f"__ring-{ring}" if ring else ""
    return os.path.join(RESULTS_DIR,
                        f"{safe}__{shape}__{mesh_name}{suffix}.json")


def _argument_bytes(args, specs, mesh) -> int:
    """Per-device bytes of the step's arguments: each leaf's largest
    shard under its spec (a nested dict of tensors and one of specs)."""
    total = 0
    for a, s in zip(args, specs):
        if isinstance(a, dict):
            total += local_nbytes(a, s, mesh)
        else:
            total += local_nbytes({"x": a}, {"x": s}, mesh)
    return total


def run_cell(arch: str, shape: str, mesh_name: str, *, force: bool = False,
             ring: str | None = None, state: str = "placed") -> dict:
    """Count one cell.  ``ring`` pins the context-parallel attention mode
    for this cell ('ring' | 'replicated' | 'off' | 'auto') via the
    REPRO_RING_ATTN policy env read at call time; None keeps the ambient
    policy.  ``state``: 'placed' (the state placed by its specs) or
    'whole'."""
    if state not in ("placed", "whole"):
        raise ValueError(f"state {state!r} not in ('placed', 'whole')")
    path = _cell_path(arch, shape, mesh_name, ring)
    if state == "whole":
        path = path.replace(".json", "__whole.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    from repro_torch.obs import get_telemetry
    tel = get_telemetry()
    bundle = get_bundle(arch)
    # ``cpu_s`` is this thread's CPU time (the meta count and its backward
    # run on the calling thread) with intra-op threads at one: no other
    # thread's spinning, and so no load on the machine, counts in it
    t0, c0 = time.time(), time.thread_time()
    result = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if ring:
        result["ring"] = ring
    ok, why = bundle.supports(shape)
    if not ok:
        result.update(status="skipped", reason=why)
    else:
        prev_ring = os.environ.get("REPRO_RING_ATTN")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            if ring:
                os.environ["REPRO_RING_ATTN"] = ring
            mesh = make_mesh(*PRODUCTION_SHAPES[mesh_name == "multi"])
            chips = math.prod(mesh.shape.values())
            dsize = math.prod(mesh.shape[a] for a in ("pod", "data")
                              if a in mesh.axis_names)
            args, specs, step, donate = step_in_shardings(bundle, shape,
                                                          mesh)
            arg_bytes = _argument_bytes(args, specs, mesh)
            kind = SHAPES[shape]["kind"]
            placed = state == "placed"
            count_mesh = mesh
            if placed:
                bundle.require_placed_body()
                if kind == "train":
                    count_mesh = make_mesh(*PLACED_TRAIN_MESH)
                    args, specs, step, _ = step_in_shardings(
                        bundle, shape, count_mesh)
                args = _placed_args(bundle, kind, args, specs, count_mesh)
            with set_mesh(count_mesh), CostMode() as counter, \
                    tel.span("count", cat="dryrun", arch=arch, shape=shape,
                             mesh=mesh_name):
                out = step(*args)
            out_bytes = counter._live_bytes    # what the outputs still hold
            del out
            cost = counter.cost
            if placed:
                split = count_mesh.shape["model"] * (
                    1 if kind == "train" else math.prod(
                        n for a, n in count_mesh.shape.items()
                        if a != "model"))
            else:
                split = dsize
            temp_bytes = counter.peak_bytes / split
            sh = SHAPES[shape]
            tokens = sh["seq_len"] * sh["global_batch"] if \
                sh["kind"] == "train" else sh["global_batch"]
            if sh["kind"] == "train":
                mflops = model_flops_train(bundle.active_param_count(),
                                           tokens)
            else:
                mflops = model_flops_decode(bundle.active_param_count(),
                                            tokens)
                if sh["kind"] == "prefill":
                    mflops = model_flops_train(
                        bundle.active_param_count(),
                        sh["seq_len"] * sh["global_batch"]) / 3.0  # fwd only
            coll = collective_bytes(cost)
            result.update(
                status="ok",
                chips=chips,
                compile_s=round(time.time() - t0, 1),   # the count's wall
                cpu_s=round(time.thread_time() - c0, 1),
                flops=cost.flops,
                hlo_bytes=cost.bytes,
                collective_bytes=float(sum(coll.values())),
                collectives=coll,
                xla_flops_unscaled=None,      # no XLA: nothing compiled
                model_flops=mflops,
                model_bytes=bundle.min_hbm_bytes(shape),
                kernels=cost.kernels,
                donate=list(donate),
                memory_analysis={
                    "argument_size_gb": arg_bytes / 1e9,
                    "output_size_gb": out_bytes / split / 1e9,
                    "temp_size_gb": temp_bytes / 1e9,
                    # donated params / opt state / cache are updated in
                    # place, so the peak is the arguments plus the temps
                    "peak_gb_per_device": (arg_bytes + temp_bytes) / 1e9,
                },
                collectives_complete=placed,
                temp_sharded_by=("model" if kind == "train" else
                                 "data, model") if placed else "data",
            )
            if placed and count_mesh is not mesh:
                result["counted_on"] = dict(count_mesh.shape)
            if not placed:
                result["note"] = WHOLE_NOTE
            tel.metrics.absorb(
                {"flops": result["flops"], "hlo_bytes": result["hlo_bytes"],
                 "collective_bytes": result["collective_bytes"],
                 "peak_bytes": arg_bytes + temp_bytes},
                prefix="dryrun.", arch=arch, shape=shape, mesh=mesh_name)
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: OK "
                  f"({result['compile_s']}s, "
                  f"{result['memory_analysis']['peak_gb_per_device']:.2f} "
                  f"GB/dev)")
        except Exception as e:  # noqa: BLE001 — recorded, sweep continues
            result.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-2000:])
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
                  f"FAIL {type(e).__name__}: {e}")
        finally:
            torch.set_num_threads(threads)
            if ring:
                if prev_ring is None:
                    os.environ.pop("REPRO_RING_ATTN", None)
                else:
                    os.environ["REPRO_RING_ATTN"] = prev_ring

    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def roofline_from_cell(cell: dict) -> RooflineReport | None:
    if cell.get("status") != "ok":
        return None
    return RooflineReport(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        chips=cell["chips"], hlo_flops=cell["flops"],
        hlo_bytes=cell["hlo_bytes"], coll_bytes=cell["collective_bytes"],
        coll_breakdown=cell["collectives"], model_flops=cell["model_flops"],
        bytes_per_device=cell["memory_analysis"]["peak_gb_per_device"] * 1e9,
        model_bytes=cell.get("model_bytes", 0.0))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--ring", default=None,
                    choices=["auto", "ring", "replicated", "off"],
                    help="pin the context-parallel attention mode for "
                         "every cell (default: ambient REPRO_RING_ATTN "
                         "policy)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace JSON of per-cell count "
                         "spans + kernel dispatch instants")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (per-cell flops/bytes "
                         "gauges) as JSON")
    args = ap.parse_args()

    tel = None
    if args.trace_out or args.metrics_out:
        import repro_torch.obs as obs
        tel = obs.enable(process_name="dryrun")

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                r = run_cell(arch, shape, mesh_name, force=args.force,
                             ring=args.ring)
                s = r["status"]
                n_ok += s == "ok"
                n_skip += s == "skipped"
                n_err += s == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if tel is not None:
        if args.trace_out:
            print(f"[dryrun] trace -> {tel.write_trace(args.trace_out)}")
        if args.metrics_out:
            print(f"[dryrun] metrics -> "
                  f"{tel.write_metrics(args.metrics_out)}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
