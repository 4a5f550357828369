"""A training cell: the port's train step (``training.step.make_train_step``
with the model's default per-layer recompute, as ``launch.train`` builds
it) driven over packed rows for a fixed window.

Set-up makes the weights and the AdamW state on the device from the seed,
builds the one step object, and drives it through its first three steps
on the window's own feed (rows 0, 1, 2): they warm every shape, and their
losses, the first step's gradient as the optimizer took it (its first
moment over 1 - b1) and each leaf's change after the three are what the
reference checks.  The window then runs the same object on the following
rows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import work
from .checks import train_numbers
from .spec import Cell, model_sizes, port_bundle
from .stats import rate
from .traffic import train_rows
from .util import log
from .weights import leaf_of, leaf_shapes, make_leaf, make_weights

CHECK_STEPS = 3


def _hyper(opt: dict):
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainHyper
    return TrainHyper(optimizer=AdamWConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
        warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
        min_lr_frac=opt["min_lr_frac"]), microbatches=1,
        aux_weight=opt["aux_weight"], z_weight=opt["z_weight"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        *, break_step=None) -> dict:
    """One run.  ``break_step(step_fn) -> step_fn`` plants a fault in the
    timed path (the tests' negative controls).  -> the runner's record
    (see :func:`harness.cell.run_cell`)."""
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step

    cfg, mix, opt = cell.config, cell.traffic, cell.workload["optimizer"]
    s = model_sizes(cfg)
    B, S = int(mix["batch"]), int(mix["seq_len"])
    bundle = port_bundle(cfg)
    params = make_weights(cfg, seed, device)
    state = adamw_init(params)
    log("weights and optimizer state made")
    step_fn = make_train_step(bundle.forward, _hyper(opt))
    if break_step is not None:
        step_fn = break_step(step_fn)
    n_rows = int(mix["rows"])
    data = train_rows(mix, s["vocab"], seed, B * n_rows)
    tokens = data["tokens"].reshape(n_rows, B, S)
    labels = data["labels"].reshape(n_rows, B, S)

    def feed(i: int) -> dict:
        j = i % n_rows if i < n_rows else CHECK_STEPS + (i - CHECK_STEPS) % (
            n_rows - CHECK_STEPS)
        return {"tokens": torch.from_numpy(tokens[j]).to(device),
                "labels": torch.from_numpy(labels[j]).to(device)}

    def one(i: int) -> dict:
        nonlocal params, state
        params, state, m = step_fn(params, state, feed(i))
        return m

    def finite(m: dict) -> bool:
        return bool(float(m["finite"]) > 0)

    # the first steps: warm-up, and the readings the reference checks
    names = list(leaf_shapes(cfg))
    prog = {"losses": []}
    for i in range(CHECK_STEPS):
        m = one(i)
        prog["losses"].append(float(m["loss"]) if finite(m)
                              else float("nan"))
        if i == 0:
            prog["grad_norms"] = {
                k: float(leaf_of(state["mu"], k).norm()) / (1 - opt["b1"])
                for k in names}
    log(f"first {CHECK_STEPS} steps: losses {prog['losses']}")
    prog["change_norms"] = {}
    for k in names:
        p0 = make_leaf(cfg, k, seed, device)
        prog["change_norms"][k] = float(
            (leaf_of(params, k).float() - p0.float()).norm())
        del p0
    _sync(device)

    # the window: the step's own host read of its finite flag is the only
    # sync inside it; the metrics are read once the window has closed
    metrics, steps = [], 0
    t0 = time.perf_counter()
    while True:
        metrics.append(one(CHECK_STEPS + steps))
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    finite_steps = sum(finite(m) for m in metrics)
    del metrics
    tokens_done = steps * B * S
    rec = {
        "window_start": t0,
        "window_s": window_s,
        "attempted": steps,
        "failed": steps - finite_steps,
        "end_to_end": {"train_tok_s": rate(tokens_done, window_s)},
        "window": {"steps": steps, "tokens": tokens_done,
                   "model_flops": steps * work.train_step_flops(s, B, S),
                   "batch": B, "seq": S},
    }
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace:
        from .trace import profile_slice
        n = int(cell.workload.get("trace_steps", 2))

        def body(annotate):
            for j in range(n):
                with annotate("step"):
                    one(CHECK_STEPS + steps + j)
            _sync(device)
        sl = profile_slice(body)
        sl.counts = {"steps": n, "batch": B, "seq": S}
        rec["slice"] = sl

    # the program's state goes before the reference runs
    del params, state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["check_inputs"] = {
        "prog": prog,
        "rows": [{"tokens": tokens[i], "labels": labels[i]}
                 for i in range(CHECK_STEPS)]}
    return rec


def reference_readings(cell: Cell, seed: int, device, rows: list,
                       prec: str = "f32") -> dict:
    """The reference's losses, first clipped gradient norms and changes
    after ``len(rows)`` steps, from the weights made again from the
    seed."""
    from ..reference import transformer as ref
    cfg, opt = cell.config, cell.workload["optimizer"]
    s = model_sizes(cfg)
    ref.exact_f32()
    params = make_weights(cfg, seed, device)
    dev_rows = [{k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in r.items()} for r in rows]
    out = ref.train(params, dev_rows, s, opt, opt["z_weight"], prec)
    out["change_norms"] = {}
    for k in leaf_shapes(cfg):
        p0 = make_leaf(cfg, k, seed, device)
        out["change_norms"][k] = float(
            (leaf_of(params, k).float() - p0.float()).norm())
        del p0
    del params
    return out


def check(cell: Cell, seed: int, device, rec: dict) -> dict:
    """-> {name: (value, where)} of the program against the reference."""
    ci = rec["check_inputs"]
    ref = reference_readings(cell, seed, device, ci["rows"])
    return train_numbers(ci["prog"], ref)
