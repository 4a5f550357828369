"""Training launcher of the port: a single-process train loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 5 --device cpu

Counterpart of ``repro.launch.train`` on one device: the step-indexed
synthetic data stream with its prefetch thread, ``make_train_step``
(forward under per-layer recompute, CE + aux + z-loss, backward through the
flash kernels, AdamW with the nonfinite skip) and ``GradGuard`` with the
reference's actions.  There is no checkpoint manager yet, so a rollback
keeps the current (guarded) state, logs ``rollback_unavailable`` and runs
the step again, as the reference's ``restore_or_keep`` does with no
manager.  The LR schedule spans the same horizon as the reference's
(``warmup_steps=5``, ``total_steps=max(steps, 10)``).  Checkpoints, chaos,
heartbeats and the fleet are not ported yet.

The run takes the CUDA card unless given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.obs as obs
from repro_torch.configs import get_bundle
from repro_torch.data import DataConfig, make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import GradGuard, TrainHyper, make_train_step

SEED = 0              # the reference's PRNGKey(0)
MAX_RECOVERIES = 8    # rollbacks before the run gives up, as the reference


def run(arch: str, *, smoke: bool = True, steps: int = 20,
        seq_len: int = 128, global_batch: int = 8, microbatches: int = 1,
        lr: float = 3e-4, log_every: int = 1, device=None,
        params=None, on_step=None) -> dict:
    """Train ``steps`` steps from random weights drawn from seed 0 (or
    from ``params``, which are updated in place).  ``on_step(i, params,
    opt, metrics)``, if given, is called after each step the guard does
    not roll back (e.g. to look at the weights after the first one).
    Returns the per-step
    ``losses``, ``steps`` (indices), ``seconds`` (host wall, after a device
    synchronise) and ``metrics``, the guard's ``events``, and the final
    ``params`` and ``opt`` state."""
    dev = resolve_device(device)
    bundle = get_bundle(arch, smoke=smoke)
    if params is None:
        params = bundle.init_params(SEED, device=dev)
    opt = adamw_init(params)
    data_cfg = DataConfig(vocab=bundle.cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch)
    end_step = steps
    hyper = TrainHyper(optimizer=AdamWConfig(
        lr=lr, warmup_steps=5, total_steps=max(end_step, 10)),
        microbatches=microbatches)
    step_fn = make_train_step(bundle.forward, hyper)
    guard = GradGuard()
    tel = obs.get_telemetry()

    history, step_log, seconds, metrics_log, events = [], [], [], [], []
    it = make_train_iterator(data_cfg)
    i = 0
    recoveries = 0
    try:
        while i < end_step:
            t0 = time.perf_counter()
            idx, batch = it.next()
            assert idx == i, (idx, i)
            batch = {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in batch.items()}
            params, opt, m = step_fn(params, opt, batch)
            m = {k: float(v) for k, v in m.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            loss, finite = m["loss"], m["finite"] > 0.0
            action = guard.update(loss, finite)
            if tel.enabled:
                tel.metrics.observe("train_step_s", dt)
            history.append(loss)
            step_log.append(i)
            seconds.append(dt)
            metrics_log.append(m)
            if i % log_every == 0:
                flag = "" if finite else "  [nonfinite->skipped]"
                print(f"[train] step {i} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms){flag}")
            if action == "rollback":
                recoveries += 1
                if recoveries > MAX_RECOVERIES:
                    raise RuntimeError("recovery limit exceeded")
                print(f"[guard] step {i}: rollback "
                      f"(trigger={guard.last_trigger}); no checkpoint to "
                      "restore, keeping the guarded state")
                events.append({"kind": "rollback_unavailable", "step": i,
                               "reason": "divergence"})
                it.close()
                it = make_train_iterator(data_cfg, start_step=i)
                guard.reset()
                continue
            if action == "skip":
                print(f"[guard] step {i}: skip "
                      f"(trigger={guard.last_trigger}, consecutive="
                      f"{guard.consecutive_skips})")
                events.append({"kind": "skip", "step": i})
            if on_step is not None:
                on_step(i, params, opt, m)
            i += 1
    finally:
        it.close()
    return {"losses": history, "steps": step_log, "seconds": seconds,
            "metrics": metrics_log, "events": events, "params": params,
            "opt": opt}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args()
    out = run(a.arch, smoke=a.smoke, steps=a.steps, seq_len=a.seq_len,
              global_batch=a.global_batch, microbatches=a.microbatches,
              lr=a.lr, log_every=a.log_every, device=a.device)
    losses = out["losses"]
    print(f"[train] done: first loss {losses[0]:.4f}, last loss "
          f"{losses[-1]:.4f}, {len(out['events'])} guard events")


if __name__ == "__main__":
    main()
