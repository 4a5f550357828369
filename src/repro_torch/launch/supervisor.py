"""Fleet launcher: spawn and supervise N real training worker processes.

    # 4 workers, chaos-kill rank 1 entering step 50, self-heal
    PYTHONPATH=src python -m repro_torch.launch.supervisor --nprocs 4 \
        --arch qwen3-4b --steps 100 --ckpt-dir /tmp/fleet-ckpt \
        --chaos kill@50
    # the same drill on the CPU, at the smoke width
    PYTHONPATH=src python -m repro_torch.launch.supervisor --nprocs 2 \
        --steps 8 --seq-len 32 --global-batch 4 --ckpt-every 4 \
        --ckpt-dir /tmp/fleet-ckpt --chaos kill@5 --device cpu

Counterpart of ``repro.launch.supervisor``.  Each worker is
``repro_torch.launch.train --process-id R --num-processes W`` running the
SAME global horizon (``--total-steps``), so every rank holds
bit-identical params (proven by the per-rank ``params_crc`` result
files).  The supervisor restarts chaos-killed or crashed workers with
backoff, evicts repeat offenders and re-meshes the gang over the
survivors, and gives up cleanly — newest committed checkpoint reported —
when the global failure budget is blown.  See
``repro_torch.runtime.supervisor`` for the policy machine.  ``--device``
is forwarded to every worker: without it a worker takes the CUDA card
and raises when there is none.

This process never imports torch on its supervision path (workers do);
the final checkpoint audit of the report is the one lazy exception.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.runtime.chaos import split_spec_strings
from repro_torch.runtime.fleet import allocate_ports
from repro_torch.runtime.supervisor import (LaunchSpec, RestartPolicy,
                                            Supervisor, write_report)


def make_cmd_builder(a, fleet_dir: str, worker_chaos: list[str],
                     coordinator: str | None):
    """argv factory handed to the Supervisor: maps a LaunchSpec to a
    ``repro_torch.launch.train`` worker invocation."""

    def build(spec: LaunchSpec) -> list[str]:
        argv = [sys.executable, "-m", "repro_torch.launch.train",
                "--arch", a.arch,
                "--steps", str(a.steps),
                "--total-steps", str(a.steps),
                "--seq-len", str(a.seq_len),
                "--global-batch", str(a.global_batch),
                "--ckpt-every", str(a.ckpt_every),
                "--process-id", str(spec.rank),
                "--num-processes", str(spec.world),
                "--fleet-dir", fleet_dir,
                "--fleet-tag", str(spec.tag),
                "--result-out",
                os.path.join(fleet_dir, f"result_rank{spec.tag}.json"),
                "--metrics-out",
                os.path.join(fleet_dir, f"metrics_rank{spec.tag}.json")]
        if a.ckpt_dir:
            argv += ["--ckpt-dir", a.ckpt_dir]
        if not a.smoke:
            argv += ["--full"]
        if spec.with_chaos and worker_chaos:
            for c in worker_chaos:
                argv += ["--chaos", c]
            argv += ["--chaos-seed", str(a.chaos_seed)]
        if spec.striped and spec.stripe_ports:
            argv += ["--striped-restore", "--stripe-ports",
                     ",".join(str(p) for p in spec.stripe_ports)]
        if a.distributed == "torch" and coordinator:
            argv += ["--distributed", "torch", "--coordinator", coordinator]
        if a.device is not None:
            argv += ["--device", a.device]
        return argv

    return build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="process supervisor for a real multi-worker fleet")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20,
                    help="global step horizon for every worker")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--chaos", action="append", default=[], metavar="SPEC",
                    help="worker faults (kill@N, nan@N, diskfull@N, "
                         "partition@N:host=H, ...) plus the supervisor-"
                         "side sigkill@N:host=H; restarted workers get "
                         "no chaos")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--distributed", default="none",
                    choices=["none", "torch"],
                    help="'torch' additionally joins the workers in a gloo "
                         "process group (supervision never depends on "
                         "it; rejoin-after-restart may downgrade)")
    ap.add_argument("--striped-restore", default="auto",
                    choices=["auto", "always", "never"],
                    help="gang restores stripe shard reads across ranks "
                         "(auto: when a checkpoint exists and world > 1)")
    ap.add_argument("--fleet-dir", default=None,
                    help="heartbeats/logs/results dir (default: tmp)")
    ap.add_argument("--report-out", default=None, metavar="PATH")
    ap.add_argument("--device", default=None,
                    help="forwarded to every worker: cuda (default; a "
                         "worker raises without a card) or cpu")
    # restart policy
    ap.add_argument("--max-restarts-per-rank", type=int, default=2)
    ap.add_argument("--max-total-failures", type=int, default=6)
    ap.add_argument("--backoff-base-s", type=float, default=0.25)
    ap.add_argument("--backoff-max-s", type=float, default=8.0)
    ap.add_argument("--hang-timeout-s", type=float, default=30.0)
    a = ap.parse_args(argv)

    fleet_dir = a.fleet_dir or tempfile.mkdtemp(prefix="repro-fleet-")
    os.makedirs(fleet_dir, exist_ok=True)
    _, worker_chaos = split_spec_strings(a.chaos)
    coordinator = None
    if a.distributed == "torch":
        coordinator = f"127.0.0.1:{allocate_ports(1)[0]}"
    policy = RestartPolicy(max_restarts_per_rank=a.max_restarts_per_rank,
                           max_total_failures=a.max_total_failures,
                           backoff_base_s=a.backoff_base_s,
                           backoff_max_s=a.backoff_max_s,
                           hang_timeout_s=a.hang_timeout_s)
    sup = Supervisor(a.nprocs,
                     make_cmd_builder(a, fleet_dir, worker_chaos,
                                      coordinator),
                     fleet_dir=fleet_dir, policy=policy,
                     chaos_specs=a.chaos, chaos_seed=a.chaos_seed,
                     ckpt_dir=a.ckpt_dir,
                     striped_restore=a.striped_restore)
    report = sup.run()
    report["fleet_dir"] = fleet_dir
    if a.report_out:
        write_report(a.report_out, report)
    print(json.dumps({k: report[k] for k in
                      ("outcome", "total_failures", "wall_s",
                       "final_checkpoint_step")}, indent=2))
    return 0 if report["outcome"] in ("completed", "degraded") else 1


if __name__ == "__main__":
    raise SystemExit(main())
