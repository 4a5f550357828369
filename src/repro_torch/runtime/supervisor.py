"""Process supervisor: restart policy, chaos SIGKILL, elastic gang re-mesh.

A copy of the reference package's ``repro.runtime.supervisor`` (standard
library only; the port imports nothing of the reference).  The in-loop
recovery machine (``launch/train.py``) heals a run from INSIDE the
process; this module is the layer a real fleet needs OUTSIDE it — the
thing systemd/k8s/SLURM would be, specialised to this repo's failure
taxonomy.  It spawns ``nprocs`` worker processes (rank R of W; the
``cmd_builder`` seam supplies the argv — the port's serve launcher builds
``repro_torch.launch.serve --worker --process-id R --num-processes W``)
and supervises them against a restart policy keyed on EXIT STATUS::

    exit 0             worker finished its horizon          -> done
    exit 43            injected preemption (ChaosKilled)    -> restart
    other / signal     crash (SIGKILL, OOM, bug)            -> restart

Restarts are bounded: per-rank exponential backoff with deterministic
jitter (seeded by (chaos_seed, rank, attempt) so drills replay), a
per-rank restart cap after which the rank is EVICTED — the supervisor
SIGTERMs the surviving gang and relaunches it re-meshed over the
survivors via :func:`repro_torch.runtime.fault.plan_elastic_remesh`
(power-of-two trim; surplus survivors park as hot spares) — and a global
failure budget after which everything is torn down cleanly, reporting the
newest COMMITTED checkpoint step so the operator knows the recovery
point.

Liveness is judged from worker heartbeat files (``fleet_dir/hb/``, mtime
on the supervisor's clock): a worker that has heartbeat once and then
gone quiet for ``hang_timeout_s`` — e.g. chaos ``partition@N`` — is
SIGKILLed and takes the normal crash-restart path.  Supervisor-side
chaos (``sigkill@N:host=H``) kills rank H's process the moment its
heartbeat reaches step N: a REAL uncatchable death, no preemption grace.

Restarted workers get NO chaos flags — step-deterministic faults would
re-fire on every replay of the same step and the run would never finish.
Gang relaunches over an existing checkpoint set ``LaunchSpec.striped``
(each rank reads 1/W of the shard bytes, peers exchange the rest); solo
restarts fall back to full reads because striping is collective.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import time

from repro_torch.obs import REGISTRY

from .chaos import (KILL_EXIT_CODE, ChaosSpec, parse_chaos,
                    split_spec_strings)
from .fault import plan_elastic_remesh
from .fleet import HEARTBEAT_DIR, allocate_ports, read_heartbeat

__all__ = ["LaunchSpec", "RestartPolicy", "Supervisor", "KILL_EXIT_CODE"]


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounds on self-healing; defaults sized for CI-scale drills."""

    max_restarts_per_rank: int = 2     # then: evict + gang re-mesh
    max_total_failures: int = 6        # then: clean shutdown
    backoff_base_s: float = 0.25
    backoff_max_s: float = 8.0
    backoff_jitter: float = 0.25       # +[0, jitter) * base, deterministic
    hang_timeout_s: float = 30.0       # quiet-heartbeat SIGKILL threshold
    term_grace_s: float = 5.0          # SIGTERM -> SIGKILL escalation
    max_wall_s: float = 0.0            # whole-run ceiling; 0 = unbounded

    def backoff_s(self, attempt: int, *, seed: int = 0,
                  rank: int = 0) -> float:
        """Exponential in ``attempt`` (1-based), capped, with jitter that
        is a pure function of (seed, rank, attempt) — string-seeded so it
        is stable across processes regardless of PYTHONHASHSEED."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** max(0, attempt - 1)))
        rng = random.Random(f"{seed}:{rank}:{attempt}")
        return base * (1.0 + self.backoff_jitter * rng.random())


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """What the command builder needs to know to exec one worker."""

    rank: int                       # rank in the CURRENT gang
    world: int                      # current gang size
    tag: int                        # stable id (initial rank) across re-mesh
    attempt: int                    # 1-based launch count for this tag
    with_chaos: bool                # pass --chaos flags (first launch only)
    striped: bool                   # gang restore may stripe shard reads
    stripe_ports: tuple[int, ...] = ()


@dataclasses.dataclass
class _Worker:
    tag: int
    rank: int
    state: str = "new"         # new|running|backoff|done|evicted|spare
    proc: subprocess.Popen | None = None
    log: object = None
    attempts: int = 0          # launches
    restarts: int = 0          # failures so far (attempts - 1 on relaunch)
    resume_at: float = 0.0
    launched_at: float = 0.0
    exit_history: list = dataclasses.field(default_factory=list)


class Supervisor:
    """Drive a gang of worker processes to completion under the policy.

    ``cmd_builder(spec: LaunchSpec) -> list[str]`` supplies the argv —
    the supervisor owns WHEN processes run, the launcher owns WHAT runs,
    so tests can supervise trivial stand-in scripts."""

    def __init__(self, nprocs: int, cmd_builder, *, fleet_dir: str,
                 policy: RestartPolicy | None = None,
                 chaos_specs=(), chaos_seed: int = 0,
                 ckpt_dir: str | None = None, poll_s: float = 0.05,
                 striped_restore: str = "auto"):
        assert nprocs >= 1
        assert striped_restore in ("auto", "always", "never")
        self.nprocs = nprocs
        self.cmd_builder = cmd_builder
        self.fleet_dir = fleet_dir
        self.policy = policy or RestartPolicy()
        self.chaos_seed = chaos_seed
        self.ckpt_dir = ckpt_dir
        self.poll_s = poll_s
        self.striped_restore = striped_restore
        sup_specs, _ = split_spec_strings(chaos_specs)
        self._sigkill_specs: list[ChaosSpec] = [parse_chaos(s)
                                                for s in sup_specs]
        self._sigkill_fired: set[int] = set()
        self.workers = [_Worker(tag=r, rank=r) for r in range(nprocs)]
        self.events: list[dict] = []
        self.total_failures = 0
        self.last_plan = None
        self._escalated = False
        os.makedirs(os.path.join(fleet_dir, HEARTBEAT_DIR), exist_ok=True)

    # -- bookkeeping --------------------------------------------------------

    def _event(self, kind: str, **kw) -> None:
        ev = {"kind": kind, "t": time.time(), **kw}
        self.events.append(ev)
        REGISTRY.counter("supervisor_events", kind=kind)
        detail = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"[supervisor] {kind} {detail}".rstrip())

    def _gang_world(self) -> list[_Worker]:
        """Members of the current gang (anything not evicted/spare)."""
        return [w for w in self.workers
                if w.state not in ("evicted", "spare")]

    def _ckpt_exists(self) -> bool:
        if not self.ckpt_dir or not os.path.isdir(self.ckpt_dir):
            return False
        return any(d.startswith("step_") and "tmp" not in d
                   for d in os.listdir(self.ckpt_dir))

    # -- launching ----------------------------------------------------------

    def _launch(self, w: _Worker, *, world: int, with_chaos: bool,
                striped: bool, stripe_ports: tuple[int, ...] = ()) -> None:
        w.attempts += 1
        spec = LaunchSpec(rank=w.rank, world=world, tag=w.tag,
                          attempt=w.attempts, with_chaos=with_chaos,
                          striped=striped, stripe_ports=stripe_ports)
        argv = self.cmd_builder(spec)
        log_path = os.path.join(self.fleet_dir,
                                f"log_rank{w.tag}_a{w.attempts}.log")
        w.log = open(log_path, "wb")
        w.proc = subprocess.Popen(argv, stdout=w.log, stderr=w.log)
        w.launched_at = time.time()
        w.state = "running"
        self._event("launch", tag=w.tag, rank=w.rank, world=world,
                    attempt=w.attempts, pid=w.proc.pid,
                    chaos=with_chaos, striped=striped)

    def _reap(self, w: _Worker) -> None:
        if w.log is not None:
            try:
                w.log.close()
            except OSError:
                pass
            w.log = None

    def _gang_launch(self, members: list[_Worker], *,
                     with_chaos: bool) -> None:
        world = len(members)
        if self.striped_restore == "always":
            striped = world > 1
        elif self.striped_restore == "never":
            striped = False
        else:
            striped = world > 1 and self._ckpt_exists()
        ports = tuple(allocate_ports(world)) if striped else ()
        for w in members:
            self._launch(w, world=world, with_chaos=with_chaos,
                         striped=striped, stripe_ports=ports)

    # -- failure handling ---------------------------------------------------

    def _classify(self, rc: int) -> str:
        if rc == 0:
            return "done"
        if rc == KILL_EXIT_CODE:
            return "chaos_exit"
        return "crash"

    def _on_exit(self, w: _Worker, rc: int) -> None:
        self._reap(w)
        w.proc = None
        kind = self._classify(rc)
        w.exit_history.append(rc)
        if kind == "done":
            w.state = "done"
            self._event("worker_done", tag=w.tag, rank=w.rank)
            return
        self.total_failures += 1
        self._event("worker_failed", tag=w.tag, rank=w.rank, rc=rc,
                    cause=kind, total_failures=self.total_failures)
        if self.total_failures > self.policy.max_total_failures:
            self._escalate("failure budget exhausted")
            return
        w.restarts += 1
        if w.restarts > self.policy.max_restarts_per_rank:
            self._evict_and_remesh(w)
            return
        delay = self.policy.backoff_s(w.restarts, seed=self.chaos_seed,
                                      rank=w.tag)
        w.state = "backoff"
        w.resume_at = time.time() + delay
        self._event("backoff", tag=w.tag, restarts=w.restarts,
                    delay_s=round(delay, 3))

    def _kill_worker(self, w: _Worker, *, graceful: bool) -> None:
        if w.proc is None or w.proc.poll() is not None:
            return
        try:
            if graceful:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=self.policy.term_grace_s)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()
            else:
                w.proc.kill()
                w.proc.wait()
        except OSError:
            pass

    def _evict_and_remesh(self, dead: _Worker) -> None:
        """Repeated failure of one rank: stop paying its restarts.  Evict
        it, SIGTERM the surviving gang (their world size is stale), and
        relaunch re-meshed over the survivors."""
        dead.state = "evicted"
        self._event("evict", tag=dead.tag, restarts=dead.restarts)
        # spares rejoin the pool here — that is what they are for; done
        # workers already reached the horizon and stay finished
        survivors = [w for w in self.workers if w is not dead
                     and w.state in ("running", "backoff", "new", "spare")]
        for w in survivors:
            if w.state == "running":
                self._kill_worker(w, graceful=True)
                if w.proc is not None:
                    w.exit_history.append(w.proc.returncode)
                    w.proc = None
                self._reap(w)
        if not survivors:
            # nobody left NEEDING work — peers that already finished keep
            # their results (degraded), and if no one finished either the
            # outcome resolves to "failed"; both are judged at exit, not
            # escalated as a budget problem
            self._event("no_survivors", evicted=dead.tag)
            return
        plan = plan_elastic_remesh(sorted(w.tag for w in survivors),
                                   chips_per_host=1, model_parallel=1)
        self.last_plan = dataclasses.asdict(plan)
        gang = []
        for w in survivors:
            if w.tag in plan.host_ranks:
                w.rank = plan.host_ranks[w.tag]
                w.state = "new"
                gang.append(w)
            else:
                w.state = "spare"     # power-of-two trim: hot spare
                self._event("spare", tag=w.tag)
        self._event("remesh", survivors=[w.tag for w in gang],
                    world=len(gang), dp=plan.data_parallel)
        self._gang_launch(sorted(gang, key=lambda w: w.rank),
                          with_chaos=False)

    def _escalate(self, reason: str) -> None:
        """Global failure budget blown: stop burning the fleet.  Tear
        everything down gracefully (SIGTERM grace lets in-flight saves
        land) and leave the newest committed checkpoint as the recovery
        point."""
        self._event("escalate", reason=reason)
        for w in self.workers:
            if w.state == "running":
                self._kill_worker(w, graceful=True)
                if w.proc is not None:
                    w.exit_history.append(w.proc.returncode)
                    w.proc = None
                self._reap(w)
            if w.state in ("running", "backoff", "new"):
                w.state = "evicted"
        self._escalated = True

    # -- liveness -----------------------------------------------------------

    def _apply_sigkill_chaos(self, w: _Worker, now: float) -> None:
        for idx, sp in enumerate(self._sigkill_specs):
            if idx in self._sigkill_fired or sp.host != w.tag:
                continue
            hb = read_heartbeat(self.fleet_dir, w.tag)
            if hb is None or hb.get("_mtime", 0) < w.launched_at:
                continue                  # stale file from a prior attempt
            if hb.get("step", -1) >= sp.step:
                self._sigkill_fired.add(idx)
                self._event("chaos_sigkill", tag=w.tag, step=hb["step"],
                            spec_step=sp.step)
                self._kill_worker(w, graceful=False)

    def _check_hang(self, w: _Worker, now: float) -> None:
        """A worker that heartbeat once and then went dark (chaos
        ``partition``, a livelock, a wedged I/O) is indistinguishable
        from dead — SIGKILL it onto the ordinary crash-restart path.
        Judged only on heartbeats newer than this launch, so slow startup
        (jit warmup) is never mistaken for a hang."""
        hb = read_heartbeat(self.fleet_dir, w.tag)
        if hb is None or hb.get("_mtime", 0) < w.launched_at:
            return
        if now - hb["_mtime"] > self.policy.hang_timeout_s:
            self._event("hang_kill", tag=w.tag, last_step=hb.get("step"),
                        quiet_s=round(now - hb["_mtime"], 2))
            self._kill_worker(w, graceful=False)

    # -- main loop ----------------------------------------------------------

    def run(self) -> dict:
        t0 = time.time()
        self._escalated = False
        self._gang_launch(self._gang_world(), with_chaos=True)
        try:
            while any(w.state in ("running", "backoff", "new")
                      for w in self.workers):
                now = time.time()
                if 0 < self.policy.max_wall_s < now - t0:
                    # a serving fleet wedged on a dead coordinator or a
                    # migration loop must not hold CI hostage — same
                    # clean-teardown path as the failure budget
                    self._escalate("wall-clock ceiling "
                                   f"{self.policy.max_wall_s:.0f}s")
                    break
                for w in self.workers:
                    if w.state == "backoff" and now >= w.resume_at:
                        # solo relaunch: same gang geometry, no chaos,
                        # full-read restore (striping is collective)
                        self._launch(w, world=len(self._gang_world()),
                                     with_chaos=False, striped=False)
                    elif w.state == "running":
                        rc = w.proc.poll()
                        if rc is None:
                            self._apply_sigkill_chaos(w, now)
                            self._check_hang(w, now)
                        else:
                            self._on_exit(w, rc)
                time.sleep(self.poll_s)
        finally:
            for w in self.workers:      # never leak processes
                self._kill_worker(w, graceful=False)
                self._reap(w)
        if self._escalated:
            outcome = "budget_exhausted"
        elif all(w.state == "done" for w in self.workers):
            outcome = "completed"
        elif any(w.state == "done" for w in self.workers):
            outcome = "degraded"        # finished minus evicted/spares
        else:
            outcome = "failed"
        report = {
            "outcome": outcome,
            "nprocs": self.nprocs,
            "total_failures": self.total_failures,
            "wall_s": time.time() - t0,
            "plan": self.last_plan,
            "final_checkpoint_step": self._final_checkpoint_step(),
            "workers": [{"tag": w.tag, "rank": w.rank, "state": w.state,
                         "attempts": w.attempts, "restarts": w.restarts,
                         "exit_history": w.exit_history}
                        for w in self.workers],
            "events": self.events,
        }
        self._event("report", outcome=outcome,
                    failures=self.total_failures,
                    final_ckpt=report["final_checkpoint_step"])
        return report

    def _final_checkpoint_step(self) -> int | None:
        """Newest CRC-verified step — the committed recovery point the
        report promises.  Imported lazily: the supervisor itself never
        needs torch unless asked for this audit."""
        if not self.ckpt_dir:
            return None
        try:
            from repro_torch.checkpoint import verified_steps
            steps = verified_steps(self.ckpt_dir)
            return steps[-1] if steps else None
        except Exception as e:
            self._event("ckpt_audit_error", error=str(e))
            return None


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, path)
