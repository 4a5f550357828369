"""Training launcher of the port: a self-healing single-process train loop.

The loop is the reference's explicit recovery state machine
(``repro.launch.train``) on one device — every transition below is
exercised by injected faults (``repro_torch.runtime.chaos``) in tests::

            +--------------------- RUN ----------------------+
            | step -> heartbeat -> monitor.check -> guard    |
            +--+----------------+----------------------+-----+
               | host dead /    | guard: "rollback"    | guard: "skip"
               | straggler      | (skip budget blown   | (nonfinite grad;
               v                |  or loss spike)      |  params untouched
            REMESH              v                      |  by the step's
            plan_elastic_    RESTORE                   |  finite guard)
            remesh over      newest INTACT checkpoint  |
            survivors  --->  (CRC-verified, falls  ----+--> back to RUN
            re-shard data    back past corrupt steps),
                             rewind step counter

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 5 --device cpu
    # fault drill: die at step 6 after the step-4 save, then resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 12 --ckpt-dir /tmp/ckpt --ckpt-every 4 \
        --chaos kill@6 --chaos nan@2 --device cpu      # exits 43
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --total-steps 12 --ckpt-dir /tmp/ckpt --device cpu

It runs the step-indexed synthetic data stream with its prefetch thread
(a restart or a re-mesh replays the exact global batches), merged with
the reference's zero extras (``make_extras``: ``frames`` for the audio
kind, ``vision`` for the vlm kind, on the run's device),
``make_train_step`` (forward under per-layer recompute, CE + aux + z-loss,
backward through the flash kernels, AdamW with the nonfinite skip, all in
place), ``GradGuard``, format-v2 checkpoints written asynchronously with a
CRC32 commit (``repro_torch.checkpoint``, the reference's file format),
restore on start and on rollback, and a simulated fleet of ``n_hosts``:
peers heartbeat on a per-step virtual clock, so silence and straggler
chaos is deterministic, while host 0's compute is real.  A re-mesh
re-plans the data shards over the survivors (``ShardedLoader.reshard``);
with one device there is no mesh to rebuild, so the state is restored in
place.

Under a mesh with an axis above one rank (``mesh_kind`` a ready
:class:`Mesh`: local rings on one card, or processes), the params and
AdamW moments are placed by ``param_specs`` (``parallel.sharding.
shard_tree``; the moments' ``step`` replicated) and the step runs data-
and tensor-parallel on the shards; a data rank of a process mesh loads
its rows by its data index.  Checkpoints hold the global tree
(``gather_tree``; rank 0 of a process mesh writes it), so a sharded run's
checkpoint equals an unsharded run's leaf for leaf, and a restore places
the host tree onto the mesh the run now drives (the reference's
``sharding_fn``: the elastic re-shard).  ``place=False`` keeps the whole
state on every rank, as the context-parallel ring takes it.

The LR schedule spans the run's global horizon (``warmup_steps=5``,
``total_steps=max(end_step, 10)``), so a killed and restarted run resumes
bit for bit.

Worker mode (``--process-id R --num-processes W``, launched by
``repro_torch.launch.supervisor``): this process is rank R of a real
W-process fleet.  Each rank computes the identical full global batch
(deterministic redundancy: no collective runs in the step, so two ranks
share one card, or the CPU, and their states stay bit-identical, which
the result files prove with ``tree_fingerprint``).  Rank 0 alone writes
checkpoints; every rank restores from the shared directory.  Each rank
publishes a heartbeat file a step (``FleetWorker.heartbeat``) that the
supervisor's hang detector watches, and keeps it fresh from a thread
while checkpoint I/O blocks the loop (``FleetWorker.keep_alive``: rank
0's saves, a restore, the final fingerprint), so a full-width save is
not taken for a hang at the supervisor's default ``--hang-timeout-s``.
It dies with exit status 43 on an injected kill aimed at it, and on a
gang restart may restore STRIPED:
each rank reads 1/W of the shard's bytes and all-gathers the rest from
its peers over loopback TCP (``--striped-restore --stripe-ports``).
``--total-steps`` is the run's global horizon, so a restarted worker
resumes from its checkpoint and stops where the uninterrupted run would:
the bit-identical-resume contract.  ``--distributed torch`` also joins a
process group at ``--coordinator``, on the backend
``launch.mesh.process_group_backend`` picks (``nccl`` where each worker
has a card of its own, else ``gloo``: NCCL refuses two ranks on one
card); supervision never depends on it, and a group that does not form
within its timeout leaves ``dist_ok`` false with a printed warning, as
the reference's ``--distributed jax`` does.

Production meshes (``--mesh single|multi``): one process a rank, started
by torchrun, each on card ``LOCAL_RANK % device_count``::

    torchrun --nnodes 16 --nproc-per-node 16 ... \
        -m repro_torch.launch.train --arch qwen3-4b --full --mesh single

A run given ``single`` or ``multi`` with no process group up joins one
from torchrun's environment (``launch.mesh.join_production_group``:
``env://``, the backend by the same rule, decided before the group forms,
printed in the run's start line and returned as ``backend``); without
that environment, or in a group of the wrong size, it raises
``make_production_mesh``'s error and never drops to a local mesh.  This
is the port's counterpart of the reference's single controller that sees
every chip, so a failure to join is fatal here, unlike the fleet
worker's optional group.

The run takes the CUDA card unless given ``device="cpu"``; a worker
given no device takes the current card (``make_worker_mesh``) and raises
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchBundle, get_bundle
from repro_torch.data import DataConfig, make_train_iterator
from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (join_production_group, make_local_mesh,
                                    make_production_mesh, make_worker_mesh,
                                    process_group_backend)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.mesh import Mesh, set_mesh
from repro_torch.parallel.sharding import (gather_tree, load_tree_,
                                           param_specs, shard_tree)
from repro_torch.runtime import (ChaosInjector, ChaosKilled, FleetWorker,
                                 HeartbeatMonitor, StragglerPolicy,
                                 plan_elastic_remesh, tree_fingerprint)
from repro_torch.training import (GradGuard, GuardPolicy, TrainHyper,
                                  make_train_step)

SEED = 0              # the reference's PRNGKey(0)
DIST_TIMEOUT_S = 60.0  # how long a worker waits for its process group


def make_extras(bundle, per_host_batch: int, device) -> dict:
    """The reference launcher's zero extras of one host's batch: f32
    ``frames`` for the audio kind, ``vision`` for the vlm kind
    (``ArchBundle.zero_extras``), on ``device``."""
    return bundle.zero_extras(per_host_batch, torch.float32, device)


MESH_KINDS = ("local", "single", "multi")


def resolve_mesh(mesh_kind, device=None) -> Mesh:
    """``mesh_kind``: a ready :class:`Mesh` as it is (e.g. a (2, 4) mesh
    of local rings on one card, or of processes), ``"local"`` (a (1, 1)
    mesh), or the reference's production meshes, ``"single"``
    (``make_production_mesh()``) and ``"multi"``
    (``make_production_mesh(multi_pod=True)``), over the process group;
    with none up, this process first joins one from torchrun's
    environment for ``device`` (``join_production_group``), and raises
    without it."""
    if isinstance(mesh_kind, Mesh):
        return mesh_kind
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh {mesh_kind!r} not in {MESH_KINDS}")
    if mesh_kind == "local":
        return make_local_mesh()
    multi = mesh_kind == "multi"
    if not dist.is_initialized():
        join_production_group("cuda" if device is None else device,
                              multi_pod=multi)
    return make_production_mesh(multi_pod=multi)


def place_state(bundle, params, mesh: Mesh) -> tuple[dict, dict]:
    """(params, AdamW state) placed on ``mesh`` by ``param_specs``: the
    moments as the params, ``step`` replicated."""
    placed = shard_tree(params, param_specs(bundle.kind, params, mesh),
                        mesh)
    return placed, adamw_init(placed)


def init_process_group(coordinator: str, num_processes: int,
                       process_id: int, backend: str = "gloo") -> bool:
    """Join the ``backend`` process group at ``tcp://<coordinator>`` as
    rank ``process_id`` of ``num_processes``; True iff it formed (every
    peer joined) within ``DIST_TIMEOUT_S``, or was up already.  Any failure
    is a printed warning and False, with no other backend tried: the group
    is an upgrade, never a requirement, as the reference's
    ``compat.distributed_initialize``."""
    if dist.is_initialized():
        return True
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        return True
    except Exception as e:  # noqa: BLE001 — availability probe by contract
        print(f"[train] warning: torch.distributed did not form at "
              f"{coordinator} ({type(e).__name__}: {e}); continuing as "
              f"a single process")
        return False


def run(arch, *, smoke: bool = True, steps: int = 20,
        seq_len: int = 128, global_batch: int = 8, mesh_kind="local",
        microbatches: int = 1,
        lr: float = 3e-4, log_every: int = 1, device=None,
        ckpt_dir: str | None = None, ckpt_every: int = 10, chaos=None,
        chaos_seed: int = 0, n_hosts: int = 1,
        hb_timeout_steps: float | None = None,
        straggler_factor: float | None = None,
        straggler_patience: int | None = None,
        guard_policy: GuardPolicy | None = None, max_recoveries: int = 8,
        trace_out: str | None = None, metrics_out: str | None = None,
        telemetry=None, total_steps: int | None = None,
        params=None, on_step=None,
        fleet: FleetWorker | None = None, place: bool = True) -> dict:
    """Train ``arch``, a config name (its smoke config with ``smoke``) or
    an ``ArchBundle`` taken as it is (e.g. a config cut in depth; ``smoke``
    does not apply), from random weights drawn from seed 0 (or from ``params``,
    which are updated in place), or from the newest intact checkpoint in
    ``ckpt_dir``, restored into them; ``steps`` more steps, or up to
    ``total_steps`` in all, each step under ``mesh_kind``'s mesh
    (:func:`resolve_mesh`): with an axis above one rank the state is
    placed on it (module docstring; ``params`` given are placed as copies,
    and the returned ``params`` and ``opt`` are placed trees; a kind
    without a placed body raises ValueError), unless ``place`` is False,
    when attention over a ``model`` axis of more than one rank takes the
    ring policy's paths.  ``chaos`` is a ``ChaosInjector``
    or a list of spec strings.  ``on_step(i, params, opt, metrics)``, if
    given, is called after each step the loop keeps (not one it rolls back
    or re-meshes over).  ``fleet`` runs the loop as one worker of a
    supervised fleet (module docstring): rank 0 alone saves, heartbeats go
    to the fleet directory, a kill fires only on its target rank, the
    start-up restore stripes over the fleet's exchange when
    ``fleet.striped_restore`` is set, and the final state's fingerprint
    and losses go to ``fleet.result_out``.  Returns the per-step
    ``losses``, ``steps`` (indices), ``seconds`` (host wall, after a
    device synchronise) and ``metrics``, the recovery ``events``, the
    final ``params`` and ``opt``, and the telemetry snapshot (None when
    telemetry is off).
    Raises ``ChaosKilled`` (a ``SystemExit`` with code 43) on ``kill@N``,
    after the in-flight checkpoint save has landed."""
    if chaos is not None and not isinstance(chaos, ChaosInjector):
        chaos = ChaosInjector(chaos, seed=chaos_seed)
    if fleet is not None:
        first = resolve_device(device)  # no card and no device: raise first
        if fleet.distributed == "torch" and fleet.coordinator:
            # the workers share this host: each has a card of its own
            # where there are as many cards as workers
            fleet.dist_ok = init_process_group(
                fleet.coordinator, fleet.num_processes, fleet.process_id,
                process_group_backend(
                    first, fleet.num_processes,
                    torch.cuda.device_count() if first.type == "cuda"
                    else 0))
        mesh = make_worker_mesh()   # this rank's card becomes current
    else:
        mesh = resolve_mesh(mesh_kind, device)
    dev = resolve_device(device)
    backend = str(dist.get_backend()) if dist.is_initialized() else None
    # with the process group up, the GLOBAL process count (1 means the
    # group never formed)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_procs = dist.get_world_size() if dist.is_initialized() else 1
    bundle = arch if isinstance(arch, ArchBundle) else \
        get_bundle(arch, smoke=smoke)
    print(f"[train] start: {bundle.arch_id}, mesh {mesh}, process group "
          f"{backend or 'none'}"
          f"{f' (rank {dist.get_rank()} of {n_procs})' if backend else ''},"
          f" device {dev}")
    sharded = place and any(n > 1 for n in mesh.shape.values())
    if sharded:
        bundle.require_placed_body()
    if params is None:
        params = bundle.init_params(SEED, device=dev)
    if sharded:
        params, opt = place_state(bundle, params, mesh)
    else:
        opt = adamw_init(params)
    state = {"params": params, "opt": opt}      # restored into in place
    # this process's rows among the data ranks of the mesh's process axes
    data_idx, data_n = tp.data_index(mesh) if sharded else (0, 1)
    if data_n > 1 and n_hosts > 1:
        raise ValueError("a simulated fleet (n_hosts) under a mesh of "
                         "data processes")

    def sharding_fn(host: dict) -> dict:
        """A restored host tree placed onto the mesh this run drives, into
        the live state (the reference's elastic re-shard)."""
        return load_tree_(state, host)

    def snapshot() -> dict:
        """The global tree a checkpoint holds (a collective gather on a
        process mesh: every rank calls it)."""
        return gather_tree(state, device="cpu") if sharded else state
    data_cfg = DataConfig(vocab=bundle.cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch)

    start_step = 0
    mgr = None
    exchange = None
    # with replicated fleet compute every rank holds identical state, so
    # rank 0 alone writes checkpoints (it is host 0, the manifest writer);
    # every rank restores from the shared dir
    can_save = fleet is None or fleet.process_id == 0
    if sharded and dist.is_initialized():
        can_save = dist.get_rank() == 0
    if ckpt_dir:
        mgr = CheckpointManager(
            ckpt_dir, fault_hook=chaos.checkpoint_write_hook
            if chaos is not None and can_save else None)
        stripe = None
        if fleet is not None and fleet.striped_restore:
            # collective striped restore: valid only on a gang start where
            # every rank reaches this point (the supervisor passes
            # --striped-restore to whole gangs only)
            exchange = fleet.make_exchange()
            if exchange is not None:
                stripe = (fleet.process_id, fleet.num_processes, exchange)
        restored = mgr.restore(state, stripe=stripe,
                               sharding_fn=sharding_fn if sharded else None)
        if restored is not None:
            start_step = restored[0]
            print(f"[train] restored step {start_step} from {ckpt_dir}"
                  f"{' (striped)' if stripe else ''}")

    # the LR schedule spans the run's GLOBAL horizon (restored start +
    # remaining steps, or `total_steps`), so a crash-restarted run rebuilds
    # the exact schedule the uninterrupted run used — bit-identical resume
    # depends on it
    end_step = max(total_steps, start_step) if total_steps is not None \
        else start_step + steps
    hyper = TrainHyper(optimizer=AdamWConfig(
        lr=lr, warmup_steps=5, total_steps=max(end_step, 10)),
        microbatches=microbatches)
    step_fn = make_train_step(bundle.forward, hyper)

    # -- simulated fleet: host 0 is this process; peers heartbeat on a
    # per-step virtual clock so chaos silence/slowness is deterministic
    host_id, rank, n_data_hosts = 0, data_idx, max(n_hosts, data_n)
    if global_batch % n_hosts:
        raise ValueError(f"global_batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    vclock = [0.0]
    # telemetry traces the recovery state machine ON THE VIRTUAL CLOCK, so
    # a chaos scenario replays with bit-identical span timestamps;
    # installed globally so GradGuard/checkpoint events land in the same
    # registry
    tel = telemetry
    if tel is None:
        if trace_out or metrics_out:
            tel = obs.enable(clock=lambda: vclock[0], process_name="train")
        else:
            tel = obs.get_telemetry()
    monitor = HeartbeatMonitor(
        list(range(n_hosts)),
        StragglerPolicy.from_env(
            heartbeat_timeout_s=hb_timeout_steps,
            straggler_factor=straggler_factor,
            patience=straggler_patience,
            default=StragglerPolicy(heartbeat_timeout_s=4.0,
                                    straggler_factor=2.0, patience=3)),
        clock=lambda: vclock[0])
    guard = GradGuard(guard_policy or GuardPolicy())

    loader = ShardedLoader(SyntheticLM(data_cfg), rank, n_data_hosts)
    it = make_train_iterator(data_cfg, start_step=start_step, loader=loader)
    extras = make_extras(bundle, global_batch // n_data_hosts, dev)

    history, step_log, seconds, metrics_log, events = [], [], [], [], []
    i = start_step
    recoveries = 0
    last_saved = start_step if mgr else None

    def busy(at_step: int):
        """Context for a stretch of checkpoint I/O: a fleet worker keeps
        its heartbeat fresh through it, unless chaos partitions it."""
        if fleet is None or (chaos is not None and chaos.partitioned(
                at_step, fleet.process_id)):
            return contextlib.nullcontext()
        return fleet.keep_alive(at_step)

    def ckpt_wait(at_step: int) -> bool:
        """Land the in-flight async save; a FAILED WRITE (e.g. chaos
        diskfull -> ENOSPC) is an event, never a crash — a full disk
        costs recovery-point age, not the run."""
        try:
            mgr.wait()
            return True
        except OSError as e:
            events.append({"kind": "ckpt_save_failed", "step": at_step,
                           "error": str(e)})
            print(f"[train] checkpoint save failed ({e}); continuing")
            return False

    def restore_or_keep(reason: str, at_step: int) -> int:
        """RESTORE state: rewind to the newest intact checkpoint (the
        manager walks past corrupt ones); with nothing restorable, keep
        the current (guarded) state and continue forward."""
        with tel.span("RESTORE", step=at_step, reason=reason), \
                busy(at_step):
            restored = None
            if mgr is not None:
                ckpt_wait(at_step)
                restored = mgr.restore(
                    state, sharding_fn=sharding_fn if sharded else None)
            if restored is None:
                events.append({"kind": "rollback_unavailable",
                               "step": at_step, "reason": reason})
                return at_step
            rstep = restored[0]
            events.append({"kind": "restore", "step": at_step,
                           "restored_step": rstep, "reason": reason})
            print(f"[train] {reason} at step {at_step}: restored checkpoint "
                  f"step {rstep}")
            return rstep

    fired_seen = len(chaos.fired) if chaos is not None else 0

    def drain_chaos_instants(at_step: int) -> None:
        """Mirror newly-fired chaos events into the trace as instants."""
        nonlocal fired_seen
        if chaos is None or not tel.enabled:
            return
        for ev in chaos.fired[fired_seen:]:
            tel.instant("chaos", cat="chaos", event=str(ev), step=at_step)
        fired_seen = len(chaos.fired)

    def reopen_data(at_step: int) -> None:
        nonlocal it, extras, loader
        it.close()
        loader = loader.reshard(rank, n_data_hosts)
        it = make_train_iterator(data_cfg, start_step=at_step,
                                 loader=loader)
        extras = make_extras(bundle, global_batch // n_data_hosts, dev)

    def recover(reason: str, at_step: int) -> int:
        """RESTORE, then RUN again from the restored step."""
        nonlocal recoveries, run_span
        recoveries += 1
        if recoveries > max_recoveries:
            raise RuntimeError("recovery limit exceeded")
        at = restore_or_keep(reason, at_step)
        reopen_data(at)
        guard.reset()
        if tel.enabled:
            run_span = tel.begin("RUN", cat="state", step=at)
        return at

    run_span = tel.begin("RUN", cat="state", step=i) if tel.enabled else None
    try:
        while i < end_step:
            vclock[0] += 1.0
            if fleet is not None and not (
                    chaos is not None
                    and chaos.partitioned(i, fleet.process_id)):
                fleet.heartbeat(i)
            if chaos is not None:
                try:
                    # raises ChaosKilled (43); a fleet worker dies only
                    # when the spec targets its rank
                    chaos.maybe_kill(
                        i, rank=fleet.process_id if fleet else None)
                except ChaosKilled:
                    # preemption grace (SIGTERM-style): an in-flight async
                    # save lands before death, so "the last completed
                    # checkpoint" is a deterministic notion.  NOTHING here
                    # may displace the kill: a pending save error surfacing
                    # now would turn exit 43 into exit 1
                    if mgr:
                        try:
                            with busy(i):
                                mgr.wait()
                        except Exception:
                            pass
                    raise

            t0 = time.perf_counter()
            idx, batch = it.next()
            if idx != i:
                raise RuntimeError(f"data stream at batch {idx}, loop at "
                                   f"step {i}")
            batch = {**{k: torch.from_numpy(v).to(dev, torch.long)
                        for k, v in batch.items()}, **extras}
            gs = chaos.grad_scale(i) if chaos is not None else None
            with set_mesh(mesh):
                params, opt, m = step_fn(params, opt, batch, gs)
            m = {k: float(v) for k, v in m.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            loss, finite = m["loss"], m["finite"] > 0.0

            # heartbeats: ours is real; simulated peers echo our step time
            # unless chaos silences or slows them
            for h in monitor.alive_hosts():
                if chaos is not None:
                    if chaos.heartbeat_silenced(h, i):
                        continue
                    monitor.heartbeat(h, dt * chaos.step_time_factor(h, i))
                else:
                    monitor.heartbeat(h, dt)
            failed = monitor.check()
            action = guard.update(loss, finite)
            drain_chaos_instants(i)
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

            if failed:
                # FAULT -> REMESH -> RESTORE: re-plan the data shards over
                # the survivors, restore the newest intact checkpoint and
                # re-open the step-indexed data stream
                tel.finish(run_span, end_step=i, reason="host_failure")
                run_span = None
                with tel.span("REMESH", cat="state", step=i,
                              failed=str(failed)):
                    survivors = monitor.alive_hosts()
                    if host_id not in survivors:
                        raise RuntimeError(f"host {host_id} was evicted")
                    plan = plan_elastic_remesh(survivors, chips_per_host=1,
                                               model_parallel=1)
                    rank = plan.host_ranks[host_id]
                    n_data_hosts = plan.n_hosts
                    events.append({"kind": "remesh", "step": i,
                                   "failed": failed, "survivors": survivors,
                                   "plan": dataclasses.asdict(plan)})
                    print(f"[train] hosts {failed} failed at step {i}; "
                          f"remesh over {survivors} "
                          f"(dp={plan.data_parallel})")
                i = recover("host failure", i)
                continue

            if action == "rollback":
                print(f"[guard] step {i}: rollback "
                      f"(trigger={guard.last_trigger})")
                tel.instant("guard_rollback", cat="guard", step=i,
                            trigger=guard.last_trigger)
                tel.finish(run_span, end_step=i, reason="divergence")
                run_span = None
                i = recover("divergence", i)
                continue

            if action == "skip":
                print(f"[guard] step {i}: skip "
                      f"(trigger={guard.last_trigger}, consecutive="
                      f"{guard.consecutive_skips})")
                tel.instant("guard_skip", cat="guard", step=i,
                            trigger=guard.last_trigger)
                events.append({"kind": "skip", "step": i})
            if on_step is not None:
                on_step(i, params, opt, m)

            if mgr and (i + 1) % ckpt_every == 0:
                tree = snapshot()
            if mgr and can_save and (i + 1) % ckpt_every == 0:
                with busy(i):
                    ckpt_wait(i)   # surface a prior failed write first
                    mgr.save_async(i + 1, tree)
                    last_saved = i + 1
                    if chaos is not None and chaos.wants_corrupt(i + 1):
                        if ckpt_wait(i + 1):   # land it, then damage it
                            chaos.maybe_corrupt(ckpt_dir, i + 1)
            i += 1
        tree = snapshot() if mgr else None
        if mgr and can_save:
            with busy(end_step):
                final_ok = ckpt_wait(end_step)
                if last_saved != end_step or not final_ok:
                    mgr.save_async(end_step, tree)
                    ckpt_wait(end_step)
    finally:
        # teardown must never displace an in-flight ChaosKilled (exit 43 is
        # a restart harness's signal) — every item is individually
        # contained
        for teardown in (it.close,
                         lambda: drain_chaos_instants(i),
                         lambda: tel.finish(run_span, end_step=i),
                         # artifacts land even when a chaos kill unwinds
                         # the loop — the restart inspects the dead run's
                         # trace
                         lambda: trace_out and tel.write_trace(trace_out),
                         lambda: metrics_out
                         and tel.write_metrics(metrics_out),
                         lambda: exchange is not None and exchange.close(),
                         lambda: fleet is not None and fleet.dist_ok
                         and dist.destroy_process_group()):
            try:
                teardown()
            except Exception as e:
                print(f"[train] teardown error (ignored): {e!r}")
    if fleet is not None:
        with busy(end_step):
            crc = tree_fingerprint({"params": params, "opt": opt})
        fleet.write_result({
            "params_crc": crc,
            "first_loss": history[0] if history else None,
            "final_loss": history[-1] if history else None,
            "start_step": start_step, "end_step": end_step,
            "dist_ok": fleet.dist_ok,
            "device_count": n_devices,
            "process_count": n_procs,
            "device": str(dev),
        })
    return {"losses": history, "steps": step_log, "seconds": seconds,
            "metrics": metrics_log, "events": events, "params": params,
            "opt": opt, "backend": backend,
            "telemetry": tel.snapshot() if tel.enabled else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="local", choices=list(MESH_KINDS),
                    help="local: the (1, 1) mesh; single / multi: the "
                         "production meshes, one process a rank under "
                         "torchrun (module docstring)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--chaos", action="append", default=None,
                    metavar="SPEC",
                    help="inject a fault (repeatable): kill@N, nan@N, "
                         "silence@N:host=H, slow@N:host=H,factor=F, "
                         "corrupt@N:mode=flip|truncate, diskfull@N, "
                         "partition@N:host=H (sigkill@N:host=H is "
                         "supervisor-side; see "
                         "repro_torch.launch.supervisor)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1,
                    help="simulated fleet size (peers heartbeat "
                         "synthetically; host 0 is this process)")
    ap.add_argument("--hb-timeout-steps", type=float, default=None,
                    help="heartbeat timeout in virtual steps (default 4; "
                         "env REPRO_HEARTBEAT_TIMEOUT)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace JSON (perfetto-loadable) "
                         "of the RUN/REMESH/RESTORE state machine")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON")
    # -- real-fleet worker mode (passed by repro_torch.launch.supervisor) --
    ap.add_argument("--process-id", type=int, default=0, metavar="R")
    ap.add_argument("--num-processes", type=int, default=None, metavar="W",
                    help="run as rank R of a W-process fleet")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="shared dir for heartbeat files")
    ap.add_argument("--fleet-tag", type=int, default=None,
                    help="stable worker id across re-mesh renumbering")
    ap.add_argument("--stripe-ports", default=None, metavar="P0,P1,...",
                    help="per-rank TCP ports for striped restore")
    ap.add_argument("--striped-restore", action="store_true")
    ap.add_argument("--distributed", default="none",
                    choices=["none", "torch"],
                    help="'torch' also joins a process group at "
                         "--coordinator, nccl where each worker has a card "
                         "of its own, else gloo (supervision never depends "
                         "on it)")
    ap.add_argument("--result-out", default=None, metavar="PATH")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="global step horizon (restart-safe endpoint); "
                         "overrides --steps counting from the restore")
    a = ap.parse_args(argv)
    fleet = None
    if a.num_processes is not None:
        ports = tuple(int(p) for p in a.stripe_ports.split(",")) \
            if a.stripe_ports else ()
        fleet = FleetWorker(process_id=a.process_id,
                            num_processes=a.num_processes,
                            fleet_dir=a.fleet_dir, tag=a.fleet_tag,
                            coordinator=a.coordinator, stripe_ports=ports,
                            striped_restore=a.striped_restore,
                            distributed=a.distributed,
                            result_out=a.result_out)
    try:
        out = run(a.arch, smoke=a.smoke, steps=a.steps, seq_len=a.seq_len,
                  global_batch=a.global_batch, mesh_kind=a.mesh,
                  microbatches=a.microbatches,
                  lr=a.lr, log_every=a.log_every, device=a.device,
                  ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                  chaos=a.chaos, chaos_seed=a.chaos_seed,
                  n_hosts=a.n_hosts, hb_timeout_steps=a.hb_timeout_steps,
                  trace_out=a.trace_out, metrics_out=a.metrics_out,
                  total_steps=a.total_steps, fleet=fleet)
    except ChaosKilled as e:
        # ChaosKilled IS a SystemExit(43); re-raised as a plain one so
        # nothing that wrapped it on the way up changes the status
        raise SystemExit(e.code)
    losses = out["losses"]
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f}, last loss "
              f"{losses[-1]:.4f}, {len(out['events'])} fault events")
    else:
        # a restart can restore AT the horizon: nothing to do is success
        print("[train] done: horizon already reached at restore; no steps")


if __name__ == "__main__":
    main()
