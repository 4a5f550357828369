"""Deterministic, seedable fault injection for the pod runtime.

A numpy-only copy of the reference package's ``repro.runtime.chaos``: the
same specs, defaults and decisions (the port imports nothing of the
reference).  The port's single-process train loop
(``repro_torch.launch.train``) consults the training kinds; the serving
fleet and the process supervisor that consume the other kinds are not
ported yet.

The recovery paths in this repo (checkpoint fallback, elastic re-mesh,
nonfinite-grad skip) are only trustworthy if they are EXERCISED — a
recovery path that has never run is a second bug waiting behind the first.
This module injects the failures the training and serving stacks will
actually see, as a pure function of (spec, step, seed), so every chaos
scenario replays bit-identically in tests and CI.

Fault taxonomy (spec strings, parsed by :func:`parse_chaos`):

  ``kill@N``                       process death entering step N — raises
                                   :class:`ChaosKilled` (a ``SystemExit``
                                   with exit code 43, so ``--chaos kill@N``
                                   kills the launcher like a real preempt)
  ``silence@N:host=H,duration=D``  host H's heartbeats go dark for D steps
                                   starting at N (default: forever) — the
                                   monitor must evict it and the loop must
                                   re-mesh over the survivors
  ``slow@N:host=H,factor=F,duration=D``
                                   host H reports step times inflated by F
                                   (straggler; default forever) — the
                                   monitor's straggler logic must evict it
  ``nan@N:duration=D``             grads are scaled by NaN for D steps
                                   (default 1) starting at N — the train
                                   step's finite guard must skip the update
  ``corrupt@N:mode=flip|truncate,host=H``
                                   the checkpoint saved at train step N is
                                   corrupted on disk right after it lands
                                   (one flipped byte, or the shard cut in
                                   half) — restore must detect it by CRC
                                   and fall back to an older intact step

Serving-fleet faults (the multi-host serving fleet; see the reference's
``repro.serving.fleet``, tick-indexed on the FLEET's tick clock):

  ``die@T:host=H``                 serving host H dies entering fleet tick
                                   T — the router must tombstone its
                                   directory entries and re-admit its
                                   in-flight requests on survivors
                                   (worker mode: raises ChaosKilled so a
                                   real serve process exits 43 and the
                                   supervisor restarts it)
  ``netsplit@T:host=H,duration=D`` the page-migration channel to/from
                                   host H is black for D ticks starting
                                   at T — migrations raise
                                   PageExchangeTimeout and the router
                                   must fall back to prefix recompute
  ``pagecorrupt@T``                the next migrated KV page at tick >= T
                                   arrives with a flipped byte — the
                                   receiver's per-page CRC must reject it
                                   (PageCorruptError) and recompute

Process-level faults (the real-fleet runtime; see the reference's
``repro.runtime.supervisor``):

  ``sigkill@N:host=H``             SUPERVISOR-side: SIGKILL worker H once
                                   its heartbeat reports step >= N — an
                                   uncatchable death (no grace, no atexit)
                                   exercising the crash-restart path as a
                                   kernel would deliver it
  ``partition@N:host=H,duration=D``
                                   worker H stops publishing heartbeats
                                   for D steps starting at N (coordinator
                                   partition) — the supervisor's hang
                                   detector must SIGKILL + restart it
  ``diskfull@N``                   the checkpoint write at train step N
                                   fails with ENOSPC — training must log
                                   the failed save and CONTINUE (a full
                                   disk costs recovery-point age, never
                                   the run)

``kill``/``sigkill``/``partition`` specs target host 1 by default (host 0
writes the checkpoint manifests; drilling a non-primary is the common
case) — in the single-process simulated fleet ``kill`` fires regardless
of target because the only real process IS every host.

Usage::

    with ChaosInjector(["kill@12", "nan@5"], seed=0) as chaos:
        train.run(..., chaos=chaos)

or from the CLI: ``python -m repro_torch.launch.train --arch qwen3-4b \
--chaos kill@12 --chaos nan@5``.  The injector records every fault it
fires in ``.fired`` so tests can assert the scenario actually happened.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

# SystemExit code for an injected kill: distinguishable from crashes (1)
# and clean exits (0) so restart harnesses can tell "chaos killed me" apart
# from "I am broken".
KILL_EXIT_CODE = 43

KINDS = ("kill", "silence", "slow", "nan", "corrupt",
         "sigkill", "partition", "diskfull",
         "die", "netsplit", "pagecorrupt")

# Kinds the process supervisor applies itself (everything else is handed
# through to the worker processes' --chaos flags).
SUPERVISOR_KINDS = ("sigkill",)

# How long a fault stays active when the spec gives no duration: a NaN
# burst is one step, but silence/slowness persist until eviction.
_FOREVER = 1 << 30
_DEFAULT_DURATION = {"kill": 1, "silence": _FOREVER, "slow": _FOREVER,
                     "nan": 1, "corrupt": 1, "sigkill": 1,
                     "partition": _FOREVER, "diskfull": 1,
                     "die": 1, "netsplit": 4, "pagecorrupt": 1}


class ChaosKilled(SystemExit):
    """Injected process death. Subclasses SystemExit so an unhandled kill
    exits the interpreter with :data:`KILL_EXIT_CODE`; tests catch it."""

    def __init__(self, step: int):
        super().__init__(KILL_EXIT_CODE)
        self.step = step

    def __str__(self) -> str:  # SystemExit.__str__ would print "43"
        return f"chaos: killed at step {self.step}"


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    kind: str                    # one of KINDS
    step: int                    # first step the fault is active
    host: int = -1               # target host (silence/slow) or shard
    #                              (corrupt); -1 -> host 1 / shard 0
    duration: int = 0            # steps active; 0 -> per-kind default
    factor: float = 4.0          # step-time inflation (slow)
    mode: str = "flip"           # corrupt: flip | truncate

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.duration == 0:
            object.__setattr__(self, "duration",
                               _DEFAULT_DURATION[self.kind])
        if self.host < 0:
            # silence/slow/kill/sigkill/partition/die/netsplit target a
            # PEER by default (host 0 is "us" / the manifest writer /
            # the serving fleet's first host); corrupt targets our own
            # shard 0, diskfull our own writer, pagecorrupt the channel
            object.__setattr__(self, "host",
                               0 if self.kind in ("corrupt", "diskfull",
                                                  "pagecorrupt")
                               else 1)

    def active(self, step: int) -> bool:
        return self.step <= step < self.step + self.duration


def parse_chaos(text: str) -> ChaosSpec:
    """``kind@step[:k=v,...]`` -> ChaosSpec (see module docstring)."""
    kind, sep, rest = text.partition("@")
    if not sep or not rest:
        raise ValueError(f"chaos spec {text!r}: expected 'kind@step[:opts]'")
    step_s, _, opts = rest.partition(":")
    kw: dict = {"kind": kind.strip(), "step": int(step_s)}
    for pair in filter(None, opts.split(",")):
        k, sep, v = pair.partition("=")
        if not sep:
            raise ValueError(f"chaos spec {text!r}: bad option {pair!r}")
        k = k.strip()
        if k in ("host", "duration"):
            kw[k] = int(v)
        elif k == "factor":
            kw[k] = float(v)
        elif k == "mode":
            kw[k] = v.strip()
        else:
            raise ValueError(f"chaos spec {text!r}: unknown option {k!r}")
    return ChaosSpec(**kw)


def split_spec_strings(specs) -> tuple[list[str], list[str]]:
    """Partition raw ``--chaos`` strings into (supervisor-side,
    worker-side) halves; the supervisor keeps ``sigkill`` for itself and
    forwards the rest to the worker processes' own ``--chaos`` flags."""
    sup, wrk = [], []
    for s in specs:
        (sup if parse_chaos(s).kind in SUPERVISOR_KINDS else wrk).append(s)
    return sup, wrk


def corrupt_checkpoint(ckpt_dir: str, step: int, *, host_id: int = 0,
                       mode: str = "flip", seed: int = 0) -> str:
    """Damage the shard ``host_id`` of checkpoint ``step`` on disk.

    ``flip`` XORs one byte in the middle third of the file (the CRC in the
    commit marker no longer matches); ``truncate`` cuts the file in half
    (np.load would die even without the CRC).  Returns the damaged path.
    """
    shard = os.path.join(ckpt_dir, f"step_{step:08d}",
                         f"shard_{host_id}.npz")
    size = os.path.getsize(shard)
    if mode == "truncate":
        with open(shard, "r+b") as f:
            f.truncate(size // 2)
    elif mode == "flip":
        rng = np.random.default_rng(seed)
        off = int(rng.integers(size // 3, 2 * size // 3))
        with open(shard, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    return shard


class ChaosInjector:
    """Consulted by the train loop at its fault points; pure host state.

    Every query is a deterministic function of (specs, step, seed); the
    injector never holds clocks or randomness that would make a scenario
    unrepeatable.  ``fired`` logs each event once, in firing order.
    """

    def __init__(self, specs=(), *, seed: int = 0):
        self.specs = [parse_chaos(s) if isinstance(s, str) else s
                      for s in specs]
        self.seed = seed
        self.fired: list[str] = []

    # -- context manager (tests) -------------------------------------------

    def __enter__(self) -> "ChaosInjector":
        return self

    def __exit__(self, *exc) -> None:
        return None

    # -- internals ----------------------------------------------------------

    def _log(self, event: str) -> None:
        if event not in self.fired:
            self.fired.append(event)

    def _active(self, kind: str, step: int):
        return (sp for sp in self.specs
                if sp.kind == kind and sp.active(step))

    # -- fault points (one per taxonomy row) --------------------------------

    def maybe_kill(self, step: int, rank: int | None = None) -> None:
        """Raise :class:`ChaosKilled` when a kill spec is active.

        ``rank=None`` (the single-process simulated fleet) dies on ANY
        active kill — the one real process is every host.  A real fleet
        worker passes its rank and dies only when targeted (``host=``
        defaults to 1, a peer of the manifest-writing rank 0)."""
        for sp in self._active("kill", step):
            if rank is not None and sp.host != rank:
                continue
            self._log(f"kill@{step}")
            raise ChaosKilled(step)

    def partitioned(self, step: int, rank: int) -> bool:
        """True while ``rank`` must suppress its heartbeats (coordinator
        partition); the supervisor's hang detector takes it from there."""
        for sp in self._active("partition", step):
            if sp.host == rank:
                self._log(f"partition@{sp.step}:host={rank}")
                return True
        return False

    def checkpoint_write_hook(self, saved_step: int) -> None:
        """Installed as ``CheckpointManager(fault_hook=...)``: fails the
        write of step ``saved_step`` with ENOSPC when a diskfull spec
        targets it.  Runs on the manager's background writer thread; the
        error surfaces at the train loop's next ``wait()``."""
        import errno
        for sp in self.specs:
            if sp.kind == "diskfull" and sp.step == saved_step:
                self._log(f"diskfull@{saved_step}")
                raise OSError(errno.ENOSPC,
                              f"chaos: disk full writing checkpoint step "
                              f"{saved_step}")

    def supervisor_specs(self) -> list[ChaosSpec]:
        return [sp for sp in self.specs if sp.kind in SUPERVISOR_KINDS]

    def heartbeat_silenced(self, host: int, step: int) -> bool:
        for sp in self._active("silence", step):
            if sp.host == host:
                self._log(f"silence@{sp.step}:host={host}")
                return True
        return False

    def step_time_factor(self, host: int, step: int) -> float:
        f = 1.0
        for sp in self._active("slow", step):
            if sp.host == host:
                self._log(f"slow@{sp.step}:host={host}")
                f *= sp.factor
        return f

    def grad_scale(self, step: int) -> float:
        for sp in self._active("nan", step):
            self._log(f"nan@{step}")
            return float("nan")
        return 1.0

    def wants_corrupt(self, saved_step: int) -> bool:
        return any(sp.step == saved_step for sp in self.specs
                   if sp.kind == "corrupt")

    def maybe_corrupt(self, ckpt_dir: str, saved_step: int) -> None:
        """Called by the train loop right after checkpoint ``saved_step``
        is fully on disk (the loop waits for the async save first)."""
        for sp in self.specs:
            if sp.kind == "corrupt" and sp.step == saved_step:
                corrupt_checkpoint(ckpt_dir, saved_step, host_id=sp.host,
                                   mode=sp.mode, seed=self.seed)
                self._log(f"corrupt@{saved_step}:mode={sp.mode}")

    # -- serving-fleet fault points (fleet tick clock) ----------------------

    def should_die(self, tick: int, host: int) -> bool:
        """True exactly when serving host ``host`` must die entering fleet
        tick ``tick`` (the router's view: it marks the host dead and starts
        recovery).  Unlike ``maybe_kill`` this never raises — the in-process
        LocalFleet has no process to kill, only an engine to drop."""
        for sp in self._active("die", tick):
            if sp.host == host:
                self._log(f"die@{sp.step}:host={host}")
                return True
        return False

    def maybe_die(self, tick: int, host: int) -> None:
        """Worker-process flavour of ``should_die``: raises ChaosKilled so
        a real serve worker exits with :data:`KILL_EXIT_CODE` and the
        supervisor's restart policy takes over."""
        if self.should_die(tick, host):
            raise ChaosKilled(tick)

    def netsplit_active(self, tick: int, host: int) -> bool:
        """True while the page-migration channel to/from ``host`` is black
        (netsplit window).  The PageExchange consults this on both send and
        receive so a migration across the split times out symmetrically."""
        for sp in self._active("netsplit", tick):
            if sp.host == host:
                self._log(f"netsplit@{sp.step}:host={host}")
                return True
        return False

    def corrupt_next_page(self, tick: int) -> bool:
        """True ONCE per pagecorrupt spec, the first time it is consulted
        at tick >= the spec's step: the next migrated page frame gets one
        byte flipped in flight, and the receiver's CRC must catch it."""
        for sp in self.specs:
            if sp.kind != "pagecorrupt" or tick < sp.step:
                continue
            event = f"pagecorrupt@{sp.step}"
            if event not in self.fired:
                self.fired.append(event)
                return True
        return False
