"""Fault-tolerant multi-host serving fleet: router + page-ownership
directory + KV page migration + chaos-driven request recovery.

A copy of the reference package's ``repro.serving.fleet`` over the
port's engines (the port imports nothing of the reference).  Pages
MIGRATE over the mesh instead of replicating tables.  N serving engines
(one per "host", each with its own block pool, radix trie, and
scheduler) sit behind a front-end router.  A
:class:`~repro_torch.serving.prefix.PageOwnershipDirectory` — the radix
trie grown an ``owner_host`` per node — answers "which host holds this
prefix"; a request landing on a different host triggers a point-to-point
page migration over a
:class:`~repro_torch.runtime.fleet.LocalPageExchange` /
:class:`~repro_torch.runtime.fleet.TcpPageExchange` channel (CRC per
page) rather than a re-prefill.  This is the paper's FIFO-mesh
promote-local-to-global thesis at KV-page granularity: a page is computed
once, owned once, and made globally visible by MOVING it, the way a tile
result moves through the exchange mesh instead of being recomputed per
consumer.

Robustness is the headline — the router is a recovery state machine
driven by the serving chaos kinds in ``runtime/chaos.py``:

  host loss (``die@T:host=H``)
      the host's directory entries are TOMBSTONED (lookups stop at them,
      which yields recompute-from-longest-SURVIVING-ancestor for free),
      and its in-flight requests are re-admitted on survivors with
      bounded per-request retries and seeded backoff;
  migration-channel blackout (``netsplit@T:host=H,duration=D``)
      transfers raise :class:`~repro_torch.runtime.fleet.PageExchangeTimeout`
      and the router falls back to recompute — timeouts are never
      confused with corruption;
  in-flight corruption (``pagecorrupt@T``)
      the receiver's per-page CRC rejects the frame
      (:class:`~repro_torch.runtime.fleet.PageCorruptError`) and the router
      recomputes — a damaged page never enters a pool;
  stuck requests
      a dispatch in flight past ``hedge_after`` ticks gets a HEDGED twin
      on another live host; the first copy to finish wins and the loser
      is cancelled (releasing its pages).

Determinism: every engine shares one bundle + params, and a migrated
page is bit-identical to the source's KV.  In f32 greedy decoding is
batching-independent, so for every request the fleet completes its
tokens equal the single-engine baseline's, chaos or not
(``tests/test_torch_fleet.py`` holds the port to that and to the
reference's fleet).  In bf16 on a CUDA card a row's GEMM result can
depend on the batch's row count, so tokens may differ from one engine's;
what stays exact there is the migrated page, bit for bit.

:class:`LocalFleet` runs the hosts in-process (tests, the chip smoke
test — the analogue of ``LocalStripeExchange``); ``launch/serve.py
--fleet N`` runs real serve worker processes under
``runtime/supervisor.py`` with the same chaos specs delivered via
``--chaos``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any

import numpy as np

from repro_torch.obs import get_telemetry
from repro_torch.runtime.fleet import (LocalPageExchange, PageCorruptError,
                                 PageExchangeTimeout, encode_page_frame)

from .engine import ServingEngine
from .prefix import PageOwnershipDirectory

PLACEMENTS = ("affinity", "round_robin")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router policy knobs (the engines keep their own ServeConfig)."""
    max_retries: int = 3           # re-dispatches after host loss, per rid
    retry_backoff: int = 2         # base hold-off ticks (seeded jitter on top)
    hedge_after: int | None = None  # ticks in flight before a hedged twin
    migrate: bool = True           # move owned pages to the serving host
    placement: str = "affinity"    # affinity | round_robin
    seed: int = 0                  # drives the retry-backoff jitter


@dataclasses.dataclass
class _Copy:
    """One dispatch of a fleet request onto one host's engine."""
    host: int
    local_rid: int
    tick: int                      # fleet tick it was dispatched


@dataclasses.dataclass
class _Flight:
    """Router-side request state (the engines never see fleet rids)."""
    rid: int
    prompt: np.ndarray
    priority: int
    deadline: int | None
    attempts: int = 0              # death-triggered re-dispatches so far
    next_try_tick: int = 0
    copies: list[_Copy] = dataclasses.field(default_factory=list)
    hedged: bool = False
    death_tick: int | None = None  # first host loss that hit this request


class LocalFleet:
    """N in-process serving engines behind a recovering router.

    ``engines`` must share bundle + params (the determinism contract);
    each becomes one "host".  ``chaos`` is a
    :class:`~repro_torch.runtime.chaos.ChaosInjector` consulted on the FLEET's
    tick clock.  The page-exchange channel is injectable for tests; by
    default a :class:`LocalPageExchange` wired to the chaos netsplit /
    pagecorrupt hooks.
    """

    def __init__(self, engines: list[ServingEngine],
                 cfg: FleetConfig | None = None, *,
                 chaos: Any = None, exchange: Any = None,
                 telemetry: Any = None):
        if not engines:
            raise ValueError("fleet needs at least one engine")
        if any(e.cfg.kv_mode == "dense" for e in engines):
            raise ValueError("fleet hosts must run a paged kv_mode "
                             "(page migration needs a page pool)")
        self.cfg = cfg or FleetConfig()
        if self.cfg.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.cfg.placement!r} "
                             f"not in {PLACEMENTS}")
        self.engines = list(engines)
        self.alive = [True] * len(engines)
        self.chaos = chaos
        self.obs = telemetry if telemetry is not None else get_telemetry()
        self.metrics = self.obs.metrics
        page_size = engines[0].kv.cfg.page_size
        if any(e.kv.cfg.page_size != page_size for e in engines):
            raise ValueError("fleet hosts must agree on page_size")
        self.directory = PageOwnershipDirectory(page_size)
        if exchange is None:
            exchange = LocalPageExchange()
            if chaos is not None:
                exchange.blackout = \
                    lambda h: chaos.netsplit_active(self.tick, h)
                exchange.corrupt_hook = \
                    lambda: chaos.corrupt_next_page(self.tick)
        self.exchange = exchange
        self.tick = 0
        self.results: dict[int, list[int]] = {}
        self.outcomes: dict[int, str] = {}   # ok|timeout|shed|failed
        self._flights: dict[int, _Flight] = {}
        self._next_rid = 0
        self._rr = 0                         # round_robin cursor
        # counters (stats(); telemetry() absorbs them into the registry)
        self.migrations = {"ok": 0, "timeout": 0, "corrupt": 0}
        self.migrated_pages = 0
        self.retries = 0
        self.failed = 0
        self.hedges = 0
        self.deaths = 0

    # -- intake + loop surfaces ---------------------------------------------

    def submit(self, prompt_tokens, priority: int = 0,
               deadline: int | None = None) -> int:
        """Queue one request with a FLEET-scoped rid; dispatch happens on
        the next :meth:`step` (placement + migration are tick work)."""
        rid = self._next_rid
        self._next_rid += 1
        self._flights[rid] = _Flight(
            rid=rid, prompt=np.asarray(prompt_tokens, np.int32),
            priority=priority, deadline=deadline)
        return rid

    def pending(self) -> bool:
        return any(rid not in self.results for rid in self._flights)

    def run(self, *, max_ticks: int = 100_000) -> dict[int, list[int]]:
        """Drain every submitted request (completed, timed out, shed, or
        failed after the retry budget)."""
        while self.pending():
            if self.tick >= max_ticks:
                raise RuntimeError(f"fleet made no progress in "
                                   f"{max_ticks} ticks")
            self.step()
        return self.results

    def live_hosts(self) -> list[int]:
        return [h for h, a in enumerate(self.alive) if a]

    # -- the recovery state machine, one tick -------------------------------

    def step(self) -> None:
        """One fleet tick: fire host-death chaos, re-admit orphans,
        dispatch queued work (migrating owned pages to the target),
        advance every live engine one tick, harvest completions
        (first-writer-wins for hedged twins), and hedge overdue
        dispatches."""
        self.tick += 1
        if self.chaos is not None:
            for host in self.live_hosts():
                if self.chaos.should_die(self.tick, host):
                    self._kill_host(host)
        self._dispatch_queued()
        for host in self.live_hosts():
            self.engines[host].step()
        self._harvest()
        self._hedge_overdue()

    # -- host loss -----------------------------------------------------------

    def _kill_host(self, host: int) -> None:
        """Host ``host`` is gone: tombstone its directory pages, orphan
        its in-flight copies, and queue the affected requests for
        re-dispatch on survivors (the directory's tombstones make their
        next lookup stop at the longest SURVIVING ancestor)."""
        self.alive[host] = False
        self.deaths += 1
        tombs = self.directory.tombstone_host(host)
        self.metrics.counter("fleet_tombstones", tombs)
        self.metrics.counter("fleet_deaths")
        self.obs.instant("host_die", host=host, tick=self.tick,
                         tombstoned=tombs)
        for fl in self._flights.values():
            if fl.rid in self.results:
                continue
            before = len(fl.copies)
            fl.copies = [c for c in fl.copies if c.host != host]
            if before == len(fl.copies) or fl.copies:
                continue          # untouched, or a hedged twin survives
            if fl.death_tick is None:
                fl.death_tick = self.tick
            fl.attempts += 1
            if fl.attempts > self.cfg.max_retries:
                self.results[fl.rid] = []
                self.outcomes[fl.rid] = "failed"
                self.failed += 1
                self.metrics.counter("fleet_requests", outcome="failed")
                continue
            # seeded backoff: deterministic per (seed, rid, attempt) so a
            # chaos scenario replays bit-identically
            rng = random.Random(f"{self.cfg.seed}:{fl.rid}:{fl.attempts}")
            base = max(1, self.cfg.retry_backoff)
            fl.next_try_tick = self.tick + \
                base * 2 ** (fl.attempts - 1) + rng.randrange(base)
            self.retries += 1
            self.metrics.counter("fleet_retries")

    # -- placement + migration ----------------------------------------------

    def _pick_target(self, fl: _Flight, match) -> int:
        live = self.live_hosts()
        if not live:
            raise RuntimeError("fleet has no live hosts")
        if self.cfg.placement == "round_robin":
            host = live[self._rr % len(live)]
            self._rr += 1
            return host
        # affinity: land on the host already owning the longest prefix
        # run (no migration at all), else the least-loaded survivor
        if match.hit and match.owners[0] in live:
            return match.owners[0]
        return min(live, key=lambda h: (len(self.engines[h].inflight()), h))

    def _migrate(self, fl: _Flight, match, target: int) -> None:
        """Move the leading directory-owned page run to ``target`` so its
        prefill starts from transferred KV instead of recomputing it.
        Timeouts and CRC failures both degrade to recompute — the request
        itself never fails on a migration fault."""
        src = match.owners[0]
        run_tokens = 0
        for owner, seg in zip(match.owners, match.segments):
            if owner != src:
                break
            run_tokens += len(seg)
        if src == target or src not in self.live_hosts() or run_tokens == 0:
            return
        exported = self.engines[src].export_prefix_pages(
            fl.prompt, run_tokens)
        if not exported:
            return               # locally evicted since it was published
        frames = [encode_page_frame(seg, vals) for seg, vals in exported]
        sent = sum(len(f) for f in frames)
        try:
            with self.metrics.timer("fleet_migration_s"):
                decoded = self.exchange.transfer(src, target, frames)
                imported = self.engines[target].import_prefix_pages(decoded)
        except PageExchangeTimeout:
            self.migrations["timeout"] += 1
            self.metrics.counter("fleet_migrations", outcome="timeout")
            return
        except PageCorruptError:
            self.migrations["corrupt"] += 1
            self.metrics.counter("fleet_migrations", outcome="corrupt")
            return
        self.migrations["ok"] += 1
        self.migrated_pages += len(frames)
        self.metrics.counter("fleet_migrations", outcome="ok")
        self.metrics.counter("page_exchange_bytes", sent)
        self.metrics.counter("page_exchange_pages", len(frames))
        if imported:
            self.directory.transfer(fl.prompt, imported, target)
            self.engines[src].drop_prefix_path(fl.prompt, imported)
        self.obs.instant("migrate", rid=fl.rid, src=src, dst=target,
                         pages=len(frames), bytes=sent)

    def _dispatch_queued(self) -> None:
        for fl in self._flights.values():
            if fl.rid in self.results or fl.copies \
                    or fl.next_try_tick > self.tick:
                continue
            match = self.directory.lookup(fl.prompt)
            target = self._pick_target(fl, match)
            if self.cfg.migrate and match.hit:
                self._migrate(fl, match, target)
            local = self.engines[target].submit(
                fl.prompt, priority=fl.priority, deadline=fl.deadline)
            fl.copies.append(_Copy(host=target, local_rid=local,
                                   tick=self.tick))

    # -- harvest + hedging ---------------------------------------------------

    def _harvest(self) -> None:
        for fl in self._flights.values():
            if not fl.copies:
                continue
            done = [c for c in fl.copies
                    if c.local_rid in self.engines[c.host].results]
            for c in done:
                fl.copies.remove(c)
                eng = self.engines[c.host]
                outcome = eng.outcomes.get(c.local_rid, "ok")
                if outcome == "cancelled" or fl.rid in self.results:
                    continue
                self.results[fl.rid] = eng.results[c.local_rid]
                self.outcomes[fl.rid] = outcome
                self.metrics.counter("fleet_requests", outcome=outcome)
                if outcome == "ok":
                    self._publish(fl, c.host)
                if fl.death_tick is not None:
                    self.metrics.observe("fleet_recovery_ticks",
                                         self.tick - fl.death_tick)
                # retire the losing hedge twins: their pages go back now
                for twin in fl.copies:
                    if self.alive[twin.host]:
                        self.engines[twin.host].cancel(twin.local_rid)

    def _publish(self, fl: _Flight, host: int) -> None:
        """A completed request promotes its cached prefix to global
        visibility: its full pages enter the directory under the serving
        host (the engine's trie already adopted them locally).  The final
        sampled token's KV was never written, hence the ``[:-1]``."""
        out = self.results[fl.rid]
        seq = np.concatenate([fl.prompt, np.asarray(out, np.int32)]) \
            if out else fl.prompt
        self.directory.publish(seq[:-1], host)

    def _hedge_overdue(self) -> None:
        if self.cfg.hedge_after is None:
            return
        for fl in self._flights.values():
            if fl.rid in self.results or fl.hedged or len(fl.copies) != 1:
                continue
            copy = fl.copies[0]
            if self.tick - copy.tick < self.cfg.hedge_after:
                continue
            others = [h for h in self.live_hosts() if h != copy.host]
            if not others:
                continue
            host = min(others,
                       key=lambda h: (len(self.engines[h].inflight()), h))
            local = self.engines[host].submit(
                fl.prompt, priority=fl.priority, deadline=fl.deadline)
            fl.copies.append(_Copy(host=host, local_rid=local,
                                   tick=self.tick))
            fl.hedged = True
            self.hedges += 1
            self.metrics.counter("fleet_hedges")
            self.obs.instant("hedge", rid=fl.rid, slow_host=copy.host,
                             twin_host=host)

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        counts = {"ok": 0, "timeout": 0, "shed": 0, "failed": 0}
        for v in self.outcomes.values():
            counts[v] = counts.get(v, 0) + 1
        ex_bytes = getattr(self.exchange, "bytes_sent", 0)
        return {
            "ticks": self.tick,
            "hosts": len(self.engines),
            "live_hosts": len(self.live_hosts()),
            "deaths": self.deaths,
            "outcomes": counts,
            "retries": self.retries,
            "hedges": self.hedges,
            "migrations": dict(self.migrations),
            "migrated_pages": self.migrated_pages,
            "page_exchange_bytes": ex_bytes,
            "directory": self.directory.stats(),
        }

    def telemetry(self) -> dict:
        """Snapshot + mirror into the metrics registry (``fleet.*``
        gauges), same pull pattern as ``ServingEngine.telemetry``."""
        snap = self.stats()
        self.metrics.absorb(snap, prefix="fleet.")
        for host, eng in enumerate(self.engines):
            self.metrics.absorb({"alive": self.alive[host]},
                                prefix=f"fleet.host{host}.")
        return snap
