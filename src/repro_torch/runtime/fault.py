"""Fault tolerance runtime: heartbeats, straggler detection, elastic re-mesh.

A copy of the reference package's ``repro.runtime.fault`` (standard
library only): the same policy, monitor and plan.  The port's
single-process train loop drives the monitor on a per-step virtual clock
for its simulated peers; it has one device, so a re-mesh re-plans the data
shards over the survivors and restores in place.

At cluster scale these hooks are driven by the coordinator (GCS / k8s / SLURM
plugin); the decision logic below is pure and unit-tested here, and the train
loop consumes it: on a failure the loop (1) stops, (2) restores the latest
checkpoint, (3) calls ``plan_elastic_remesh`` for the surviving host set,
(4) re-shards params/opt-state via checkpoint.restore(sharding_fn=...), and
(5) re-shards the data loader (ShardedLoader.reshard) — no data is lost
because the stream is indexable by step.

Straggler mitigation: hosts whose step time exceeds `straggler_factor` x the
fleet median for `patience` consecutive steps are treated as failed (evict +
elastic re-mesh) — the standard large-fleet remedy, cheaper than work
stealing for SPMD jobs where the collective pace is set by the slowest host.
"""
from __future__ import annotations

import dataclasses
import os
import time


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: list[float] = dataclasses.field(default_factory=list)
    slow_strikes: int = 0
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Eviction thresholds — note the TWO time bases, easy to confuse:

    * ``heartbeat_timeout_s`` is measured on the monitor's CLOCK — wall
      seconds under the process supervisor, but *virtual steps* (the
      train loop ticks its clock 1.0 per step) in the simulated in-loop
      fleet.  A host whose last heartbeat is older than this is dead.
    * Straggler detection is STEP-RELATIVE and clock-free: a host is
      struck when its last *reported step time* exceeds
      ``straggler_factor`` x the median of its peers' step times, and
      evicted after ``patience`` consecutive strikes.  Rescaling the
      clock changes heartbeat timeouts but never straggler verdicts.

    Env overrides (read by :meth:`from_env`, used by the train launcher
    when no explicit value is passed): ``REPRO_HEARTBEAT_TIMEOUT``
    (float, clock units), ``REPRO_STRAGGLER_FACTOR`` (float),
    ``REPRO_STRAGGLER_PATIENCE`` (int).
    """

    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 2.0
    patience: int = 5

    @classmethod
    def from_env(cls, heartbeat_timeout_s: float | None = None,
                 straggler_factor: float | None = None,
                 patience: int | None = None,
                 default: "StragglerPolicy | None" = None
                 ) -> "StragglerPolicy":
        """Resolve each field as: explicit argument > env var > ``default``
        (a policy carrying the caller's baseline; class defaults if None).
        """
        base = default if default is not None else cls()

        def pick(explicit, env_name, cast, fallback):
            if explicit is not None:
                return explicit
            raw = os.environ.get(env_name)
            return cast(raw) if raw not in (None, "") else fallback

        return cls(
            heartbeat_timeout_s=pick(heartbeat_timeout_s,
                                     "REPRO_HEARTBEAT_TIMEOUT", float,
                                     base.heartbeat_timeout_s),
            straggler_factor=pick(straggler_factor,
                                  "REPRO_STRAGGLER_FACTOR", float,
                                  base.straggler_factor),
            patience=pick(patience, "REPRO_STRAGGLER_PATIENCE", int,
                          base.patience))


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """New mesh + data shard assignment after a host-set change."""

    n_hosts: int
    data_parallel: int
    model_parallel: int
    host_ranks: dict[int, int]     # host_id -> new rank


class HeartbeatMonitor:
    def __init__(self, host_ids: list[int],
                 policy: StragglerPolicy = StragglerPolicy(),
                 clock=time.monotonic):
        self._clock = clock
        self.policy = policy
        now = clock()
        self.hosts = {h: HostState(h, now) for h in host_ids}

    def heartbeat(self, host_id: int, step_time_s: float | None = None):
        st = self.hosts[host_id]
        st.last_heartbeat = self._clock()
        if step_time_s is not None:
            st.step_times.append(step_time_s)
            if len(st.step_times) > 32:
                st.step_times.pop(0)

    def _median_step(self, exclude: int | None = None) -> float | None:
        """Fleet median of the latest step times, optionally EXCLUDING one
        host: a host must be judged against its peers, not against a
        median its own sample drags — with n=2 the self-inclusive median
        of (fast, slow) sits at the slow sample and the straggler judges
        itself normal forever."""
        times = [st.step_times[-1] for st in self.hosts.values()
                 if st.alive and st.step_times and st.host_id != exclude]
        if not times:
            return None
        times.sort()
        return times[len(times) // 2]

    def check(self) -> list[int]:
        """Returns newly-failed/evicted host ids."""
        now = self._clock()
        failed = []
        for st in self.hosts.values():
            if not st.alive:
                continue
            if now - st.last_heartbeat > self.policy.heartbeat_timeout_s:
                st.alive = False
                failed.append(st.host_id)
                continue
            med = self._median_step(exclude=st.host_id)
            if med and st.step_times and \
                    st.step_times[-1] > self.policy.straggler_factor * med:
                st.slow_strikes += 1
                if st.slow_strikes >= self.policy.patience:
                    st.alive = False
                    failed.append(st.host_id)
            else:
                st.slow_strikes = 0
        return failed

    def alive_hosts(self) -> list[int]:
        return sorted(h for h, st in self.hosts.items() if st.alive)


def plan_elastic_remesh(alive_hosts: list[int], *, chips_per_host: int,
                        model_parallel: int) -> ElasticPlan:
    """Largest usable data-parallel extent over surviving hosts.

    Keeps the model-parallel extent fixed (param shards must still fit) and
    trims data-parallel to the largest power-of-two of surviving capacity —
    surplus hosts become hot spares. Global batch is preserved by the data
    layer (each host's slice grows); per-step time grows proportionally,
    which beats a dead cluster.
    """
    n = len(alive_hosts)
    total_chips = n * chips_per_host
    assert total_chips >= model_parallel, "not enough chips for model shards"
    dp = 1
    while dp * 2 * model_parallel <= total_chips:
        dp *= 2
    used_hosts = max(1, dp * model_parallel // chips_per_host)
    ranks = {h: i for i, h in enumerate(alive_hosts[:used_hosts])}
    return ElasticPlan(n_hosts=used_hosts, data_parallel=dp,
                       model_parallel=model_parallel, host_ranks=ranks)
