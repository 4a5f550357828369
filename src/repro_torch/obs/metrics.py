"""Metrics registry: labeled counters / gauges / histograms, host-only.

One process-wide :data:`REGISTRY` absorbs the repo's scattered ad-hoc
stats (serving outcome counters, ``BlockPoolKV`` alloc/evict counts,
autotune cache hits, GradGuard skip/rollback events, chaos fired events,
checkpoint save/restore/CRC timings) into a single snapshot-to-dict
surface.  Components PUSH events as they happen (counters/histograms) and
the snapshot layer PULLS point-in-time component stats into gauges (e.g.
``engine.telemetry()`` mirrors pool utilization and prefix hit rate), so
nothing in a hot loop ever formats a string or touches a device.

Design constraints, in order:

* **host-only + import-light** — imported by host-side control modules
  (``serving.kv``, ``core.autotune``, ``checkpoint.manager``) that must
  stay property-testable in microseconds;
* **thread-safe** — the checkpoint manager records save timings from its
  background writer thread while the train loop records step events; one
  lock around dict updates, never held during user code;
* **deterministic snapshots** — metric keys are sorted and label values
  are rendered canonically, so two runs that perform the same work
  produce byte-identical ``snapshot()["counters"]`` (the chaos
  virtual-clock replay test depends on this).

Series identity is ``(name, ((label, value), ...))`` with labels sorted;
the snapshot renders it as the Prometheus-style string
``name{k=v,k2=v2}`` (bare ``name`` with no labels).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterable, Mapping

_QUANTILES = (0.5, 0.9, 0.99)


def _series_key(name: str, labels: Mapping[str, Any]) -> tuple:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _render(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class _Hist:
    """Streaming histogram: count/sum/min/max plus a bounded reservoir of
    recent observations for approximate quantiles (exact until ``cap``)."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples", "cap", "_i")

    def __init__(self, cap: int = 512):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: list[float] = []
        self.cap = cap
        self._i = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < self.cap:
            self.samples.append(v)
        else:                       # ring overwrite: keep the newest window
            self.samples[self._i % self.cap] = v
            self._i += 1

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin if self.count else 0.0,
               "max": self.vmax if self.count else 0.0,
               "mean": self.total / self.count if self.count else 0.0}
        if self.samples:
            s = sorted(self.samples)
            for q in _QUANTILES:
                out[f"p{int(q * 100)}"] = s[
                    min(len(s) - 1, int(q * len(s)))]
        return out


class MetricsRegistry:
    """Thread-safe labeled counters / gauges / histograms.

    >>> m = MetricsRegistry()
    >>> m.counter("serve_tokens", 8, mode="paged")
    >>> m.gauge("kv_utilization", 0.83)
    >>> m.observe("ckpt_save_s", 0.12)
    >>> m.snapshot()["counters"]["serve_tokens{mode=paged}"]
    8
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, _Hist] = {}

    # -- write side ---------------------------------------------------------

    def counter(self, name: str, value: float = 1, **labels) -> None:
        """Add ``value`` (monotone; negative increments are a caller bug
        but not policed — snapshots stay truthful to what was recorded)."""
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a point-in-time value (last write wins)."""
        key = _series_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram observation."""
        key = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(value)

    @contextlib.contextmanager
    def timer(self, name: str, **labels):
        """Time a ``with`` block into histogram ``name`` (seconds) — the
        fleet wraps page migrations and host-loss recovery in these."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, **labels)

    def absorb(self, stats: Mapping[str, Any], *, prefix: str = "",
               **labels) -> None:
        """Mirror a component's ad-hoc stats dict as gauges (the pull
        half: ``engine.telemetry()`` feeds kv/prefix/outcome stats here).
        Non-numeric values are skipped; nested dicts are flattened with
        ``.`` separators."""
        flat: list[tuple[str, float]] = []

        def walk(d: Mapping[str, Any], base: str) -> None:
            for k, v in d.items():
                if isinstance(v, Mapping):
                    walk(v, f"{base}{k}.")
                elif isinstance(v, bool):
                    flat.append((f"{base}{k}", float(v)))
                elif isinstance(v, (int, float)):
                    flat.append((f"{base}{k}", float(v)))

        walk(stats, prefix)
        for k, v in flat:
            self.gauge(k, v, **labels)

    # -- read side ----------------------------------------------------------

    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(_series_key(name, labels), 0)

    def snapshot(self) -> dict:
        """Deterministically-ordered dict of every series.

        ``counters`` holds only deliberately-recorded monotone event
        counts — the section replay-determinism tests compare; ``gauges``
        and ``histograms`` may carry wall-clock-derived values."""
        with self._lock:
            counters = {_render(k): v
                        for k, v in sorted(self._counters.items())}
            gauges = {_render(k): v
                      for k, v in sorted(self._gauges.items())}
            hists = {_render(k): h.summary()
                     for k, h in sorted(self._hists.items())}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def reset(self, names: Iterable[str] | None = None) -> None:
        """Drop every series, or only those whose NAME is in ``names``."""
        with self._lock:
            if names is None:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
                return
            keep = lambda k: k[0] not in names  # noqa: E731
            self._counters = {k: v for k, v in self._counters.items()
                              if keep(k)}
            self._gauges = {k: v for k, v in self._gauges.items()
                            if keep(k)}
            self._hists = {k: v for k, v in self._hists.items() if keep(k)}


# The process-wide default.  Always live (recording a counter is a dict
# add under a lock — cheap enough for the rare events pushed here: kernel
# trace-time dispatches, checkpoint saves, GradGuard actions, autotune
# cache misses).  Hot-loop per-tick recording is additionally gated on
# ``Telemetry.enabled`` by the components that do it.
REGISTRY = MetricsRegistry()
