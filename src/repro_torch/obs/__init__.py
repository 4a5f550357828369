"""Unified telemetry: metrics registry + span tracer + traffic accounting.

Three layers, as the reference package's ``repro.obs``:

1. :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms with one
   process-wide :data:`~repro_torch.obs.metrics.REGISTRY` that absorbs the
   repo's scattered ad-hoc stats;
2. :mod:`repro_torch.obs.trace` — nested span tracer (virtual-clock compatible)
   with a Chrome trace-event JSON exporter perfetto can load;
3. :mod:`repro_torch.obs.roofline_live` — observed-vs-predicted traffic rows
   (the serving engine's KV traffic counters, the op cost counter's flops
   and bytes of a kernel call) against their analytic predictions;

The :class:`Telemetry` facade bundles a tracer with the registry and a
single ``enabled`` switch.  The GLOBAL default is DISABLED: hot paths
(the serving tick loop) check ``telemetry.enabled`` once and skip every
span/counter, so an untelemetered serve pays only a handful of attribute
reads per tick (< 2% tick time — asserted by the smoke benchmark).
``obs.enable()`` flips the global on (the launchers do this when
``--trace-out``/``--metrics-out`` is passed); components that cannot be
handed a Telemetry explicitly (kernel wrappers, checkpoint manager) reach
it through :func:`get_telemetry`.

The package imports no tensor library (``roofline_live`` imports torch
only inside the functions that run a kernel), so the host-side control
modules that import it stay import-light too.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Callable

from .metrics import REGISTRY, MetricsRegistry
from .trace import SpanTracer


@contextmanager
def _noop_span(*_a, **_kw):
    yield None


class Telemetry:
    """A tracer + the metrics registry behind one enabled/disabled switch.

    ``span``/``instant`` delegate to the tracer when enabled and are
    no-ops otherwise; ``metrics`` is always the (cheap, ever-live)
    registry — components use ``telemetry.enabled`` to gate per-tick
    hot-loop recording and push rare events unconditionally.
    """

    def __init__(self, *, enabled: bool = True,
                 registry: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 process_name: str = "repro"):
        self.enabled = enabled
        self.metrics = registry if registry is not None else REGISTRY
        self.tracer = SpanTracer(clock, process_name=process_name)

    # -- recording (gated) --------------------------------------------------

    def span(self, name: str, cat: str = "span", **args):
        if not self.enabled:
            return _noop_span()
        return self.tracer.span(name, cat, **args)

    def begin(self, name: str, cat: str = "span", **args):
        return self.tracer.begin(name, cat, **args) if self.enabled else None

    def finish(self, handle, **extra) -> None:
        if handle is not None:
            self.tracer.finish(handle, **extra)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        if self.enabled:
            self.tracer.instant(name, cat, **args)

    def counter(self, name: str, value: float = 1, **labels) -> None:
        if self.enabled:
            self.metrics.counter(name, value, **labels)

    # -- artifacts ----------------------------------------------------------

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def write_trace(self, path: str) -> str:
        return self.tracer.write_chrome_trace(path)

    def write_metrics(self, path: str, extra: dict[str, Any] | None = None
                      ) -> str:
        """Write ``snapshot()`` (plus optional caller context) as JSON."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        snap = self.snapshot()
        if extra:
            snap = {**snap, **extra}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
        return path


_DISABLED = Telemetry(enabled=False)
_default: Telemetry = _DISABLED


def get_telemetry() -> Telemetry:
    """The process-global telemetry (disabled until :func:`enable`)."""
    return _default


def set_telemetry(t: Telemetry | None) -> Telemetry:
    """Install ``t`` as the global (None restores the disabled default);
    returns the previous one so scopes can put it back."""
    global _default
    prev = _default
    _default = t if t is not None else _DISABLED
    return prev


def enable(*, clock: Callable[[], float] = time.monotonic,
           process_name: str = "repro") -> Telemetry:
    """Install and return a fresh ENABLED global telemetry."""
    t = Telemetry(enabled=True, clock=clock, process_name=process_name)
    set_telemetry(t)
    return t


__all__ = ["REGISTRY", "MetricsRegistry", "SpanTracer", "Telemetry",
           "enable", "get_telemetry", "set_telemetry"]
