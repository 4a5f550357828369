"""A profiled slice of a run and its reduction: the device's kernels and
busy time, the host's annotations, the longest idle gaps.

The slice runs under ``torch.profiler`` (CPU and CUDA activities) with the
harness's ``bench::`` annotations around the calls it makes, so an idle
stretch of the device can be named by what the host was doing then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .stats import gaps, union_length


@dataclasses.dataclass
class Event:
    name: str
    start: float        # seconds, the trace's own time base
    end: float


@dataclasses.dataclass
class Slice:
    """What one traced slice holds: the device's operations, the host's
    annotations and ops, the slice's own bounds, and the counts the
    runner recorded over it (``counts``)."""
    device: list[Event]
    annotations: list[Event]
    host_ops: list[Event]
    start: float
    end: float
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def clipped(self) -> list[tuple[float, float]]:
        return [(max(e.start, self.start), min(e.end, self.end))
                for e in self.device if e.end > self.start
                and e.start < self.end]

    @property
    def busy_s(self) -> float:
        return union_length(self.clipped())

    def kernel_time(self, match: Callable[[str], bool]) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        ``match`` accepts."""
        sel = [e for e in self.device if match(e.name)]
        return sum(e.end - e.start for e in sel), len(sel)

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches with no device operation, each
        named by the innermost host annotation and host op that cover its
        middle."""
        out = []
        for a, b in gaps(self.clipped(), self.start, self.end)[:n]:
            mid = (a + b) / 2
            ann = _innermost(self.annotations, mid)
            op = _innermost(self.host_ops, mid)
            label = (ann.name if ann else "outside annotations") + " / " + \
                (op.name if op else "python (no op)")
            out.append([label[:160], b - a])
        return out


def _innermost(events: list[Event], t: float) -> Event | None:
    best = None
    for e in events:
        if e.start <= t <= e.end and (best is None or e.start > best.start):
            best = e
    return best


def _kineto_events(prof) -> list[tuple[str, bool, bool, float, float]]:
    """(name, on the device, a user annotation, start s, end s) of every
    event in the profiler's kineto results."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e9, e.duration_ns() / 1e9
        else:
            s, d = e.start_us() / 1e6, e.duration_us() / 1e6
        dev = e.device_type() == DeviceType.CUDA
        ann = bool(getattr(e, "is_user_annotation", lambda: False)())
        out.append((e.name(), dev, ann, s, s + d))
    return out


def profile_slice(body: Callable[[Any], None]) -> Slice:
    """Run ``body(annotate)`` under the profiler and reduce it.
    ``annotate(name)`` is a context manager marking a host phase
    (``bench::<name>``).  The slice's bounds are its outer annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotate(name: str):
        return record_function("bench::" + name)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with annotate("slice"):
            body(annotate)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    device, anns, ops = [], [], []
    for name, dev, ann, s, e in _kineto_events(prof):
        ev = Event(name, s, e)
        if name.startswith("bench::"):
            # an annotation, on the host or mirrored on the device's row
            if not dev:
                anns.append(ev)
        elif dev:
            device.append(ev)
        elif not ann:
            ops.append(ev)
    outer = [a for a in anns if a.name == "bench::slice"]
    if not outer:
        raise RuntimeError("the profiler recorded no slice annotation")
    return Slice(device=device, annotations=anns, host_ops=ops,
                 start=outer[0].start, end=outer[0].end)
