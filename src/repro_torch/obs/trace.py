"""Span tracer with a Chrome trace-event JSON exporter (perfetto-loadable).

A :class:`SpanTracer` records NESTED spans (context-manager, decorator, or
explicit ``begin``/``finish`` for non-lexical scopes like the train loop's
RUN segments) plus INSTANT events, on per-thread stacks so concurrent
threads (the serving tick loop vs the checkpoint writer) interleave
without corrupting each other's nesting.

The clock is injectable: ``SpanTracer(clock=lambda: vclock[0])`` lets the
train loop trace on its per-step VIRTUAL clock, so a chaos scenario
replays with bit-identical timestamps (the determinism tests compare
exported traces across replays).  The default is ``time.monotonic``.
Clocks return SECONDS; the exporter converts to the trace-event format's
microseconds.

Export follows the Chrome trace-event format that perfetto/chrome://tracing
load: a top-level ``{"traceEvents": [...]}`` object whose events carry the
required ``name``/``ph``/``ts``/``pid``/``tid`` fields — ``"X"`` complete
events additionally carry ``dur``, ``"i"`` instants carry scope ``"s":
"t"``, and per-thread ``"M"`` metadata events name the threads.  Span
``args`` pass straight through to the event's ``args`` (perfetto shows
them in the selection panel).
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable


class _SpanHandle:
    """An open span (returned by :meth:`SpanTracer.begin`)."""

    __slots__ = ("name", "cat", "t0", "tid", "args", "closed")

    def __init__(self, name: str, cat: str, t0: float, tid: int,
                 args: dict):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.tid = tid
        self.args = args
        self.closed = False


class SpanTracer:
    """Collects events; thread-safe; bounded (oldest events drop once
    ``max_events`` is hit, so a long-lived engine cannot leak without
    bound — the counter ``dropped`` says how many were lost)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 process_name: str = "repro", max_events: int = 200_000):
        self.clock = clock
        self.process_name = process_name
        self.max_events = max_events
        self.dropped = 0
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()      # per-thread span stack
        self._tids: dict[int, str] = {}      # tid -> thread name

    # -- internals ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._tids:
            with self._lock:
                self._tids[tid] = t.name
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._events.pop(0)
                self.dropped += 1
            self._events.append(ev)

    # -- recording ----------------------------------------------------------

    def begin(self, name: str, cat: str = "span", **args) -> _SpanHandle:
        """Open a span NOW; close it with :meth:`finish`.  For scopes that
        don't nest lexically (the train loop's RUN segment ends wherever
        the next fault begins)."""
        h = _SpanHandle(name, cat, self.clock(), self._tid(), args)
        self._stack().append(h)
        return h

    def finish(self, handle: _SpanHandle, **extra_args) -> None:
        """Close an open span (idempotent).  Also force-closes any spans
        opened above it on this thread's stack that were left open —
        nesting in the export stays well-formed even on early exits."""
        if handle.closed:
            return
        stack = self._stack()
        while stack:
            h = stack.pop()
            h.closed = True
            t1 = self.clock()
            args = {**h.args, **(extra_args if h is handle else {})}
            self._emit({"name": h.name, "cat": h.cat, "ph": "X",
                        "ts": h.t0, "dur": max(0.0, t1 - h.t0),
                        "tid": h.tid, "args": args})
            if h is handle:
                return
        # handle was not on this thread's stack (crossed threads): still
        # record it so the span is not silently lost
        handle.closed = True
        self._emit({"name": handle.name, "cat": handle.cat, "ph": "X",
                    "ts": handle.t0,
                    "dur": max(0.0, self.clock() - handle.t0),
                    "tid": handle.tid,
                    "args": {**handle.args, **extra_args}})

    @contextmanager
    def span(self, name: str, cat: str = "span", **args):
        h = self.begin(name, cat, **args)
        try:
            yield h
        finally:
            self.finish(h)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """A zero-duration marker (chaos faults, request completions)."""
        self._emit({"name": name, "cat": cat, "ph": "i",
                    "ts": self.clock(), "tid": self._tid(), "s": "t",
                    "args": args})

    def trace(self, name: str | None = None, cat: str = "span"):
        """Decorator form: ``@tracer.trace()`` wraps the call in a span
        named after the function."""

        def deco(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with self.span(span_name, cat):
                    return fn(*a, **kw)

            return wrapped

        return deco

    # -- introspection (tests) ----------------------------------------------

    def spans(self, name: str | None = None) -> list[dict]:
        """Completed span events (optionally filtered by name), in
        completion order, timestamps still in clock seconds."""
        with self._lock:
            evs = [e for e in self._events if e["ph"] == "X"]
        return [e for e in evs if name is None or e["name"] == name]

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """``{"traceEvents": [...]}`` in the Chrome trace-event JSON
        format (ts/dur in microseconds; pid/tid integral; "M" metadata
        events naming the process and threads)."""
        pid = os.getpid()
        out: list[dict] = [{
            "name": "process_name", "ph": "M", "ts": 0, "pid": pid,
            "tid": 0, "args": {"name": self.process_name}}]
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        for tid, tname in sorted(tids.items()):
            out.append({"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": pid, "tid": tid, "args": {"name": tname}})
        for e in events:
            ev = {"name": e["name"], "cat": e.get("cat", "span"),
                  "ph": e["ph"], "ts": e["ts"] * 1e6, "pid": pid,
                  "tid": e["tid"], "args": e.get("args", {})}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] * 1e6
            if e["ph"] == "i":
                ev["s"] = e.get("s", "t")
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        """Serialize to ``path`` (atomic tmp+rename); returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path
