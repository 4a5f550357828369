"""Statistics of a run: tails over all samples, rates over whole windows,
busy time as the union of intervals."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ALL
    ``values``: the smallest value with at least q% of the samples at or
    below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no samples")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])


def rate(count: float, seconds: float) -> float:
    """``count`` over the whole window's ``seconds``."""
    if seconds <= 0:
        raise ValueError("a rate over an empty window")
    return count / seconds


def union_length(spans) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once (the device's busy time from its kernels' intervals)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans, start: float, end: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [start, end] that no interval
    covers, longest first."""
    out, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    out = [(a, b) for a, b in out if b > a]
    return sorted(out, key=lambda g: g[0] - g[1])
