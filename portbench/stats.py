"""The arithmetic the metric readers share: percentiles of host times, and
the busy and idle time of a device from its operations' intervals."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between the closest
    ranks (numpy's default): the tail of every value given."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: list[tuple[float, float]], lo: float = -math.inf, hi: float = math.inf
          ) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, clipped to [lo, hi], as disjoint
    sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """The time within [lo, hi] that at least one interval covers."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
