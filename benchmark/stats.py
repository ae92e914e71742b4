"""Arithmetic of the end-to-end metrics: percentiles, rates, spreads."""

from __future__ import annotations

import math
import statistics


def percentile(values, q):
    """The q-th percentile (0-100) of `values` by linear interpolation
    between order statistics; an infinite value (a failed request) sorts
    last.  None for an empty list."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work, seconds):
    """Work over all the window's time."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def spread(values):
    """Inter-quartile distance over the median, as statistics.quantiles
    gives the quartiles (the method the bounds are set by)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def merge_intervals(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_time(intervals, start=None, end=None):
    """Length of the union of `intervals`, clipped to [start, end]."""
    total = 0.0
    for s, e in merge_intervals(intervals):
        if start is not None:
            s = max(s, start)
        if end is not None:
            e = min(e, end)
        if e > s:
            total += e - s
    return total


def idle_gaps(intervals, start, end):
    """The (start, end) gaps in [start, end] not covered by `intervals`."""
    gaps, t = [], start
    for s, e in merge_intervals(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [g for g in gaps if g[1] > g[0]]
