"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value given."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, start: float, end: float) -> float:
    """Work completed per second over a window [start, end]."""
    if end <= start:
        raise ValueError("empty window")
    return count / (end - start)

