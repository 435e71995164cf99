"""The arithmetic of a run: the window, percentiles, interval unions, the
idle share and the spread of a set of runs."""

from __future__ import annotations

import math
import statistics


def window_seconds(start: float, job_ends: list) -> float:
    """The window runs from its start to the end of its last job: the first
    job that ended after `--seconds`."""
    return job_ends[-1] - start


def per_job(window_s: float, jobs: int) -> float:
    """Seconds a job over the whole window and all of its jobs."""
    return window_s / jobs


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_share(intervals, lo: float, hi: float) -> float:
    """100 (1 - busy / window): the share of [lo, hi] in which nothing ran."""
    return 100.0 * (1.0 - busy(intervals, lo, hi) / (hi - lo))


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (quartiles as `statistics.quantiles(values, n=4)` gives them)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
