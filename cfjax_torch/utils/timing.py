"""Timing helpers (counterpart of `cfjax.utils.timing`).

CUDA work is asynchronous: a call returns when its kernels are queued, so
a host clock measures the card only around work that ends in a
synchronize. `time_chained` and `time_dispatch` time on the device their
tensors lie on, never a fallback: CUDA tensors synchronize that card, CPU
tensors take `time.perf_counter` around the call alone. `sync_time` and
`dispatch_overhead` synchronize the device they are given, by default the
configured one (`config.default_device()`).

  * `time_chained`: cfjax's slope timing, seconds per application of a
    step chained at two trip counts, the difference of the two cancelling
    the fixed cost of a run; it raises `MeasurementError` with an upper
    bound when the slope cannot be told from the spread;
  * `time_dispatch`: seconds per call of an operation that cannot be
    chained, less an empty op's launch-and-synchronize latency measured
    beside each call (`dispatch_overhead`);
  * `sync_time`: one call's wall, a synchronize on each side;
  * `event_ms`, `graph_ms`, `kernel_times` (CUDA only): one call between
    CUDA events, the wrapper's host time included; a call's device time
    from CUDA graphs; both in turns against a plain version.

cfjax's `force_sync_dispatch` works around a TPU client that returned
before its device finished; `torch.cuda.synchronize` waits for the card,
so it has no counterpart here.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


class MeasurementError(RuntimeError):
    """Raised when slope timing cannot separate an op's cost from the
    spread of its samples within the time budget. Carries an upper bound
    on the per-application cost in `.upper_bound` (seconds)."""

    def __init__(self, msg, upper_bound=None):
        super().__init__(msg)
        self.upper_bound = upper_bound


def _spread(ts):
    """Robust spread of a sample list: an interquartile range from 7
    samples up, else max - min without the single worst outlier."""
    s = sorted(ts)
    if len(s) >= 7:
        q = len(s) // 4
        return s[-1 - q] - s[q]
    if len(s) >= 3:
        return s[-2] - s[0]
    return s[-1] - s[0]


def _default_device(device):
    """`device`, else the port's configured one. The config is imported at
    use: this module also loads alone, by its path (`kernel_times.py`)."""
    from .. import config as _config

    return _config.default_device(device)


def _sync(device):
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("no tensor argument to take the device from")


def sync_time(fn, device=None):
    """(fn(), the seconds it took): a synchronize of `device` (default the
    configured one) on each side of the call, so its queued work counts."""
    device = _default_device(device)
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def time_chained(step, v0, iters=(4, 36), normalize: bool = True, repeats: int = 5,
                 delta_ratio: float = 8.0, time_budget: float = 20.0) -> float:
    """True seconds per application of `step` (v -> v of the same shape):
    runs of lo and hi chained applications from v0, interleaved, `repeats`
    each, on v0's device; (median(hi) - median(lo)) / (hi - lo) cancels
    what a run pays once. The gap of trip counts doubles until the time
    difference exceeds `delta_ratio` times the samples' spread (at least
    100 us): a slope that never escapes it raises MeasurementError with an
    upper bound, never a clamped 0. `normalize` rescales v between
    applications so that a chain cannot overflow or underflow."""
    device = v0.device

    def run(n):
        v = v0
        for _ in range(n):
            w = step(v)
            if normalize:
                w = w / (torch.linalg.norm(w.reshape(-1)) + 1e-30)
            v = w
        return v

    def sample(n):
        _sync(device)
        t0 = time.perf_counter()
        run(n)
        _sync(device)
        return time.perf_counter() - t0

    lo, hi = iters
    sample(hi)   # warm-up: the first call builds kernels and caches
    t_start = time.perf_counter()
    while True:
        ts_lo, ts_hi = [], []
        for _ in range(repeats):   # interleaved, to ride drift
            ts_lo.append(sample(lo))
            ts_hi.append(sample(hi))
        delta = statistics.median(ts_hi) - statistics.median(ts_lo)
        jitter = max(_spread(ts_lo), _spread(ts_hi), 100e-6)
        if delta > delta_ratio * jitter:
            return delta / (hi - lo)
        budget_left = time_budget - (time.perf_counter() - t_start)
        # the next round costs ~ repeats * T(2 hi); a slope still flat at
        # 4096 chained applications is below jitter / 4096 each
        if hi > 4096 or 2 * repeats * statistics.median(ts_hi) > budget_left:
            ub = max(delta, delta_ratio * jitter) / (hi - lo)
            raise MeasurementError(
                f"slope {max(delta, 0.0) / (hi - lo):.3e} s an application not separable "
                f"from jitter {jitter * 1e3:.2f} ms at hi={hi} (upper bound {ub:.3e} s)",
                upper_bound=ub)
        hi *= 2


def _noop(device):
    """An empty op on `device` and its synchronize."""
    z = torch.zeros(8, device=device)
    return lambda: (z.add_(1.0), _sync(device))


def dispatch_overhead(device=None, iters: int = 20) -> float:
    """Median seconds of an empty op's launch and synchronize on `device`
    (default the configured one): what every separately timed call pays
    beside its work."""
    noop = _noop(_default_device(device))
    noop()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        noop()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_dispatch(fn, *args, iters: int = 5, repeats: int = 2):
    """Median seconds per call of fn(*args) for an operation that cannot
    be chained, on the device of the first tensor argument:
    an empty op timed before and after each call and their mean taken off
    it. Returns (seconds, the empty ops' spread): a result below the
    spread is the launch latency's, not the operation's."""
    device = _device_of(args)
    noop = _noop(device)
    noop()
    fn(*args)
    _sync(device)
    ts, floors = [], []
    for _ in range(max(iters, repeats)):
        t0 = time.perf_counter()
        noop()
        f0 = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        t = time.perf_counter() - t0
        t0 = time.perf_counter()
        noop()
        f1 = time.perf_counter() - t0
        ts.append(t - 0.5 * (f0 + f1))
        floors += [f0, f1]
    return max(statistics.median(ts), 0.0), _spread(floors)


def event_ms(fn, reps):
    """ms of each of `reps` calls of fn between CUDA events on the current
    stream, the wrapper's host time included (a list)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def graph_ms(fn, reps=20, replays=5):
    """Device time of one call of fn: `reps` calls captured in a CUDA graph,
    the graph replayed `replays` times between CUDA events; the per-call
    times of the replays. No host time enters: the wrapper's Python runs
    once, at capture."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(replays):
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / reps)
    del g
    return ts


def kernel_times(kern, plain=None, reps=20):
    """(ms of one call between CUDA events, the wrapper's host time
    included, as the solvers' loops pay it; device ms of a call from CUDA
    graphs; ms of one plain call, None without a plain version), in turns:
    plain, call, graph, graph, call, plain; medians."""
    kern()   # warm-up
    if plain is not None:
        plain()
    t = {"plain": [], "call": [], "graph": []}
    for key in ("plain", "call", "graph", "graph", "call", "plain"):
        if key == "plain" and plain is None:
            continue
        t[key] += graph_ms(kern, reps) if key == "graph" else \
            event_ms(plain if key == "plain" else kern, 10)
    return tuple(float(np.median(t[key])) if t[key] else None
                 for key in ("call", "graph", "plain"))


def call_and_device_ms(fn, reps=10):
    """(median ms of one call between CUDA events, host time included;
    device ms of a call from CUDA graphs of 5 calls)."""
    fn()
    return float(np.median(event_ms(fn, reps))), float(np.median(graph_ms(fn, 5, 3)))
