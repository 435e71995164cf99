"""Spans and counters of the port: where a call's time goes, layer by layer,
and how often the host waits for the device.

A span is one interval of one layer's work: its name, its start and end on
the host's clock (`time.perf_counter`), the span it ran inside (`parent`),
the id of the top-level call it belongs to (`root`, shared by every span
of that call), and attributes set when it closes: iteration counts, the
counters' deltas across it, and `sync_wait_s`, the host's time inside the
reads it timed (`item`, `cpu`, `to_device`), where it timed any. A span opened with a CUDA device also
records a pair of CUDA events on that device's current stream; their
elapsed time, `device_ms`, is resolved only when the record is read. No
span ever synchronizes.

Spans are recorded only while a `torch.profiler` session is active or
inside `recording()`. Otherwise `begin` is one flag check that returns
None and `end(None)` returns at once: no context manager is entered, no
`record_function` called, no CUDA event created and no autograd hook
registered. While recording, each span is also a `record_function` range
named `cfjax_torch.<name>`, so it sits in the profiler's own timeline, on
the device trace's clock, and the profiler's exports carry it.

The record is a bounded buffer in memory (`MAX_SPANS` spans, the oldest
dropped first): `spans()` reads it, `clear()` empties it.

Counters are plain integers. `host_syncs` is always on, as
`ops.gramian_mvm.LAUNCHES` is; `mvm.plain` counts (`count`) only while spans
are recorded: the lazy Gramian's products of CUDA tensors that took the
plain torch path instead of a CUDA kernel, so that a silent fallback shows
as a number. `host_syncs` counts the points of the solvers, the
preconditioner and the operators' diagonal shift where the host waits for
the device: each read of a tensor to the host (`item`, `cpu`) and each copy
of pageable host memory to the points' device (`to_device`), which waits
for the device's queue as a read does. It counts the points on any device; on a CUDA
device each one is a wait, and on the GP solve paths these are all of
them (a card test holds the count against
`torch.cuda.set_sync_debug_mode("warn")`). `counters()` returns them with
`LAUNCHES` under `launch.<kind>`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

MAX_SPANS = 1 << 16
PREFIX = "cfjax_torch."

COUNTERS = {"host_syncs": 0, "mvm.plain": 0}

class _Local(threading.local):
    def __init__(self):
        self.stack = []     # the spans open on this thread, innermost last


_buffer = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = _Local()
_recording = 0      # open `recording()` blocks
_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans inside the block without a profiler session."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name: str) -> None:
    """Add one to counter `name` while spans are recorded; otherwise one
    flag check."""
    if _recording or _profiling():
        COUNTERS[name] += 1


def counters() -> dict:
    """The counters' values now: this module's, and each kernel launch count
    of `ops.gramian_mvm.LAUNCHES` under `launch.<kind>`."""
    from ..ops.gramian_mvm import LAUNCHES

    out = dict(COUNTERS)
    out.update(("launch." + k, v) for k, v in LAUNCHES.items())
    return out


class Span:
    """An open span; `end` closes it and files it in the record."""

    __slots__ = ("name", "id", "parent", "root", "start", "end", "attrs", "wait_s", "_range",
                 "_events", "_device", "_before")

    def __init__(self, name: str, device=None, parent: "Span" = None, push: bool = True):
        stack = _local.stack
        up = parent if parent is not None else (stack[-1] if stack else None)
        self.name, self.id = name, next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.attrs, self.wait_s, self.end = {}, None, None
        self._before = counters()
        self._events = self._device = None
        if device is not None and torch.device(device).type == "cuda":
            self._device = torch.device(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        if push:
            stack.append(self)
        # the host clock is read just outside the profiler's range, at both
        # ends: the range's own entry and exit (15-110 us each under a CPU
        # profiler, far more on a loaded CPU) lie inside both intervals
        self._range = torch.profiler.record_function(PREFIX + name)
        self.start = time.perf_counter()
        self._range.__enter__()

    def record(self) -> dict:
        """The closed span as a plain dict (its device time resolved)."""
        if self._events is not None:
            first, last = self._events
            last.synchronize()
            self.attrs["device_ms"] = first.elapsed_time(last)
            self._events = None
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start": self.start, "end": self.end, "attrs": dict(self.attrs)}


def begin(name: str, device=None, parent: Span = None):
    """Open span `name` (a child of `parent`, else of the innermost span open
    on this thread) and return it; None, at the cost of one flag check,
    when spans are not recorded. With a CUDA `device` the span also times
    the device between two events."""
    if not (_recording or _profiling()):
        return None
    return Span(name, device, parent)


def end(span, **attrs) -> None:
    """Close `span` (None: nothing to do) with attributes `attrs`, the
    counters' deltas across it and its timed reads' wait."""
    if span is None:
        return
    stack = _local.stack
    if span in stack:
        while stack[-1] is not span:    # a child left open by an exception
            end(stack[-1])
        stack.pop()
    span._range.__exit__(None, None, None)
    span.end = time.perf_counter()
    if span._events is not None:
        span._events[1].record(torch.cuda.current_stream(span._device))
    after = counters()
    span.attrs.update((k, after[k] - v) for k, v in span._before.items()
                      if k in COUNTERS or after[k] != v)
    if span.wait_s is not None:
        span.attrs["sync_wait_s"] = span.wait_s
    span.attrs.update(attrs)
    _buffer.append(span)


def current():
    """The innermost span open on this thread, or None."""
    stack = _local.stack
    return stack[-1] if stack else None


def spans() -> list:
    """The record, oldest first, as dicts: name, id, parent, root, start,
    end, attrs. Device times are resolved here (waiting for the device to
    reach each span's last event); the record is kept."""
    return [s.record() for s in list(_buffer)]


def clear() -> None:
    _buffer.clear()


def _timed(fn, t, span):
    COUNTERS["host_syncs"] += 1
    if span is None:
        return fn(t)
    t0 = time.perf_counter()
    out = fn(t)
    span.wait_s = (span.wait_s or 0.0) + time.perf_counter() - t0
    return out


def item(t: torch.Tensor, span: Span = None):
    """`t.item()`, counted in `host_syncs`; its wait is added to `span`'s
    `sync_wait_s` when a span is given."""
    return _timed(torch.Tensor.item, t, span)


def cpu(t: torch.Tensor, span: Span = None) -> torch.Tensor:
    """`t.cpu()`, counted and timed as `item` is."""
    return _timed(torch.Tensor.cpu, t, span)


def to_device(t: torch.Tensor, device, dtype=None, span: Span = None) -> torch.Tensor:
    """`t.to(device, dtype)` for a tensor in host memory, counted and timed
    as `item` is: a copy from pageable memory waits for the device's queue."""
    return _timed(lambda a: a.to(device=device, dtype=dtype), t, span)


def backward_stages(root: Span, stages: list, ends: list) -> None:
    """Spans of the stages of a backward pass, marked by gradient hooks.
    `stages` is [(name, tensor), ...] in the order the backward reaches
    them: stage `name` starts when its tensor receives its gradient, and
    ends when the next one starts; the last ends when every tensor of
    `ends` has received its gradient, or else when the backward pass
    ends, and then the hooks are removed. Each stage is a child of `root`
    (a closed span is fine), timed on its tensor's device. Call it only
    where `begin` opened a span: the hooks are registered here, and only on
    tensors that require grad."""
    stages = [(name, t) for name, t in stages if t.requires_grad]
    ends = [t for t in ends if t.requires_grad]
    state = {"open": None, "ends": 0, "handles": []}

    def leave(last=False):
        sp, state["open"] = state["open"], None
        end(sp)
        if last:
            for h in state["handles"]:
                h.remove()
            state["handles"] = []

    def starter(name, device, last):
        def hook(grad):
            leave()
            state["open"] = Span(name, device, root, push=False)
            if last:        # closes the stage if no tensor of `ends` gets a gradient
                torch.autograd.Variable._execution_engine.queue_callback(
                    lambda: leave(last=True))
        return hook

    def ender(grad):
        state["ends"] += 1
        if state["ends"] == len(ends):
            leave(last=True)

    for i, (name, t) in enumerate(stages):
        state["handles"].append(t.register_hook(starter(name, t.device, i == len(stages) - 1)))
    state["handles"] += [t.register_hook(ender) for t in ends]
