"""The traced run's profiles, reduced: the device's intervals with their
names, the main thread's host events, and the window of the profiled jobs,
all in microseconds of the profiler's clock.

A traced run profiles its jobs twice. `Trace.device_only` reads a profile
that recorded the device alone, over a window timed by the host's clock:
the busy time, the idle share and the kernels' times, at a small cost to
the host. `Trace.from_profiler` reads a profile of the host and the device
together, whose host events name what the host did in each idle stretch;
its host side slows a host-paced loop, so its idle time is the breakdown's
and no metric's. The reductions work on plain (start, end, name) tuples,
so they are tested on synthetic intervals."""

from __future__ import annotations

import re
from collections import defaultdict

from . import stats

JOB_SPAN = "gpbench.job"


class Trace:
    def __init__(self, device, host, jobs):
        """device: (start, end, name) of each kernel, copy and set on the
        device; host: (start, end, name) of the main thread's events;
        jobs: (start, end) of each profiled job."""
        self.device = sorted(device)
        self.host = sorted(host)
        self.jobs = sorted(jobs)
        self.lo = self.jobs[0][0]
        self.hi = max(e for _, e in self.jobs)

    @classmethod
    def device_only(cls, device, window_s: float):
        """The device's intervals over a window of `window_s` seconds (host
        clock) that holds them all; the window starts at the first one."""
        lo = min((s for s, _, _ in device), default=0.0)
        return cls(device, [], [(lo, lo + window_s * 1e6)])

    @staticmethod
    def events(prof):
        """(device, cpu): (start, end, name) of each kernel, copy and set on
        the device, and (start, end, name, thread) of each host event."""
        from torch.autograd import DeviceType

        device, cpu = [], []
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False) and not e.name.startswith("gpbench."):
                    device.append((s, t, e.name))
            elif not e.is_async:
                cpu.append((s, t, e.name, e.thread))
        return device, cpu

    @classmethod
    def from_profiler(cls, prof):
        device, cpu = cls.events(prof)
        jobs = [(s, t, th) for s, t, name, th in cpu if name == JOB_SPAN]
        if not jobs:
            raise RuntimeError("the profile holds no job span")
        main = jobs[0][2]
        host = [(s, t, name) for s, t, name, th in cpu if th == main]
        return cls(device, host, [(s, t) for s, t, _ in jobs])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def _spans(self):
        return [(s, e) for s, e, _ in self.device]

    @property
    def busy_s(self) -> float:
        """Seconds in which the device ran something, inside the window."""
        return stats.busy(self._spans(), self.lo, self.hi) * 1e-6

    @property
    def idle_share(self) -> float:
        return stats.idle_share(self._spans(), self.lo, self.hi)

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the operations whose names match any pattern
        (`re.search`), inside the window."""
        rx = [re.compile(p) for p in patterns]
        return sum(min(e, self.hi) - max(s, self.lo) for s, e, name in self.device
                   if e > self.lo and s < self.hi and any(r.search(name) for r in rx)) * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the k device operations that took most time."""
        tot = defaultdict(float)
        for s, e, name in self.device:
            if e > self.lo and s < self.hi:
                tot[name] += (min(e, self.hi) - max(s, self.lo)) * 1e-6
        return [[name[:160], sec] for name, sec in sorted(tot.items(), key=lambda t: -t[1])[:k]]

    def idle_by_host(self, k: int = 10) -> list:
        """[host activity, seconds]: the device's idle time inside the
        window, by the innermost event of the main thread that ran at the
        middle of each idle stretch ("-" where none did), the k largest."""
        gaps = stats.gaps(self._spans(), self.lo, self.hi)
        tot = defaultdict(float)
        stack, i = [], 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (g0 + g1)
            while i < len(self.host) and self.host[i][0] <= mid:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            tot[stack[-1][2] if stack else "-"] += (g1 - g0) * 1e-6
        return [[name[:160], sec] for name, sec in sorted(tot.items(), key=lambda t: -t[1])[:k]]
