"""One run of one cell: set-up, the window of whole jobs back to back (one
caller, closed loop), the comparison with the reference, and the result.

Set-up (`setup_s`) is everything from the launch to the first timed job:
importing the port and loading its nvcc-built libraries, making every input
from the seed, and one warm job of the cell's own shapes. The window then
runs whole jobs until one ends after `seconds`; every job ends in a
`torch.cuda.synchronize()`, as a caller reads its answer. With `trace`, the
window holds the mix's `trace_jobs` jobs twice over (or as many as
`seconds` allows): first under a profile of the device alone, each layer
call inside a span of the benchmark's own that ends in a synchronize, from
which the per-layer metrics, `busy_s` and `window_s` are read; then under a
profile of the host and the device, which only names what the host did in
the device's idle stretches (the breakdown): its host side slows a
host-paced loop by half."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import subprocess
import sys
import time
from collections import defaultdict

import torch

from . import imports, spec, stats
from .trace import JOB_SPAN, Trace


@dataclasses.dataclass
class Record:
    """One job: its host-clock start and end, its layer spans (traced runs),
    whether it failed, and what the job returned (outputs and counters)."""

    start: float
    end: float
    out: dict
    spans: dict
    failed: bool = False

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec.Cell
    records: list
    window_s: float
    setup_s: float
    trace: Trace = None


class Spans:
    """The benchmark's spans around the calls into each layer: host-clock
    seconds of each, ended by a synchronize, inside a profiler range of the
    same name; nothing at all outside a traced run."""

    def __init__(self, traced: bool, sync):
        self.traced, self.sync = traced, sync
        self.current = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function("gpbench." + name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.current[name] += time.perf_counter() - t0

    def take(self) -> dict:
        out, self.current = dict(self.current), defaultdict(float)
        return out


def card_info(device) -> dict:
    """The card's name, and its power limit and clocks from nvidia-smi
    ("not measured" where it cannot be read)."""
    info = {"kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    keys = ("power.limit", "clocks.sm", "clocks.max.sm", "temperature.gpu")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()
        index = device.index or 0
        vals = [v.strip() for v in out[index].split(",")]
        info.update({"power_limit_w": float(vals[0]), "sm_clock_mhz": float(vals[1]),
                     "max_sm_clock_mhz": float(vals[2]), "temperature_c": float(vals[3])})
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        info["power_limit_w"] = "not measured"
    return info


def jobs(job, n_jobs, seconds, spans, sync, records):
    """Whole jobs back to back until one ends after `seconds` (or `n_jobs`
    have run); returns the window's start."""
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        with torch.profiler.record_function(JOB_SPAN) if spans.traced else contextlib.nullcontext():
            out = job(i, spans)
            sync()
        end = time.perf_counter()
        records.append(Record(t, end, out, spans.take()))
        i += 1
        if end - t0 >= seconds or (n_jobs is not None and i >= n_jobs):
            return t0


@contextlib.contextmanager
def program_settings(cell: spec.Cell, device, control: dict = None):
    """The program's configuration for a run: its defaults, the card, the
    configuration's matmul tier, and `control`'s replacements (the
    control's lower-precision path); the previous one restored after."""
    import cfjax_torch

    saved = cfjax_torch.config.DEFAULT
    settings = {**dataclasses.asdict(cfjax_torch.Config()), "device": str(device),
                "matmul_precision": cell.config["precision"]["matmul_precision"]}
    cfjax_torch.set_config(**{**settings, **(control or {})})
    try:
        yield
    finally:
        cfjax_torch.config.DEFAULT = saved


def syncer(device):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return sync


def compare(cell: spec.Cell, job, records: list, seed: int) -> tuple:
    """(checks, correct): the job's compared numbers over the records that
    the seed samples (every record where the job checks them all), each
    held to the cell's limit."""
    n = min(len(records), job.check_sample(len(records)))
    sample = sorted(random.Random(seed).sample(range(len(records)), n))
    checks = job.check([records[i].out for i in sample])
    limits = cell.limits["limits"]
    answered = not any("error" in r.out for r in records)      # an answer that never came
    correct = answered and all(math.isfinite(checks[k]) and checks[k] <= limits[k]
                               for k in limits)
    return checks, correct


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_launch: float,
        log=print, control: dict = None):
    """One run of `cell`; returns the result object. `control` replaces
    settings of the program (`cfjax_torch.set_config`) for the whole run."""
    with program_settings(cell, device, control):
        return _run(cell, seed, seconds, trace, device, t_launch, log, syncer(device))


def _run(cell, seed, seconds, trace, device, t_launch, log, sync):
    job = spec.job_module(cell.job).Job(cell.config, cell.traffic, seed, device)
    log(f"route: {job.route()}")
    spans = Spans(trace, sync)
    job(0, Spans(False, sync))                      # the warm job, the cell's own shapes
    sync()
    setup_s = time.perf_counter() - t_launch

    records, attributed, tr, idle_gaps = [], [], None, None
    if trace:
        n_jobs = int(cell.traffic["trace_jobs"])
        act = torch.profiler.ProfilerActivity
        on_device = [act.CUDA] if device.type == "cuda" else []
        with torch.profiler.profile(activities=on_device or [act.CPU], acc_events=True) as prof:
            t0 = jobs(job, n_jobs, seconds / 2, spans, sync, records)
        window_s = stats.window_seconds(t0, [r.end for r in records])
        tr = Trace.device_only(Trace.events(prof)[0], window_s)
        del prof
        with torch.profiler.profile(activities=[act.CPU] + on_device, acc_events=True) as prof:
            t1 = jobs(job, n_jobs, seconds / 2, spans, sync, attributed)
        idle_gaps = Trace.from_profiler(prof).idle_by_host()
        log(f"trace: {len(records)} jobs profiled on the device alone, {window_s / len(records)!r} "
            f"s a job; {len(attributed)} with the host, "
            f"{stats.window_seconds(t1, [r.end for r in attributed]) / len(attributed)!r} s a job")
        del prof
    else:
        t0 = jobs(job, None, seconds, spans, sync, records)
        window_s = stats.window_seconds(t0, [r.end for r in records])
    for r in records + attributed:
        r.failed = job.failed(r.out)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    card = card_info(device)
    log(f"card: {card}")
    log(f"memory peak: {peak} bytes ({peak / 2**30:.3f} GiB)")

    # the comparison, once the window has closed and the peak is read; the
    # program's state is freed first, its outputs kept
    job.release()
    t_ref = time.perf_counter()
    checks, correct = compare(cell, job, records + attributed, seed)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    limits = cell.limits["limits"]

    ctx = Context(cell, records, window_s, setup_s, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card["kind"],
           "count": cell.chips, "memory_peak_bytes": peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        log(f"trace: {len(records)} jobs in {tr.window_s:.6f} s, device busy {tr.busy_s:.6f} s, "
            f"idle {tr.idle_share:.3f}%")
    done = records + attributed
    result = {"correct": correct, "attempted": len(done),
              "failed": sum(r.failed for r in done), "metrics": metrics, "device": dev,
              "card": {k: v for k, v in card.items() if k != "kind"}, "window_s": window_s,
              "setup_s": setup_s}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": idle_gaps}
    found = imports.forbidden_loaded()
    if found:
        raise imports.ForbiddenImport(found)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result


def report_checks(result, stream=sys.stderr):
    """Each compared number beside its limit, as the last lines."""
    for k, v in result["checks"].items():
        ok = "ok" if math.isfinite(v["value"]) and v["value"] <= v["limit"] else "FAILS"
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r}) {ok}", file=stream)
