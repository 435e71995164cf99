"""precond_ms.solve: milliseconds of the Nystrom preconditioner's build a
job, from the program's own `precond.nystrom` spans (`cfjax_torch.utils.
trace`) in the jobs profiled on the device alone. Also holds `job_spans`,
which the other readers of the program's spans share."""


def job_spans(ctx, name: str):
    """The program's spans named `name` whose start lies inside one of the
    records' host-clock windows (the jobs profiled on the device alone; the
    warm job and the second, host-profiled pass are left out); None where
    the program records none, or has no spans at all."""
    try:
        from cfjax_torch.utils import trace
    except ImportError:
        return None
    windows = [(r.start, r.end) for r in ctx.records]
    found = [s for s in trace.spans()
             if s["name"] == name and any(a <= s["start"] <= b for a, b in windows)]
    return found or None


def read(ctx):
    spans = job_spans(ctx, "precond.nystrom")
    if not spans or not ctx.records:
        return None
    return 1e3 * sum(s["end"] - s["start"] for s in spans) / len(ctx.records)
