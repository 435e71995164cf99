"""host_syncs.grad_solve: the points a job at which the host waits for the
device, counted by the program (`host_syncs`, the delta across its
`gp.condition` and `gp.mean` spans), in the jobs profiled on the device
alone."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = (job_spans(ctx, "gp.condition") or []) + (job_spans(ctx, "gp.mean") or [])
    if not spans or not ctx.records:
        return None
    return sum(s["attrs"]["host_syncs"] for s in spans) / len(ctx.records)
