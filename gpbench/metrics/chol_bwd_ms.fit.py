"""chol_bwd_ms.fit: milliseconds of the Cholesky factor's backward a step,
from the program's `gp.logml.cholesky.bwd` spans (marked by gradient hooks
on A and L), in the steps profiled on the device alone: on a card the
device's time between the span's two CUDA events (`device_ms`); on the
CPU, whose autograd runs in the host's own time, the span's duration."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = job_spans(ctx, "gp.logml.cholesky.bwd") or []
    ms = [s["attrs"].get("device_ms", 1e3 * (s["end"] - s["start"])) for s in spans]
    return sum(ms) / len(ms) if ms else None
