"""plain_mvms.ard_solve: the lazy Gramian's products a job that took the
plain torch path on the card instead of a CUDA kernel — the program's
`mvm.plain` counter across its `gp.condition` and `gp.mean` spans, in the
jobs profiled on the device alone; None where the spans carry no such
counter (a program without it)."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = [s for name in ("gp.condition", "gp.mean") for s in job_spans(ctx, name) or []]
    if not spans or not ctx.records or any("mvm.plain" not in s["attrs"] for s in spans):
        return None
    return sum(s["attrs"]["mvm.plain"] for s in spans) / len(ctx.records)
