"""cg_frozen.solve: CG steps a job run after the residual met the tolerance
(the program's `solvers.cg` spans' `frozen`: steps of a block past the
converged iteration, which change nothing), in the jobs profiled on the
device alone; None where the spans carry no `frozen` (a program whose CG
reads the residual every iteration)."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = job_spans(ctx, "solvers.cg")
    if not spans or not ctx.records or any("frozen" not in s["attrs"] for s in spans):
        return None
    return sum(s["attrs"]["frozen"] for s in spans) / len(ctx.records)
