"""pcg_iter_ms.solve: milliseconds of the program's `solvers.cg` spans over
their iterations (`iters`), in the jobs profiled on the device alone: a
PCG iteration without the preconditioner's build, which `iter_ms.solve`
counts in."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = job_spans(ctx, "solvers.cg")
    its = sum(s["attrs"]["iters"] for s in spans or ())
    return 1e3 * sum(s["end"] - s["start"] for s in spans) / its if its else None
