"""sync_wait_ms.grad_solve: milliseconds a CG iteration that the host waits
in the convergence reads of the program's `solvers.cg` spans
(`sync_wait_s` over `iters`), in the jobs profiled on the device alone."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = job_spans(ctx, "solvers.cg")
    its = sum(s["attrs"]["iters"] for s in spans or ())
    if not its:
        return None
    return 1e3 * sum(s["attrs"].get("sync_wait_s", 0.0) for s in spans) / its
