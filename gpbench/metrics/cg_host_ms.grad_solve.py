"""cg_host_ms.grad_solve: the host's own milliseconds a CG iteration — the
program's `solvers.cg` spans less the wait inside their convergence reads
(`sync_wait_s`), over their iterations — in the jobs profiled on the
device alone: Python and kernel launches, not waiting for the card."""

from gpbench.harness import spec

job_spans = spec.load_module(spec.metric_path("precond_ms.solve"),
                             "gpbench_metric_precond_ms_solve").job_spans


def read(ctx):
    spans = job_spans(ctx, "solvers.cg")
    its = sum(s["attrs"]["iters"] for s in spans or ())
    if not its:
        return None
    own = sum(s["end"] - s["start"] - s["attrs"].get("sync_wait_s", 0.0) for s in spans)
    return 1e3 * own / its
