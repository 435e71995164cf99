"""precond_ms.ard_solve: `precond_ms.solve`'s reading in the ARD solve jobs."""

from gpbench.harness import spec

read = spec.load_module(spec.metric_path("precond_ms.solve"), "gpbench_metric_precond_ms_solve").read
