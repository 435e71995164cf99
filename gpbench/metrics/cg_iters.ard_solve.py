"""cg_iters.ard_solve: `cg_iters.solve`'s reading in the ARD solve jobs."""

from gpbench.harness import spec

read = spec.load_module(spec.metric_path("cg_iters.solve"), "gpbench_metric_cg_iters_solve").read
