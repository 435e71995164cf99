"""idle_share.ard_solve: `idle_share.solve`'s reading in the ARD solve jobs."""

from gpbench.harness import spec

read = spec.load_module(spec.metric_path("idle_share.solve"), "gpbench_metric_idle_share_solve").read
