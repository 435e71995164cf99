"""grad_solve_s: the window's seconds over its jobs (gp_condition on
gradient observations + the mean), as solve_s reads them. The gradient
solve's CG loop is paced by the host, whose speed differs from run to run,
so it is held to a bound of its own."""

from gpbench.harness import spec

read = spec.metric_reader("solve_s")
