"""idle_share.grad_solve: idle_share.solve in the gradient solve cells, where it
moves grad_solve_s."""

from gpbench.harness import spec

read = spec.metric_reader("idle_share.solve")
