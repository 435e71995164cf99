"""cg_frozen.grad_solve: cg_frozen.solve in the gradient solve cells, where
it moves grad_solve_s."""

from gpbench.harness import spec

read = spec.metric_reader("cg_frozen.solve")
