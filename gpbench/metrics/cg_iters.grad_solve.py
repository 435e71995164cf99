"""cg_iters.grad_solve: cg_iters.solve in the gradient solve cells, where it
moves grad_solve_s."""

from gpbench.harness import spec

read = spec.metric_reader("cg_iters.solve")
