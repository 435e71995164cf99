"""mean_ms.grad_solve: mean_ms.solve in the gradient solve cells, where it
moves grad_solve_s."""

from gpbench.harness import spec

read = spec.metric_reader("mean_ms.solve")
