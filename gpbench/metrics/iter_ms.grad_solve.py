"""iter_ms.grad_solve: iter_ms.solve in the gradient solve cells, where it
moves grad_solve_s."""

from gpbench.harness import spec

read = spec.metric_reader("iter_ms.solve")
