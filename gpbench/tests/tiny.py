"""The cells at sizes a CPU test holds: the same configuration, mix, job,
limits and metrics, fewer points, and `max_cholesky_size` lowered so that
the solve cells still take their iterative paths."""

from gpbench.harness import spec

# workload -> (n, test points, settings of the program)
TINY = {"maternp2_d3.pcg_n131072": (512, 64, {"max_cholesky_size": 128}),
        "grad_eq_d16.cg_n4096": (40, 16, {"max_cholesky_size": 128}),
        "maternp2_d3.fit_n16384": (256, 64, {})}


def tiny_cell(workload: str):
    """(cell, program settings) of `workload` at its tiny size."""
    n, test, control = TINY[workload]
    cell = spec.cell(spec.load_benchmark(), workload)
    cell.traffic = dict(cell.traffic, n=n, trace_jobs=2, check_sample=3)
    cell.config = dict(cell.config, test=dict(cell.config["test"], points=test))
    return cell, control
