"""k3_roofline.grad_solve: K3's share of its roofline in the gradient solve
jobs — the least time of the gradient-block products (one n x n for each
counted CG iteration and the initial residual, and the mean's n_test x n)
at the configured tier's tf32 passes, over the device time of the kernels
named in `k3_roofline.grad_solve.names/`."""

from gpbench import work
from gpbench.harness import roofline


def read(ctx):
    cfg, n = ctx.cell.config, int(ctx.cell.traffic["n"])
    jet = work.JET_OPS[work.profile_key(cfg["kernel"])]
    passes = roofline.PASSES[cfg["precision"]["matmul_precision"]]
    return roofline.solve_share(ctx, "k3_roofline.grad_solve",
                                work.work_grad(n, n, cfg["d"], jet, passes),
                                work.work_grad(cfg["test"]["points"], n, cfg["d"], jet, passes))
