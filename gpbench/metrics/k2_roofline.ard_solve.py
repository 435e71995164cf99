"""k2_roofline.ard_solve: K2's share of its roofline in the ARD solve jobs —
the least time of the single-column products (one n x n for each counted
PCG iteration and the initial residual, and the mean's n_test x n), through
the x.y tile at the configuration's tensor-core passes (`work/expand.py`),
over the device time of the kernels named in `k2_roofline.ard_solve.names/`.
The Nystrom panel is neither counted nor timed."""

from gpbench import work
from gpbench.harness import roofline
from gpbench.work.expand import work_expand


def read(ctx):
    cfg, n = ctx.cell.config, int(ctx.cell.traffic["n"])
    ops = work.PROFILE_OPS[work.profile_key(cfg["kernel"])]
    passes = roofline.PASSES[cfg["precision"]["matmul_precision"]]
    return roofline.solve_share(ctx, "k2_roofline.ard_solve",
                                work_expand(n, n, cfg["d"], ops, passes),
                                work_expand(cfg["test"]["points"], n, cfg["d"], ops, passes))
