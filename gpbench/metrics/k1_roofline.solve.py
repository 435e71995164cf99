"""k1_roofline.solve: K1's share of its roofline in the solve jobs — the
least time of the single-column products (one n x n for each counted PCG
iteration and the initial residual, and the mean's n_test x n) over the
device time of the kernels named in `k1_roofline.solve.names/`. The
Nystrom panel is neither counted nor timed."""

from gpbench import work
from gpbench.harness import roofline


def read(ctx):
    cfg, n = ctx.cell.config, int(ctx.cell.traffic["n"])
    ops = work.PROFILE_OPS[work.profile_key(cfg["kernel"])]
    return roofline.solve_share(ctx, "k1_roofline.solve",
                                work.work_direct(n, n, cfg["d"], ops),
                                work.work_direct(cfg["test"]["points"], n, cfg["d"], ops))
