"""solve_p95_s: the 95th percentile of the window's job times."""

from gpbench.harness import stats


def read(ctx):
    return stats.percentile([r.seconds for r in ctx.records], 95)
