"""solve_s: the window's seconds over its jobs (gp_condition + the mean)."""

from gpbench.harness import stats


def read(ctx):
    return stats.per_job(ctx.window_s, len(ctx.records))
