"""fit_s: the window's seconds over its fit steps (logML + backward)."""

from gpbench.harness import stats


def read(ctx):
    return stats.per_job(ctx.window_s, len(ctx.records))
