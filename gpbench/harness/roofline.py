"""A kernel's share of its roofline over the traced jobs: the least time of
the kernel-matrix products that the jobs needed, from the frozen work
models (`gpbench/work`) at the cell's shapes, over the device time of the
kernels that implement them, found by the name patterns of the metric's
own files (`metrics/<metric>.names/*.txt`)."""

from __future__ import annotations

import sys

from gpbench import work
from gpbench.harness import spec

PASSES = {"highest": 3, "high": 3, "default": 1}


def solve_share(ctx, metric: str, product, mean):
    """100 x least / device seconds for solve jobs: each job needs one n x n
    product (`product`, a Work) for each counted iteration plus the initial
    residual's, and the mean's rectangular product (`mean`). None where the
    profile holds none of the kernels."""
    if ctx.trace is None:
        return None
    device_s = ctx.trace.kernel_seconds(spec.kernel_patterns(metric))
    if device_s <= 0:
        return None
    least = sum((r.out["iters"] + 1) * product.roofline_seconds() + mean.roofline_seconds()
                for r in ctx.records)
    share = 100.0 * least / device_s
    if share > 100.0 * work.PEAK_SLACK:
        print(f"gpbench: {metric} reads {share:.2f}%, above {100 * work.PEAK_SLACK:.0f}% of "
              f"the roofline: the work is counted too high or the time misses part of it",
              file=sys.stderr)
    return share
