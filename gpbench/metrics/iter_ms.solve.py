"""iter_ms.solve: milliseconds of gp_condition's span over its solver
iterations (the preconditioner's build included), over the traced jobs."""


def read(ctx):
    spans = [r.spans["gp_condition"] for r in ctx.records if "gp_condition" in r.spans]
    its = sum(r.out["iters"] for r in ctx.records if "gp_condition" in r.spans)
    return 1e3 * sum(spans) / its if spans and its else None
