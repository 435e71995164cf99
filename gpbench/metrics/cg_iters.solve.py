"""cg_iters.solve: the solver's iterations a job, `post.solve_info[0]`,
the mean over the jobs."""


def read(ctx):
    its = [r.out["iters"] for r in ctx.records]
    return sum(its) / len(its) if its else None
