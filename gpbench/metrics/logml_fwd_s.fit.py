"""logml_fwd_s.fit: seconds of `log_marginal_likelihood` a step, from the
span around it (traced run)."""


def read(ctx):
    spans = [r.spans["logml_fwd"] for r in ctx.records if "logml_fwd" in r.spans]
    return sum(spans) / len(spans) if spans else None
