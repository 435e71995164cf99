"""logml_bwd_s.fit: seconds of the logML's `backward()` to theta a step,
from the span around it (traced run)."""


def read(ctx):
    spans = [r.spans["logml_bwd"] for r in ctx.records if "logml_bwd" in r.spans]
    return sum(spans) / len(spans) if spans else None
