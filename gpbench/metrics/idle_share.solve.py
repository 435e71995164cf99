"""idle_share.solve: the share of the traced jobs' window (host clock) in
which no kernel or copy ran on the device, from the profile of the device
alone."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share
