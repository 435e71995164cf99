"""idle_share.fit: the share of the traced fit steps' window (host clock)
in which no kernel or copy ran on the device, from the profile of the
device alone."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share
