"""setup_s: seconds from the launch to the first timed job (import, the
nvcc libraries' load or build, the inputs, one warm job)."""


def read(ctx):
    return ctx.setup_s
