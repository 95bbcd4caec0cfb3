"""Seconds from the process's start to the first timed request: loading,
making the weights and inputs, building the kernels where the checkout has
not, warming up (host clock)."""


def read(ctx):
    return ctx.setup_s
