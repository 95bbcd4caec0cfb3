"""Host launch calls per request (cudaLaunchKernel, cuLaunchKernel and their
Ex forms, cudaGraphLaunch), counted from the profiler's runtime events over
the profiled stretch."""


def read(ctx):
    p = ctx.profile
    return p["launches"] / p["requests"] if p["requests"] else None
