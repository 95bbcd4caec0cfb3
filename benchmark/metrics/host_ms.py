"""The host's wall time inside the program's call, per request, before the
benchmark reads anything back: the mean over the traced run's unprofiled
window, in ms (host clock)."""

import statistics


def read(ctx):
    return statistics.fmean(ctx.window["host_s"]) * 1e3
