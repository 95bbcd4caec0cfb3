"""Captions whose tokens reached the host during the window, over the
window's length (host clock)."""


def read(ctx):
    w = ctx.window
    return w["requests"] * ctx.units_per_request / w["window_s"]
