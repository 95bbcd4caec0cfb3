"""Training videos in the optimizer steps of the window, over the window's
length, which ends when the card has finished the last step (host clock)."""


def read(ctx):
    w = ctx.window
    return w["requests"] * ctx.units_per_request / w["window_s"]
