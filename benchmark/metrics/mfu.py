"""Model FLOPs of the work completed in the traced run's unprofiled window,
over the window's length, as a share of the card's bf16 peak, in %. The
driver counts a request's FLOPs from the configuration's published sizes:
``arith.caption_flops`` per caption (``mfu.serve``), ``arith.train_flops``,
three times the teacher-forced forward, per training video (``mfu.train``)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    w = ctx.window
    return 100.0 * ctx.flops_per_request * w["requests"] / w["window_s"] / ctx.peaks[0]
