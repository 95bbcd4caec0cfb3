"""The least time of a request's LSTM recurrences, over the device time of the
kernels whose names follow, per request, in %. RationaleNet's generator runs
its BiLSTM as two recurrences, one per direction, at (T=frames, B=batch, H);
each one's least time is ``arith.lstm_bound_ms``."""

import re

KERNELS = re.compile(r"(^|\W)lstm_seq")
RECURRENCES = 2


def read(ctx):
    p, m = ctx.profile, ctx.model
    spent = sum(s for name, s in p["kernel_s"].items() if KERNELS.search(name))
    if ctx.peaks is None or spent <= 0 or not p["requests"]:
        return None
    from benchmark.arith import lstm_bound_ms

    bound_ms = lstm_bound_ms(m["num_frames"], ctx.mix["batch"], m["hidden_size"], ctx.peaks)[0]
    return 100.0 * RECURRENCES * bound_ms / 1e3 / (spent / p["requests"])
