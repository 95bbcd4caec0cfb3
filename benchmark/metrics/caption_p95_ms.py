"""The 95th percentile, over every request of the window, of the time from
the request's due time to its tokens on the host, in ms (host clock). In a
closed loop a request is due when it is issued."""

import statistics


def read(ctx):
    latency = ctx.window["latency_s"]
    if len(latency) < 2:
        return None
    return statistics.quantiles(latency, n=100, method="inclusive")[94] * 1e3
