"""Share of the profiled stretch in which no kernel or copy runs on the card:
100 x (1 - the union of the device intervals / the stretch's length)."""


def read(ctx):
    p = ctx.profile
    if not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
