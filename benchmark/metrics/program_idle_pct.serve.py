"""Share of the spans stretch in which a ``caption`` span is open on the host
and no kernel or copy runs on the card, in %: the idle time the program's
own call leaves, apart from the caller's (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    s = spans.measured(ctx)
    return None if s is None else 100.0 * s["program_idle_ns"] / s["window_ns"]
