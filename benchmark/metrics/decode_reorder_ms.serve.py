"""Device ms per request under the program's ``decode.reorder`` spans: each
beam step's gathers of the state rows, the token histories and the finished
flags (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, ("decode.reorder",))
