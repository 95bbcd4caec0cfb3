"""Device ms per request under the program's ``decode.pick`` spans: each
beam step's log-softmax, the finished-beam mask, the two stable top-k sorts
and the index arithmetic (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, ("decode.pick",))
