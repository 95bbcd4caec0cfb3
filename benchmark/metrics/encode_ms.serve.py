"""Device ms per request under the program's ``encode`` and ``prime`` spans,
children included: the features' bf16 cast, B1 over the frames and GRU2's
prime pass (``benchmark/spans.py``: the traced run's spans stretch, each
kernel put down to the innermost span open when it was launched)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, ("encode", "prime"))
