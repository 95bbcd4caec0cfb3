"""Device ms per request under the program's ``decode.cell`` spans: each
decode step's two GRU cells, the word embedding and the vocabulary product
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, ("decode.cell",))
