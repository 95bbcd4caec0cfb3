"""The copied arithmetic: the model FLOP formulas, evaluated at the program's
padded vocabulary, against what ``benchutil.flops`` counts of the program's
own calls at small widths; the bounds and the union against their
originals."""

import pytest
import torch

from benchmark import arith, inputs, port
from benchmark.reference import rationale as ref_rat
from benchmark.reference import s2vt as ref_s2vt
from test_bench_reference import config

B = 6


def program(name: str, beam: int = 1):
    m = config(name)
    ref = ref_rat if m["arch"] == "rationale" else ref_s2vt
    sd = inputs.state_dict(ref.layout(m), m, 1, "cpu")
    return m, port.model_spec(m), port.load_params(sd, m, "cpu")


@pytest.mark.parametrize("name,beam", [("s2vt-msvd-vgg16", 1), ("s2vt-msvd-vgg16", 5),
                                       ("rationale-s2vt-msvd-vgg16", 1)])
def test_caption_flops_match_the_programs_count(name, beam):
    from vcr_tpu_torch import serving
    from vcr_tpu_torch.utils import benchutil

    m, spec, params = program(name)
    feats = inputs.video_feats(1, 0, B, m, "cpu")
    noise = {"select": inputs.gumbel(1, 0, (B, m["num_frames"], 2), "cpu")}
    caption = serving.make_caption_fn(spec, beam_size=beam, eos_id=m["eos_id"])
    counted = benchutil.flops(caption, params, feats, noise)
    assert counted == B * arith.caption_flops(m, beam, vocab=spec.padded_vocab_size)
    assert arith.caption_flops(m, beam) < arith.caption_flops(m, beam, spec.padded_vocab_size)


def test_train_forward_flops_match_the_programs_count():
    from vcr_tpu_torch.models import s2vt
    from vcr_tpu_torch.utils import benchutil

    m, spec, params = program("s2vt-msvd-vgg16")
    feats = inputs.video_feats(1, 0, B, m, "cpu")
    sent = inputs.sentences(1, 0, B, m, {"2": 1, "3": 1}, "cpu")["sent"]
    counted = benchutil.flops(s2vt.apply, params, spec, feats, sent, rng=3, train=True)
    assert counted == B * arith.train_forward_flops(m, vocab=spec.padded_vocab_size)
    assert arith.train_flops(m) == 3 * arith.train_forward_flops(m)


@pytest.mark.parametrize("t,b,h", [(30, 2048, 512), (30, 1024, 512), (5, 3, 32)])
def test_bounds_are_benchutils(t, b, h):
    from vcr_tpu_torch.utils import benchutil

    peaks = arith.CARD_PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks == benchutil.CARD_PEAKS["NVIDIA H100 80GB HBM3"]
    assert arith.gru_bound_ms(t, b, h, peaks) == benchutil.gru_bound_ms(t, b, h, peaks)
    assert arith.lstm_bound_ms(t, b, h, peaks) == benchutil.lstm_bound_ms(t, b, h, peaks)


def test_union_length():
    assert arith.union_length([]) == 0.0
    assert arith.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert arith.union_length([(4, 5), (0, 1)]) == 2.0


def test_flagship_flops():
    """At the published sizes, about 0.816 GFLOP a greedy caption."""
    import json
    from conftest import ROOT

    m = json.loads((ROOT / "benchmark/configs/s2vt-msvd-vgg16.json").read_text())
    per = arith.caption_flops(m)
    assert per == (2 * 30 * 4096 * 1536 + 3 * 2 * 30 * 512 * 1536
                   + 20 * (2 * 512 * 1536 * 2 + 2 * 812 * 1536 + 2 * 512 * 9000))
    assert torch.isclose(torch.tensor(per / 1e9), torch.tensor(0.816), atol=0.001)
