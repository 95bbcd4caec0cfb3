"""The beam's word pick on the card: the kernel (``ops/csrc/beam_pick.cu``)
against its plain version on the same card, at the beam-5 serving cell's
shape and on exact ties, the beam widths 1 and 32 and vocabularies of every
layout; K above 32 raises; the beam search, the batch captioner and the
slot pool through it against the CPU, one launch a step.

Indices are held exactly, values to 1e-5: the kernel forms each value with
the plain version's float32 roundings, (x - max) - log(sum), then the score
added, and orders by (value, index). Its sum of exp is taken in another
order than PyTorch's softmax, so a row's log-sum may differ in its last bit;
the tie cases are built so that it cannot (``util_beam_pick``).

This file imports no JAX, so it runs where only PyTorch is installed:
    python -m pytest --noconftest -m cuda tests/test_torch_beam_pick_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from vcr_tpu_torch import decode, entry, serving, serving_continuous
from vcr_tpu_torch.ops import beam_pick

sys.path.insert(0, os.path.dirname(__file__))
import util_beam_pick as cases  # noqa: E402
from util_steppers import random_stepper, tie_stepper  # noqa: E402

VALUE_TOL = 1e-5     # float32 log-probabilities plus scores; a last bit of the log-sum
SCORE_TOL = 1e-5     # a search's scores summed over its steps (test_torch_decode.py)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_equals_plain(case, cuda):
    args = cases.to(case, cuda)
    before = beam_pick.launches
    got = beam_pick.beam_pick_cuda(*args)
    assert beam_pick.launches == before + 1
    want = beam_pick.beam_pick_plain(*args)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert (got[0] - want[0]).abs().max().item() <= VALUE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_equals_plain_at_the_cell_shape(cuda, seed):
    """2,560 hypotheses over 9,088 columns at K=5, a tenth of them finished."""
    _kernel_equals_plain(cases.random_case(seed, 512, 5, 9088), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cases.tie_cases()))
def test_kernel_equals_plain_on_ties_and_shapes(cuda, name):
    _kernel_equals_plain(cases.tie_cases()[name], cuda)


@pytest.mark.cuda
def test_launches_of_other_shapes_in_turn(cuda):
    """Launches of other item counts and widths one after another, each
    with its own scratch and counters, all pick right."""
    for case in (cases.random_case(4, 64, 5, 9088), cases.equal_rows(batch=9, k=3),
                 cases.random_case(5, 200, 2, 301), cases.random_case(4, 64, 5, 9088)):
        _kernel_equals_plain(case, cuda)


@pytest.mark.cuda
def test_k_above_32_raises(cuda):
    logits, scores, finished, _, eos_id = cases.to(cases.random_case(0, 2, 33, 100), cuda)
    with pytest.raises(ValueError, match="beam size <= 32"):
        decode.beam_pick(logits, scores, finished, 33, eos_id)


def _search(kind, k, device):
    batch, vocab, hidden, steps, sos, eos = 5, 10, 8, 7, 8, 2
    r = np.random.default_rng(k)
    if kind == "random":
        w, e, u = (torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(device)
                   for s in ((hidden, vocab + 2), (vocab, hidden), (hidden, hidden)))
        h0 = r.standard_normal((batch, hidden)).astype(np.float32)
        step = random_stepper(torch, w, e, u, vocab)
        init = {"h": torch.from_numpy(np.repeat(h0, k, axis=0)).to(device)}
    else:
        step = tie_stepper(torch, vocab, device=device)
        init = {"hist": torch.from_numpy(
            np.repeat(np.arange(batch, dtype=np.int32) * 5, k)).to(device)}
    return decode.beam_search(step, init, batch, k, steps, sos, eos), steps


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_beam_search_on_the_card_equals_the_cpu(cuda, monkeypatch, kind, k):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = beam_pick.launches
    (tok, sc), steps = _search(kind, k, cuda)
    torch.cuda.synchronize()
    assert beam_pick.launches == before + steps
    (want_tok, want_sc), _ = _search(kind, k, "cpu")
    assert torch.equal(tok.cpu(), want_tok)
    assert (sc.cpu() - want_sc).abs().max().item() <= SCORE_TOL


def _tiny(device, max_len=20):
    return entry.make_spec_and_params(vocab_size=300, embed_size=16, hidden=32,
                                      vid_feat=12, max_len=max_len, num_frames=4,
                                      compute_dtype="float32", device=device)


@pytest.mark.cuda
def test_a_beam5_call_launches_the_pick_once_a_step(cuda, monkeypatch):
    """A beam-5 caption call at max_len 20 launches the pick 20 times, and
    its float32 tokens equal the CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    feats = torch.randn((16, 4, 12), generator=torch.Generator().manual_seed(2))
    spec, params = _tiny(cuda)
    caption = serving.build_captioner(params, spec, beam_size=5, device=cuda)
    caption(feats.to(cuda))
    torch.cuda.synchronize()
    before = beam_pick.launches
    tokens = caption(feats.to(cuda))
    torch.cuda.synchronize()
    assert beam_pick.launches - before == 20
    spec_cpu, params_cpu = _tiny("cpu")
    want = serving.build_captioner(params_cpu, spec_cpu, beam_size=5, device="cpu")(feats)
    assert torch.equal(tokens.cpu(), want)


@pytest.mark.cuda
def test_pool_beam_picks_on_the_card(cuda, monkeypatch):
    """The slot pool's beam step through the kernel: one launch a step, the
    float32 tokens of the pool on the CPU."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    feats = {i: np.random.default_rng(i).standard_normal((4, 12)).astype(np.float32)
             for i in range(6)}
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        spec, params = _tiny(dev, max_len=8)
        pool = serving_continuous.ContinuousCaptioner(
            params, spec, slots=4, admit_chunk=2, step_chunk=2, beam_size=3, device=dev)
        before = beam_pick.launches
        outs[dev.type] = pool.caption_all(feats)
        launched = beam_pick.launches - before
        assert launched == (2 * pool.stats["ticks"] if dev.type == "cuda" else 0)
    for key in feats:
        assert np.array_equal(outs["cuda"][key], outs["cpu"][key])
