"""The beam's word pick as the custom op ``vcr_tpu_torch::beam_pick``
(``vcr_tpu_torch/ops/beam_pick.py``), on the CPU: its CPU implementation
gives bit for bit what the beam search computed inline before it (a
log-softmax, the finished mask and two stable sorts), on exact ties among
others; its fake gives the output shapes and dtypes; ``opcheck`` passes;
the launcher refuses what the kernel cannot take before it looks at the
device; every beam (the batch search, the slot pool) reaches it once a step
and sorts nothing outside it; and an exported S2VT beam-5 artifact holds it
and runs through it. The kernel against this plain version on the card:
``test_torch_beam_pick_cuda.py``."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from vcr_tpu_torch import decode, entry, serving, serving_continuous
from vcr_tpu_torch import export_serving as texport
from vcr_tpu_torch.ops import beam_pick

sys.path.insert(0, os.path.dirname(__file__))
import util_beam_pick as cases  # noqa: E402

CASES = cases.tie_cases()


def _inline_pick(logits, scores, finished, k, eos_id):
    """The body of ``decode.beam_search``'s word pick before it became an op,
    as it was written there."""
    batch = logits.shape[0] // k
    rows = torch.arange(batch)[:, None] * k
    logp = torch.log_softmax(logits.float(), dim=-1)
    eos_only = torch.full((1, logp.shape[-1]), decode.NEG_INF)
    eos_only[0, eos_id] = 0.0
    cont = torch.where(finished[:, None], eos_only, logp)
    s1, i1 = beam_pick.top_k(scores[:, None] + cont, k)
    top_scores, top_idx = beam_pick.top_k(s1.reshape(batch, k * k), k)
    beam_idx = torch.div(top_idx, k, rounding_mode="floor")
    word_idx = i1.reshape(batch, k * k).gather(1, top_idx).to(torch.int32)
    return top_scores, word_idx, (rows + beam_idx).reshape(-1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_op_is_the_inline_pick_bit_for_bit(name):
    case = CASES[name]
    got = torch.ops.vcr_tpu_torch.beam_pick(*case)
    want = _inline_pick(*case)
    assert [t.dtype for t in got] == [torch.float32, torch.int32, torch.int64]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0], want[0])
    # the front door of the decodes is the same op
    assert all(torch.equal(a, b) for a, b in zip(decode.beam_pick(*case), want))


def test_ties_decide_by_lower_word_then_lower_beam():
    """Equal rows: stage 1 takes words 0..K-1 of each beam; stage 2 takes the
    beams of the higher score first, the lower beam among equals."""
    logits, scores, finished, k, eos_id = cases.equal_rows(batch=1)
    top, words, src = torch.ops.vcr_tpu_torch.beam_pick(logits, scores, finished, k, eos_id)
    # scores [0, -1, 0, -1, -0.5]: beam 0's five words, as the values tie
    # with beam 2's and beam 0 is the lower
    assert src.tolist() == [0, 0, 0, 0, 0]
    assert words.tolist() == [[0, 1, 2, 3, 4]]
    assert torch.equal(top[0], torch.full((k,), top[0, 0].item()))


def test_finished_beam_continues_with_eos_alone():
    logits, scores, finished, k, eos_id = cases.finished_rows(batch=1)
    top, words, src = torch.ops.vcr_tpu_torch.beam_pick(logits, scores, finished, k, eos_id)
    for j in range(k):
        if finished[src[j]]:
            assert words[0, j].item() == eos_id and top[0, j].item() == scores[src[j]].item()


@pytest.mark.parametrize("name", ["ties_across_beams", "k32", "ragged_vocab"])
def test_fake_gives_shapes_and_dtypes(name):
    logits, scores, finished, k, eos_id = CASES[name]
    with FakeTensorMode() as mode:
        out = torch.ops.vcr_tpu_torch.beam_pick(
            mode.from_tensor(logits), mode.from_tensor(scores), mode.from_tensor(finished),
            k, eos_id)
    b = logits.shape[0] // k
    assert [(tuple(t.shape), t.dtype) for t in out] == [
        ((b, k), torch.float32), ((b, k), torch.int32), ((b * k,), torch.int64)]


def test_opcheck():
    logits, scores, finished, k, eos_id = CASES["finished_rows"]
    torch.library.opcheck(torch.ops.vcr_tpu_torch.beam_pick.default,
                          (logits, scores, finished, k, eos_id),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("change, match", [
    (dict(k=33), "beam size <= 32"),
    (dict(k=0), "beam size"),
    (dict(logits=torch.zeros((10, 7))), "multiple of the beam size"),
    (dict(logits=torch.zeros((8, 3))), "no top 4"),
    (dict(eos_id=40), "outside the vocabulary"),
    (dict(scores=torch.zeros((8,), dtype=torch.float64)), "scores must be"),
    (dict(finished=torch.zeros((8,), dtype=torch.int32)), "finished must be"),
    (dict(logits=torch.zeros((40, 8)).t()), "logits must be"),
    (dict(), "takes CUDA tensors"),
])
def test_launcher_refuses_before_the_device_check(change, match):
    """The card's launcher raises on what the kernel cannot take (K above 32
    among them) before it checks the device, so these show on the CPU; it
    launches nothing."""
    args = dict(logits=torch.zeros((8, 40)), scores=torch.zeros((8,)),
                finished=torch.zeros((8,), dtype=torch.bool), k=4, eos_id=2)
    args.update(change)
    before = beam_pick.launches
    with pytest.raises(ValueError, match=match):
        beam_pick.beam_pick_cuda(**args)
    assert beam_pick.launches == before


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _tiny(arch="s2vt", max_len=4):
    return entry.make_spec_and_params(vocab_size=11, embed_size=4, hidden=8, vid_feat=6,
                                      max_len=max_len, num_frames=2, arch=arch,
                                      device="cpu")


def _sorts(ops):
    return [op for op in ops if op.split(".")[1] in ("sort", "topk")]


@pytest.mark.parametrize("arch", ["s2vt", "transformer"])
def test_batch_beam_picks_through_the_op_once_a_step(arch):
    spec, params = _tiny(arch)
    caption = serving.build_captioner(params, spec, beam_size=3, device="cpu")
    with _Recorder() as rec:
        caption(torch.randn((2, 2, 6)))
    assert rec.ops.count("vcr_tpu_torch.beam_pick.default") == spec.max_len
    assert _sorts(rec.ops) == []


def test_pool_beam_picks_through_the_op_once_a_step():
    spec, params = _tiny()
    pool = serving_continuous.ContinuousCaptioner(params, spec, slots=2, admit_chunk=2,
                                                  step_chunk=1, beam_size=3, device="cpu")
    feats = {i: np.random.default_rng(i).standard_normal((2, 6)).astype(np.float32)
             for i in range(2)}
    with _Recorder() as rec:
        out = pool.caption_all(feats)
    assert set(out) == {0, 1}
    picks = rec.ops.count("vcr_tpu_torch.beam_pick.default")
    assert 0 < picks == pool.stats["ticks"]
    assert _sorts(rec.ops) == []


def test_exported_beam_artifact_runs_through_the_op(tmp_path):
    """An S2VT beam-5 artifact holds the op, names its source's digest, and
    gives the live beam's tokens on the CPU."""
    spec, params = _tiny(max_len=5)
    out = str(tmp_path / "beam5")
    texport.export_captioner(params, spec, out, beam_size=5, device="cpu")
    with open(os.path.join(out, texport.META_FILE)) as f:
        meta = json.load(f)
    assert "beam_pick" in meta["kernel_sources"]
    art = texport.load_artifact(out, device="cpu")
    assert any(str(n.target) == "vcr_tpu_torch.beam_pick.default"
               for n in art._module.graph.nodes)
    feats = torch.randn((3, 2, 6), generator=torch.Generator().manual_seed(4))
    want = serving.build_captioner(params, spec, beam_size=5, device="cpu")(feats)
    with _Recorder() as rec:
        got = art(feats.numpy())
    assert torch.equal(torch.as_tensor(np.asarray(got)), want)
    assert rec.ops.count("vcr_tpu_torch.beam_pick.default") == spec.max_len
