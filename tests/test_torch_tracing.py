"""The port's span recorder (``vcr_tpu_torch.utils.profiling``) on the CPU at
small widths: off it records nothing and hands out one shared no-op; on,
each caption call, train step and scheduler round gives its tree of spans
with the right parents and root ids, the tokens and losses are those of a
call with the recorder off, threads keep their own stacks, self time stays
within a span, and the Chrome trace of ``trace`` holds the spans on its own
timeline."""

import contextlib
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from vcr_tpu_torch import entry, scheduler, serving
from vcr_tpu_torch.train import optim, step
from vcr_tpu_torch.utils import profiling

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 3


def _model(arch="s2vt"):
    return entry.make_spec_and_params(**DIMS, arch=arch, compute_dtype="float32",
                                      vocab_pad_to=8, device="cpu")


def _feats(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32))


def _tree(rec):
    """Counter of (name, parent's name) over the closed spans."""
    spans = rec.closed()
    return Counter((s.name, spans[s.parent].name if s.parent >= 0 else None)
                   for s in spans)


def test_off_records_nothing_and_returns_the_shared_noop():
    assert profiling._recorder is None
    first, second = profiling.span("caption"), profiling.span("encode", key=1)
    assert first is second
    spec, params = _model()
    serving.build_captioner(params, spec, beam_size=2, device="cpu")(_feats())
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and profiling._recorder is None
    assert profiling.span("caption") is first


L = DIMS["max_len"]
CALL = [("caption", None)]
S2VT = CALL + [("encode", "caption"), ("prime", "caption")]
STEPS = [("decode.cell", "caption")] * L + [("decode.pick", "caption")] * L
REORDER = [("decode.reorder", "caption")] * L
SELECT = [("encode", "caption"), ("select_frames", "encode")]


@pytest.mark.parametrize("arch, kw, want", [
    ("s2vt", dict(beam_size=3), S2VT + STEPS + REORDER),
    ("s2vt", {}, S2VT + STEPS),
    ("s2vt", dict(sample_temperature=0.8), S2VT + STEPS),
    ("rationale", {}, S2VT + SELECT + STEPS),
    ("rationale", dict(beam_size=3), S2VT + SELECT + STEPS + REORDER),
], ids=["s2vt-beam", "s2vt-greedy", "s2vt-sample", "rationale-greedy", "rationale-beam"])
def test_a_caption_call_gives_its_tree(arch, kw, want):
    """One call: one root ``caption``, its encode (RationaleNet's frame
    selection in an encode of its own), S2VT's prime, and per decode step a
    cell, a pick and (beam) a reorder, all sharing the root's id."""
    spec, params = _model(arch)
    caption = serving.build_captioner(params, spec, device="cpu", **kw)
    with profiling.recording() as rec:
        caption(_feats())
    assert _tree(rec) == Counter(want)
    spans = rec.closed()
    assert len(spans) == len(rec.spans)
    assert {s.root for s in spans} == {spans[0].root}
    assert spans[0].name == "caption" and spans[0].parent == -1
    for s in spans[1:]:
        parent = spans[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_each_call_takes_a_fresh_root_and_a_caller_span_holds_it():
    spec, params = _model()
    caption = serving.build_captioner(params, spec, device="cpu")
    with profiling.recording() as rec:
        caption(_feats())
        caption(_feats())
        with profiling.span("request", key="rid-7"):
            caption(_feats())
    roots = [s for s in rec.closed() if s.parent == -1]
    assert [s.name for s in roots] == ["caption", "caption", "request"]
    assert len({s.root for s in roots}) == 3
    assert roots[2].attrs == {"key": "rid-7"}
    held = [s for s in rec.closed() if s.root == roots[2].root]
    assert [s.name for s in held[:2]] == ["request", "caption"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_train_step_gives_forward_backward_and_optimizer(grad_accum):
    spec, params = _model()
    opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    train, _ = step.build_step_fns("s2vt", spec, opt, static_tf=1.0, grad_accum=grad_accum,
                                   device="cpu")
    with profiling.recording() as rec:
        train(params, opt.init(params), step.device_batch(_batch(), "cpu"), 0, 1.0)
    tree = _tree(rec)
    assert tree[("train.step", None)] == 1
    assert tree[("train.forward", "train.step")] == grad_accum
    assert tree[("train.backward", "train.step")] == grad_accum
    assert tree[("train.optimizer", "train.step")] == 1
    assert tree[("encode", "train.forward")] == grad_accum
    assert tree[("prime", "train.forward")] == grad_accum
    assert {s.root for s in rec.closed()} == {1}


def _batch(seed=1, b=4):
    r = np.random.default_rng(seed)
    return {"vid_feats": r.standard_normal((b, DIMS["num_frames"], DIMS["vid_feat"])
                                           ).astype(np.float32),
            "sent": r.integers(0, DIMS["vocab_size"], (b, L)).astype(np.int32),
            "sent_len": r.integers(1, L + 1, (b,)).astype(np.int32),
            "valid": np.ones((b,), np.float32)}


def test_tokens_and_losses_are_bit_identical_on_and_off():
    spec, params = _model()
    for kw in (dict(beam_size=3), {}, dict(sample_temperature=0.8)):
        caption = serving.build_captioner(params, spec, device="cpu", **kw)
        off = caption(_feats())
        with profiling.recording():
            on = caption(_feats())
        assert torch.equal(off, on), kw
    out = []
    for record in (False, True):
        _, fresh = _model()
        opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
        train, _ = step.build_step_fns("s2vt", spec, opt, static_tf=0.5, device="cpu")
        state = opt.init(fresh)
        losses = []
        with profiling.recording() if record else contextlib.nullcontext():
            for i in range(2):
                fresh, state, metrics, pred = train(
                    fresh, state, step.device_batch(_batch(i), "cpu"), i, 0.5)
                losses.append(metrics["loss"])
        out.append((torch.stack(losses), pred, fresh))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    for a, b in zip(optim.trainable_leaves(out[0][2])[1], optim.trainable_leaves(out[1][2])[1]):
        assert torch.equal(a, b)


def test_two_threads_keep_separate_stacks():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span("outer", tag=tag):
            barrier.wait()
            with profiling.span("inner", tag=tag):
                barrier.wait()
            barrier.wait()

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = rec.closed()
    assert len(spans) == 4
    for s in spans:
        if s.name == "inner":
            parent = spans[s.parent]
            assert parent.name == "outer" and parent.attrs == s.attrs
            assert parent.thread == s.thread and parent.root == s.root
    outers = [s for s in spans if s.name == "outer"]
    assert outers[0].parent == outers[1].parent == -1
    assert outers[0].root != outers[1].root and outers[0].thread != outers[1].thread


def test_self_time_never_exceeds_a_span_s_duration():
    spec, params = _model()
    caption = serving.build_captioner(params, spec, beam_size=3, device="cpu")
    with profiling.recording() as rec:
        caption(_feats())
        caption(_feats())
    summary = rec.summary()
    assert summary["caption"]["count"] == 2 and summary["decode.pick"]["count"] == 2 * L
    for name, row in summary.items():
        assert 0.0 <= row["self_ms"] <= row["total_ms"], name
    spans = rec.closed()
    children = sum(s.duration_ns for s in spans if s.parent >= 0
                   and spans[s.parent].name == "caption")
    caption_ns = sum(s.duration_ns for s in spans if s.name == "caption")
    assert summary["caption"]["self_ms"] == pytest.approx((caption_ns - children) / 1e6)
    # leaves have no children: their self time is their whole time
    assert summary["decode.cell"]["self_ms"] == summary["decode.cell"]["total_ms"]


class _Ops:
    """A scheduler device half in numpy: each admitted request decodes two
    tokens, one per tick."""

    slots, admit_chunk, step_chunk = 2, 2, 1

    def __init__(self):
        self.stats = {"ticks": 0, "admit_chunks": 0, "served": 0, "useful_steps": 0,
                      "slot_steps": 0}
        self.in_flight = 0
        self.steps = np.zeros((self.slots,), np.int32)
        self.active = np.zeros((self.slots,), bool)

    def encode_admit(self, feats, ids, valid):
        for j in np.flatnonzero(valid):
            self.steps[ids[j]], self.active[ids[j]] = 0, True

    def tick(self):
        self.steps[self.active] += 1
        self.active &= self.steps < 2

    def poll_active(self):
        return self.active.copy()

    def read_tokens(self):
        return np.zeros((self.slots, 2), np.int32), self.steps.copy()


def test_the_scheduler_spans_its_rounds():
    ops = _Ops()
    requests = [(f"k{i}", np.zeros((2, 3), np.float32)) for i in range(3)]
    with profiling.recording() as rec:
        served = [k for k, _ in scheduler.run_slot_scheduler(ops, requests)]
    assert sorted(served) == ["k0", "k1", "k2"]
    counts = Counter(s.name for s in rec.closed())
    assert counts["pool.admit"] == ops.stats["admit_chunks"] == 2
    assert counts["pool.tick"] == counts["pool.poll"] == ops.stats["ticks"]
    assert counts["pool.harvest"] == 2
    admits = [s.attrs["keys"] for s in rec.closed() if s.name == "pool.admit"]
    assert admits == [["k0", "k1"], ["k2"]]


def test_the_chrome_trace_holds_the_spans_on_its_timeline(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", key=3):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    outer = [e for e in events if e.get("cat") == "span" and e["name"] == "outer"]
    assert len(outer) == 1 and outer[0]["args"]["key"] == 3
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops
    for op in ops:
        assert outer[0]["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= outer[0]["ts"] + outer[0]["dur"]
