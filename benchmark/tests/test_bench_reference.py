"""The plain references against the program's CPU path at small widths: in
float32 they agree with it to rounding; with the program's bf16 products it
departs from them by less than a control in fp8 does."""

import json

import pytest
import torch

from benchmark import inputs, port
from benchmark.reference import rationale as ref_rat
from benchmark.reference import s2vt as ref_s2vt
from benchmark.reference.common import exact_float32
from benchmark.traffic.train import leaf_gap
from conftest import ROOT, SMALL


def config(name: str, **kw) -> dict:
    m = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    m.update(SMALL)
    m.update(kw)
    return m


def setup(name: str, seed: int, batch: int = 12, **kw):
    m = config(name, **kw)
    ref = ref_rat if m["arch"] == "rationale" else ref_s2vt
    sd = inputs.state_dict(ref.layout(m), m, seed, "cpu")
    feats = inputs.video_feats(seed, 0, batch, m, "cpu")
    noise = inputs.gumbel(seed, 0, (batch, m["num_frames"], 2), "cpu")
    return m, sd, port.load_params(sd, m, "cpu"), feats, noise


@pytest.mark.parametrize("seed", [1, 2])
def test_s2vt_greedy_logits_and_tokens(seed):
    from vcr_tpu_torch.models import s2vt

    m, sd, params, feats, _ = setup("s2vt-msvd-vgg16", seed, compute_dtype="float32")
    spec = port.model_spec(m)
    with torch.no_grad():
        logits = s2vt.apply(params, spec, feats)[..., : m["vocab_size"]]
        tokens = logits.argmax(-1)
        with exact_float32():
            model = ref_s2vt.S2VT(sd, m)
            state = model.encode(feats)
            forced = ref_s2vt.forced_logits(model, state, tokens, m)
            greedy = ref_s2vt.greedy(model, model.encode(feats), m)
    assert torch.allclose(logits, forced, atol=1e-4, rtol=1e-4)
    assert torch.equal(tokens, greedy)
    assert float(ref_s2vt.token_gaps(forced, tokens).max()) < 1e-4


@pytest.mark.parametrize("seed", [3, 4])
def test_s2vt_beam(seed):
    from vcr_tpu_torch import decode

    m, sd, params, feats, _ = setup("s2vt-msvd-vgg16", seed, compute_dtype="float32")
    spec = port.model_spec(m)
    with torch.no_grad():
        tokens, scores = decode.decode_tokens(params, spec, feats, m["eos_id"], 5)
        with exact_float32():
            model = ref_s2vt.S2VT(sd, m)
            best, best_score = ref_s2vt.beam_search(model, model.encode(feats), m, 5)
            logits = ref_s2vt.forced_logits(model, model.encode(feats), tokens[:, 0], m)
    assert torch.equal(tokens[:, 0].long(), best)
    assert torch.allclose(scores[:, 0], best_score, atol=1e-4)
    assert float(ref_s2vt.token_gaps(logits, tokens[:, 0], 5, m["eos_id"]).max()) < 1e-4
    # held to the best alone, a beam's caption departs from greedy's choice
    assert float(ref_s2vt.token_gaps(logits, tokens[:, 0]).max()) > 1e-3


@pytest.mark.parametrize("seed", [5, 6])
def test_rationale_selection_and_tokens(seed):
    from vcr_tpu_torch.models import rationale

    m, sd, params, feats, noise = setup("rationale-s2vt-msvd-vgg16", seed,
                                        compute_dtype="float32")
    spec = port.model_spec(m)
    with torch.no_grad():
        _, probs = rationale.apply(params, spec, feats, gumbel_noise=noise)
        tokens = rationale.apply(params, spec, feats, gumbel_noise=noise, emit="tokens")[0]
        with exact_float32():
            keep = ref_rat.margins(sd, m, feats, noise, "fp32") > 0
        served = ref_rat.serve(sd, m, feats, noise, 1, "fp32")
        gaps = ref_rat.served_gaps(sd, m, feats, noise, tokens, 1, {"select_margin": 1e-3})
    assert torch.equal(probs[..., 1] > 0.5, keep)
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(tokens.long(), served)
    assert float(gaps.max()) < 1e-4


def port_first_steps(m, sd, params, batches, seeds):
    from vcr_tpu_torch.train import optim, step

    t = m["train"]
    opt = optim.build_optimizer("adam", t["lr"], t["wd"], t["max_norm"])
    state = opt.init(params)
    train_step = step.build_step_fns("s2vt", port.model_spec(m), opt, static_tf=1.0,
                                     device="cpu")[0]
    losses = []
    for i, (b, s) in enumerate(zip(batches, seeds)):
        losses.append(float(train_step(params, state, b, s, 1.0)[2]["loss"]))
        if i == 0:
            tree = {}
            for path, leaf in zip(state.paths, state.leaves):
                tree.setdefault(path[0], {})[path[1]] = (
                    state.optimizer.state[leaf]["exp_avg"] / 0.1)
            grad = port.export_tree(tree, m)
    after = port.export_tree(params, m)
    return losses, grad, {k: after[k] - sd[k] for k in sd}


def train_setup(seed: int, **kw):
    m, sd, params, _, _ = setup("s2vt-msvd-vgg16", seed, **kw)
    words = {"1": 1, "2": 2, "3": 2, "4": 1}
    batches = []
    for i in range(3):
        b = inputs.sentences(seed, i, 16, m, words, "cpu")
        b["vid_feats"] = inputs.video_feats(seed, i, 16, m, "cpu")
        batches.append(b)
    return m, sd, params, batches, [inputs.derive(seed, f"step{i}") for i in range(3)]


def train_gaps(m, sd, prog, ref):
    losses, grad, change = prog
    keys = list(sd)
    return (max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])),
            leaf_gap(grad, ref["grad"], keys), leaf_gap(change, ref["change"], keys))


def test_train_steps_match_in_float32():
    m, sd, params, batches, seeds = train_setup(7, compute_dtype="float32")
    prog = port_first_steps(m, sd, params, batches, seeds)
    ref = ref_s2vt.train_steps(sd, m, m["train"], batches, seeds)
    loss, grad, change = train_gaps(m, sd, prog, ref)
    assert loss < 1e-5 and grad < 1e-4 and change < 1e-3


def test_the_fp8_control_departs_further_than_bf16():
    """The program at its stated bf16 products, and the reference in fp8 in
    its place, each against the float32 reference: serving's widest token
    gap and the train step's gaps; the control's are the larger."""
    m, sd, params, feats, _ = setup("s2vt-msvd-vgg16", 8, batch=48)
    from vcr_tpu_torch import serving

    bf16 = serving.build_captioner(params, port.model_spec(m), device="cpu")(feats)
    fp8 = ref_s2vt.serve(sd, m, feats, None, 1, "fp8")
    gap_bf16 = float(ref_s2vt.served_gaps(sd, m, feats, None, bf16, 1, {}).max())
    gap_fp8 = float(ref_s2vt.served_gaps(sd, m, feats, None, fp8, 1, {}).max())
    assert gap_fp8 > 3 * gap_bf16 and gap_fp8 > 0

    m, sd, params, batches, seeds = train_setup(9)
    ref = ref_s2vt.train_steps(sd, m, m["train"], batches, seeds)
    ours = train_gaps(m, sd, port_first_steps(m, sd, params, batches, seeds), ref)
    ctl = ref_s2vt.train_steps(sd, m, m["train"], batches, seeds, prec="fp8")
    theirs = train_gaps(m, sd, (ctl["loss"], ctl["grad"], ctl["change"]), ref)
    assert theirs[1] > 3 * ours[1] and theirs[0] > ours[0]
