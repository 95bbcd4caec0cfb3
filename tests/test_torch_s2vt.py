"""The port's S2VT eval forward and greedy captioner against the JAX package
(Pallas path in interpret mode) on the CPU, with shared weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import serving as jserving
from vcr_tpu.models import s2vt as js2vt
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import s2vt as ts2vt

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 6


@pytest.fixture(scope="module")
def models():
    """One JAX parameter tree, driving both packages (vocab padded 21 -> 24)."""
    jspec, jparams = graft._make_spec_and_params(
        **DIMS, compute_dtype="float32", vocab_pad_to=8, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(
        **DIMS, compute_dtype="float32", vocab_pad_to=8, device="cpu")
    tparams = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                     "cpu")
    feats = np.random.default_rng(7).standard_normal(
        (B, DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32)
    return jspec, jparams, tspec, tparams, feats


def test_s2vt_logits_and_tokens_match_jax(models):
    jspec, jparams, tspec, tparams, feats = models
    want = np.asarray(js2vt.apply(jparams, jspec, jnp.asarray(feats), train=False))
    got = ts2vt.apply(tparams, tspec, torch.from_numpy(feats))
    assert got.shape == (B, DIMS["max_len"], 24) and got.dtype == torch.float32
    # two float32 dot orders carried through the L-step decode loop
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    want_tok = np.asarray(js2vt.apply(jparams, jspec, jnp.asarray(feats),
                                      train=False, emit="tokens"))
    got_tok = ts2vt.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens")
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def test_s2vt_stages_match_jax(models):
    jspec, jparams, tspec, tparams, feats = models
    jenc, js1 = js2vt.encode(jparams, jspec, jnp.asarray(feats))
    tenc, ts1 = ts2vt.encode(tparams, tspec, torch.from_numpy(feats))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=1e-5)
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), atol=1e-5)
    js2 = js2vt._prime_state2(jparams, jspec, jenc)
    ts2 = ts2vt._prime_state2(tparams, tspec, tenc)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=1e-5)


def test_build_captioner_matches_jax(models):
    jspec, jparams, tspec, tparams, feats = models
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none")(
        jnp.asarray(feats)))
    got = tserving.build_captioner(tparams, tspec, featurizer="none",
                                   device="cpu")(feats)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_captioner_runs_and_stays_close(models):
    """bf16 on the CPU: finite logits within a bf16 envelope of float32."""
    _, _, tspec, tparams, feats = models
    f32 = ts2vt.apply(tparams, tspec, torch.from_numpy(feats))
    bf16 = ts2vt.apply(tparams, tspec.with_(compute_dtype="bfloat16"),
                       torch.from_numpy(feats))
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    valid = slice(0, DIMS["vocab_size"])
    assert (bf16[..., valid] - f32[..., valid]).abs().max() < 0.1


# the bf16 tier against the JAX package's, at a width where bf16 rounding
# shows (at DIMS' H=32 the two differ by ~6e-8)
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
BF16_B = 32
BF16_LOGIT_TOL = 2e-3      # the same roundings, sums in other orders through the
                           # encoder, the prime pass and 10 decode steps
BF16_TOKEN_AGREEMENT = 0.98


def test_bf16_s2vt_matches_jax():
    """bf16 products and f32 state on both sides (the JAX side through its
    Pallas GRU in interpret mode), from one JAX parameter tree: logits within
    BF16_LOGIT_TOL, greedy tokens at least BF16_TOKEN_AGREEMENT equal."""
    jspec, jparams = graft._make_spec_and_params(
        **BF16_DIMS, compute_dtype="bfloat16", vocab_pad_to=8, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(
        **BF16_DIMS, compute_dtype="bfloat16", vocab_pad_to=8, device="cpu")
    tparams = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                     "cpu")
    feats = np.random.default_rng(5).standard_normal(
        (BF16_B, BF16_DIMS["num_frames"], BF16_DIMS["vid_feat"])).astype(np.float32)
    want = np.asarray(js2vt.apply(jparams, jspec, jnp.asarray(feats), train=False))
    got = ts2vt.apply(tparams, tspec, torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (BF16_B, BF16_DIMS["max_len"], 304)
    valid = slice(0, BF16_DIMS["vocab_size"])
    assert np.abs(got[..., valid] - want[..., valid]).max() <= BF16_LOGIT_TOL
    want_tok = np.asarray(js2vt.apply(jparams, jspec, jnp.asarray(feats), train=False,
                                      emit="tokens"))
    got_tok = ts2vt.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens").numpy()
    assert (got_tok == want_tok).mean() >= BF16_TOKEN_AGREEMENT


# Beam search and sampling (A6) are ported; the cases that named A6 then held
# the quantized modes (A13), which are ported too. They keep their ids and
# hold what still stands: S2VT's greedy batch decode has no int8-weight form
# (the pool, the beam and sampling serve it), and a GRU family has no
# attention cache to quantize (ValueError).
@pytest.mark.parametrize("kwargs, exc, item", [
    ({"featurizer": "vgg16"}, NotImplementedError, "A17"),
    pytest.param({"decode_weights": "int8"}, ValueError, "slot pool", id="kwargs1-A6"),
    pytest.param({"kv_cache": "int8"}, ValueError, "has none", id="kwargs2-A6"),
    pytest.param({"beam_size": 3, "kv_cache": "int8"}, ValueError, "has none",
                 id="kwargs3-A6"),
    pytest.param({"sample_temperature": 0.7, "kv_cache": "int4"}, ValueError, "has none",
                 id="kwargs4-A6"),
    ({"featurizer": "resnet"}, NotImplementedError, "A17"),
])
def test_unported_serving_options_raise(models, kwargs, exc, item):
    _, _, tspec, tparams, _ = models
    with pytest.raises(exc, match=item):
        tserving.build_captioner(tparams, tspec, device="cpu", **kwargs)


# S2VT-att (A9), RationaleNet (A10) and SpatialNet (A11) over either base,
# and the Transformer (A12), are ported; their cases keep their ids and now
# hold what is still refused: an unknown architecture, RationaleNet or
# SpatialNet over a base that is no video captioner (a Transformer among
# them), and int8 weights on the Transformer's parity beam, which has no
# stepper (its quantized serving modes, A13, are ported).
@pytest.mark.parametrize("arch, item", [
    pytest.param("lstm-lm", "Unknown", id="s2vt-att-A9"),
    pytest.param("rationale", "unknown video captioning arch", id="rationale-A10"),
    pytest.param("spatial", "unknown video captioning arch", id="spatial-A11"),
    pytest.param("transformer", "parity beam", id="transformer-A12")])
def test_unported_families_raise(models, arch, item):
    """What is still refused raises, naming its ROADMAP item where it has one."""
    _, _, tspec, tparams, feats = models
    if arch == "spatial":
        sspec, sparams = entry.make_spec_and_params(
            **dict(DIMS, vid_feat=4), arch=arch, grid_size=2, compute_dtype="float32",
            device="cpu")
        grid = torch.zeros((B, DIMS["num_frames"], 4, 2, 2))
        with pytest.raises(NotImplementedError, match=item):
            tbase.build_model(arch)[1](sparams, sspec.with_(base_arch="transformer"), grid)
        return
    if arch == "rationale":
        rspec, rparams = entry.make_spec_and_params(
            **DIMS, arch=arch, compute_dtype="float32", device="cpu")
        s = torch.zeros((B, DIMS["max_len"]), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match=item):
            tbase.build_model(arch)[1](rparams, rspec.with_(base_arch="transformer"),
                                       torch.from_numpy(feats), s, train=True)
        return
    if arch == "transformer":
        tf_spec, tf_params = entry.make_spec_and_params(
            **DIMS, arch=arch, tf_layers=1, tf_heads=2, compute_dtype="float32",
            device="cpu")
        x = torch.zeros((B, DIMS["num_frames"], DIMS["vid_feat"]))
        with pytest.raises(NotImplementedError, match=item):
            tdecode.decode_tokens(tf_params, tf_spec, x, 1, 2, decode_weights="int8")
        return
    with pytest.raises(NotImplementedError, match=item):
        tbase.build_model(arch)
    with pytest.raises(NotImplementedError, match=item):
        tserving.build_captioner(tparams, tspec.with_(arch=arch), device="cpu")


def test_train_mode_and_unknown_arch_raise(models):
    """The train forward needs the teacher tokens; emit takes two values."""
    _, _, tspec, tparams, feats = models
    with pytest.raises(ValueError, match="teacher tokens"):
        ts2vt.apply(tparams, tspec, torch.from_numpy(feats), train=True)
    with pytest.raises(ValueError, match="emit must be"):
        ts2vt.apply(tparams, tspec, torch.from_numpy(feats), emit="probs")
    with pytest.raises(NotImplementedError, match="Unknown"):
        tbase.build_model("lstm-lm")


def test_resolve_eos_id_is_duck_typed(models):
    jspec, _, tspec, _, _ = models

    class Vocab:
        sos_id, eos_id = tspec.sos_id, tspec.sos_id + 1

    assert tserving.resolve_eos_id(tspec) == jserving.resolve_eos_id(jspec)
    assert tserving.resolve_eos_id(tspec, vocab=Vocab()) == tspec.sos_id + 1
    with pytest.raises(ValueError):
        tserving.resolve_eos_id(tspec, eos_id=0, vocab=Vocab())
    Vocab.sos_id = 0
    with pytest.raises(ValueError):
        tserving.resolve_eos_id(tspec, vocab=Vocab())
