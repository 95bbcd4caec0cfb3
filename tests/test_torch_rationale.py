"""The port's Gumbel-Softmax, RationaleNet eval forward and rationale
captioner against the JAX package (Pallas BiLSTM in interpret mode) on the
CPU, with shared weights and shared Gumbel noise drawn by numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import serving as jserving
from vcr_tpu.models import rationale as jrationale
from vcr_tpu.nn import gumbel as jgumbel
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.nn import gumbel as tgumbel

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 6


@pytest.fixture(scope="module")
def models():
    """One JAX parameter tree, driving both packages (vocab padded 21 -> 24)."""
    kw = dict(DIMS, arch="rationale", base_arch="s2vt", compute_dtype="float32",
              vocab_pad_to=8)
    jspec, jparams = graft._make_spec_and_params(**kw, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**kw, device="cpu")
    tparams = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                     "cpu")
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((B, DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32)
    noise = rng.gumbel(size=(B, DIMS["num_frames"], 2)).astype(np.float32)
    return jspec, jparams, tspec, tparams, feats, noise


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("classes", [2, 7])
def test_gumbel_softmax_matches_jax(rng, hard, classes):
    logits = rng.standard_normal((4, 5, classes)).astype(np.float32)
    noise = rng.gumbel(size=logits.shape).astype(np.float32)
    want = np.asarray(jgumbel.gumbel_softmax(None, jnp.asarray(logits), tau=0.7,
                                             hard=hard, noise=jnp.asarray(noise)))
    got = tgumbel.gumbel_softmax(torch.from_numpy(logits), tau=0.7, hard=hard,
                                 noise=torch.from_numpy(noise)).numpy()
    assert got.dtype == np.float32
    # softmax sums in another order: a few float32 ulps
    np.testing.assert_allclose(got, want, atol=1e-6)
    if hard:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        if classes == 2:  # 1 - p is exact for p >= 1/2, so both are one-hot
            np.testing.assert_array_equal(got, want)


def test_gumbel_draw_follows_the_softmax():
    """argmax(logits + Gumbel noise) ~ softmax(logits): with logits (0, log 3)
    class 1 wins 3/4 of the draws; the same seed gives the same draw."""
    logits = torch.tensor([0.0, float(np.log(3.0))]).expand(20000, 2)
    y = tgumbel.gumbel_softmax(logits, hard=True,
                               generator=torch.Generator().manual_seed(0))
    assert abs(y[:, 1].mean().item() - 0.75) < 0.015
    again = tgumbel.gumbel_softmax(logits, hard=True,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    with pytest.raises(ValueError, match="noise or a generator"):
        tgumbel.gumbel_softmax(logits)


def test_generator_matches_jax(models):
    jspec, jparams, tspec, tparams, feats, noise = models
    want_sel, want_probs = jrationale.generator(
        jparams["gen"], jspec, jnp.asarray(feats), jax.random.PRNGKey(0),
        train=False, gumbel_noise=jnp.asarray(noise))
    sel, probs = trationale.generator(tparams["gen"], tspec, torch.from_numpy(feats),
                                      gumbel_noise=torch.from_numpy(noise))
    assert sel.dtype == probs.dtype == torch.float32
    np.testing.assert_array_equal(probs.numpy(), np.asarray(want_probs))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    share = probs[..., 1].mean().item()
    assert 0.0 < share < 1.0  # the check sees frames both kept and dropped


def test_apply_matches_jax(models):
    jspec, jparams, tspec, tparams, feats, noise = models
    want_logits, want_probs = jrationale.apply(jparams, jspec, jnp.asarray(feats),
                                               gumbel_noise=jnp.asarray(noise))
    logits, probs = trationale.apply(tparams, tspec, torch.from_numpy(feats),
                                     gumbel_noise=torch.from_numpy(noise))
    assert logits.shape == (B, DIMS["max_len"], 24)
    np.testing.assert_array_equal(probs.numpy(), np.asarray(want_probs))
    # two float32 dot orders carried through the BiLSTM and the decode loop
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4)


def test_captioner_tokens_match_jax_serving(models):
    """The JAX captioner draws its noise from PRNGKey(0) through the
    generator's own split; re-derive that noise and inject it on the port's
    side."""
    jspec, jparams, tspec, tparams, feats, _ = models
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none")(
        jnp.asarray(feats)))
    _, k_gumbel = jax.random.split(jax.random.PRNGKey(0))
    u = jax.random.uniform(k_gumbel, (B, DIMS["num_frames"], 2), minval=1e-20,
                           maxval=1.0)
    noise = np.array(-jnp.log(-jnp.log(u) + 1e-20))
    got, _ = trationale.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens",
                              gumbel_noise=torch.from_numpy(noise))
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_captioner_is_deterministic_per_input(models):
    _, _, tspec, tparams, feats, _ = models
    caption = tserving.build_captioner(tparams, tspec, featurizer="none", device="cpu")
    first = caption(feats)
    assert first.shape == (B, DIMS["max_len"]) and first.dtype == torch.int32
    assert torch.equal(first, caption(feats))
    # the same as apply with a generator seeded by the default rng
    want, _ = trationale.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens")
    assert torch.equal(first, want)


def test_bf16_forward_runs_on_the_cpu(models):
    _, _, tspec, tparams, feats, noise = models
    logits, probs = trationale.apply(tparams, tspec.with_(compute_dtype="bfloat16"),
                                     torch.from_numpy(feats),
                                     gumbel_noise=torch.from_numpy(noise))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert torch.equal(probs.sum(-1), torch.ones(probs.shape[:-1]))


# the bf16 tier against the JAX package's, as for S2VT in test_torch_s2vt.py
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
BF16_B = 32
BF16_LOGIT_TOL = 2e-3
BF16_TOKEN_AGREEMENT = 0.98


def test_bf16_rationale_matches_jax():
    """bf16 products and f32 state on both sides (the JAX side through its
    Pallas BiLSTM and GRU in interpret mode), from one JAX parameter tree and
    one numpy Gumbel noise: equal frame selections, logits within
    BF16_LOGIT_TOL, greedy tokens at least BF16_TOKEN_AGREEMENT equal."""
    kw = dict(BF16_DIMS, arch="rationale", base_arch="s2vt", compute_dtype="bfloat16",
              vocab_pad_to=8)
    jspec, jparams = graft._make_spec_and_params(**kw, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**kw, device="cpu")
    tparams = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                     "cpu")
    rng = np.random.default_rng(13)
    feats = rng.standard_normal(
        (BF16_B, BF16_DIMS["num_frames"], BF16_DIMS["vid_feat"])).astype(np.float32)
    noise = rng.gumbel(size=(BF16_B, BF16_DIMS["num_frames"], 2)).astype(np.float32)
    want_logits, want_probs = jrationale.apply(jparams, jspec, jnp.asarray(feats),
                                               gumbel_noise=jnp.asarray(noise))
    logits, probs = trationale.apply(tparams, tspec, torch.from_numpy(feats),
                                     gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(probs.numpy(), np.asarray(want_probs))
    share = probs[..., 1].mean().item()
    assert 0.0 < share < 1.0  # the check sees frames both kept and dropped
    valid = slice(0, BF16_DIMS["vocab_size"])
    want_logits = np.asarray(want_logits)[..., valid]
    assert np.abs(logits.numpy()[..., valid] - want_logits).max() <= BF16_LOGIT_TOL
    tokens, _ = trationale.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens",
                                 gumbel_noise=torch.from_numpy(noise))
    # greedy decoding feeds back the argmax, so the JAX tokens are its
    # logits' argmax
    assert (tokens.numpy() == want_logits.argmax(-1)).mean() >= BF16_TOKEN_AGREEMENT


def test_init_tree_matches_jax_structure(models):
    _, jparams, _, _, _, _ = models
    _, tparams = entry.make_spec_and_params(
        **DIMS, arch="rationale", base_arch="s2vt", vocab_pad_to=8, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), bridge.to_numpy(tparams))
    assert jshapes == tshapes


def test_unported_rationale_options_raise(models):
    _, _, tspec, tparams, feats, _ = models
    # both bases serve and train (S2VT-att since A9); a base that is no video
    # captioner raises, at train, at eval and in the captioner
    other = tspec.with_(base_arch="transformer")
    unknown = "unknown video captioning arch"
    with pytest.raises(NotImplementedError, match=unknown):
        trationale.apply(tparams, other, torch.from_numpy(feats),
                         torch.zeros((B, DIMS["max_len"]), dtype=torch.int32), train=True)
    with pytest.raises(NotImplementedError, match=unknown):
        trationale.apply(tparams, other, torch.from_numpy(feats))
    with pytest.raises(NotImplementedError, match=unknown):
        tserving.build_captioner(tparams, other, device="cpu")
    # beam search (A6) and its int8 decode weights (A13) are ported; the
    # greedy batch decode has no int8-weight form (the slot pool serves it)
    with pytest.raises(ValueError, match="slot pool"):
        tserving.build_captioner(tparams, tspec, decode_weights="int8", device="cpu")
    beam = tserving.build_captioner(tparams, tspec, beam_size=3, decode_weights="int8",
                                    device="cpu")(feats)
    assert beam.shape == (B, DIMS["max_len"])
