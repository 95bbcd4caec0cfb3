"""The port's beam search and sampling for S2VT-att and RationaleNet over
S2VT-att against ``vcr_tpu.decode`` and ``vcr_tpu.serving`` on the CPU (the
JAX side through its Pallas kernels in interpret mode), from one JAX
parameter tree, the port's draws replaced by the JAX package's own noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import decode as jdecode
from vcr_tpu import serving as jserving
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import s2vt_att as ts2vt_att

from test_torch_decode import _jax_gumbel, _jax_sampling_noise

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B, K = 6, 3
SCORE_TOL = 1e-5     # float32 log-probabilities summed over 6 steps, other
                     # orders of the products' sums
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
BF16_B = 32
BF16_TOKEN_AGREEMENT = 0.98   # test_torch_decode.py's bf16 bound


def _models(arch="s2vt-att", compute_dtype="float32", dims=DIMS, b=B):
    """(JAX spec, JAX params, port spec, port params, feats), one tree."""
    extra = dict(base_arch="s2vt-att") if arch == "rationale" else {}
    jspec, jparams = graft._make_spec_and_params(
        **dims, arch=arch, compute_dtype=compute_dtype, vocab_pad_to=8,
        use_pallas=True, **extra)
    tspec, _ = entry.make_spec_and_params(**dims, arch=arch, compute_dtype=compute_dtype,
                                          vocab_pad_to=8, device="cpu", **extra)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    feats = np.random.default_rng(2).standard_normal(
        (b, dims["num_frames"], dims["vid_feat"])).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module")
def att():
    return _models()


@pytest.fixture(scope="module")
def rat():
    return _models("rationale")


def test_beam_decode_matches_jax(att):
    jspec, jparams, tspec, tparams, feats = att
    eos = jspec.sos_id + 1
    jtok, jsc = jdecode.s2vt_att_beam_decode(jparams, jspec, jnp.asarray(feats), K, eos)
    ttok, tsc = tdecode.s2vt_att_beam_decode(tparams, tspec, torch.from_numpy(feats), K,
                                             eos)
    assert ttok.shape == (B, K, DIMS["max_len"]) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=SCORE_TOL)
    ttok2, _ = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, K)
    assert torch.equal(ttok, ttok2)


def test_rationale_beam_decode_matches_jax(rat):
    jspec, jparams, tspec, tparams, feats = rat
    eos = jspec.sos_id + 1
    rng = jax.random.PRNGKey(4)
    noise = _jax_gumbel(rng, (B, DIMS["num_frames"], 2))
    jtok, jsc = jdecode.rationale_beam_decode(jparams, jspec, jnp.asarray(feats), K, eos,
                                              rng=rng)
    ttok, tsc = tdecode.rationale_beam_decode(tparams, tspec, torch.from_numpy(feats), K,
                                              eos, gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("arch", ["s2vt-att", "rationale"])
@pytest.mark.parametrize("temperature, top_k, top_p", [(1.0, 0, 0.0), (0.8, 6, 0.9)])
def test_sampling_with_jax_noise_matches_jax(att, rat, arch, temperature, top_k, top_p):
    """Frame selection (RationaleNet) and every step's sampling under the
    JAX package's own noise: tokens identical."""
    jspec, jparams, tspec, tparams, feats = att if arch == "s2vt-att" else rat
    eos = jspec.sos_id + 1
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jdecode.sample_tokens(jparams, jspec, jnp.asarray(feats), eos, rng,
                                            temperature, top_k, top_p))
    sel_noise = None
    if arch == "rationale":
        k_gen, rng = jax.random.split(rng)
        sel_noise = torch.from_numpy(_jax_gumbel(k_gen, (B, DIMS["num_frames"], 2)))
    noise = _jax_sampling_noise(rng, DIMS["max_len"], B, tspec.padded_vocab_size)
    got = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 0,
                                temperature, top_k, top_p, gumbel=torch.from_numpy(noise),
                                gumbel_noise=sel_noise)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _upto_eos(row, eos):
    row = list(row)
    return row[:row.index(eos) + 1] if eos in row else row


def test_beam_one_and_top_k_one_equal_greedy(att):
    _, _, tspec, tparams, feats = att
    eos = tspec.sos_id + 1
    x = torch.from_numpy(feats)
    greedy = ts2vt_att.apply(tparams, tspec, x, emit="tokens").numpy()
    beam, _ = tdecode.s2vt_att_beam_decode(tparams, tspec, x, 1, eos)
    sampled = tdecode.sample_tokens(tparams, tspec, x, eos, rng=3, top_k=1)
    for g, b_, s in zip(greedy, beam[:, 0].numpy(), sampled.numpy()):
        assert _upto_eos(b_, eos) == _upto_eos(g, eos) == _upto_eos(s, eos)


@pytest.mark.parametrize("arch", ["s2vt-att", "rationale"])
@pytest.mark.parametrize("mode", ["beam", "sample"])
def test_captioner_matches_jax_serving(att, rat, monkeypatch, arch, mode):
    """build_captioner with beam_size=3, and with sampling, against
    vcr_tpu.serving (whose draws come from PRNGKey(0)), the port's draws
    replaced by the JAX package's noise."""
    jspec, jparams, tspec, tparams, feats = att if arch == "s2vt-att" else rat
    kw = {"beam_size": K} if mode == "beam" else {"sample_temperature": 0.9,
                                                  "sample_top_k": 8}
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none", **kw)(
        jnp.asarray(feats)))
    rng = jax.random.PRNGKey(0)
    draws = []
    if arch == "rationale":
        rng, k_samp = jax.random.split(rng) if mode == "sample" else (rng, None)
        draws.append(_jax_gumbel(rng, (B, DIMS["num_frames"], 2)))
        rng = k_samp
    if mode == "sample":
        draws.extend(_jax_sampling_noise(rng, DIMS["max_len"], B,
                                         tspec.padded_vocab_size))
    it = iter(draws)
    monkeypatch.setattr(tdecode, "sample_gumbel",
                        lambda shape, gen, device: torch.from_numpy(next(it)))
    got = tserving.build_captioner(tparams, tspec, device="cpu", **kw)(feats)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_beam_decode_matches_jax():
    jspec, jparams, tspec, tparams, feats = _models("s2vt-att", "bfloat16", BF16_DIMS,
                                                    BF16_B)
    eos = jspec.sos_id + 1
    jtok, _ = jdecode.decode_tokens(jparams, jspec, jnp.asarray(feats), eos, K)
    with torch.inference_mode():
        ttok, _ = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, K)
    assert (ttok[:, 0].numpy() == np.asarray(jtok)[:, 0]).mean() >= BF16_TOKEN_AGREEMENT


def test_int8_decode_weights_raise(att):
    """int8 decode weights (A13) are ported: the beam runs them, with JAX's
    tokens, and build_captioner's beam forwards them; its greedy batch
    decode has no int8-weight form and still raises (ValueError, naming the
    slot pool, which serves it)."""
    jspec, jparams, tspec, tparams, feats = att
    eos = jspec.sos_id + 1
    jtok, _ = jdecode.decode_tokens(jparams, jspec, jnp.asarray(feats), eos, 2,
                                    decode_weights="int8")
    ttok, _ = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, 2,
                                    decode_weights="int8")
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    cap = tserving.build_captioner(tparams, tspec, beam_size=2, decode_weights="int8",
                                   device="cpu")
    assert torch.equal(cap(feats), ttok[:, 0])
    with pytest.raises(ValueError, match="slot pool"):
        tserving.build_captioner(tparams, tspec, decode_weights="int8", device="cpu")
