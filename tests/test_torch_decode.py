"""The port's beam search and sampling against ``vcr_tpu.decode`` and
``vcr_tpu.serving`` on the CPU: the search itself on steppers of its own
(random, and with forced ties), S2VT and RationaleNet at float32 and bf16
(the JAX side through its Pallas kernels in interpret mode), the sampling
filters, and sampling under the JAX package's own Gumbel noise."""

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
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.models import s2vt as ts2vt
from vcr_tpu_torch.ops.beam_pick import top_k
from util_steppers import random_stepper as _random_stepper
from util_steppers import tie_stepper as _tie_stepper

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B, K = 6, 3
SCORE_TOL = 1e-5     # float32 log-probabilities summed over 6 steps, other
                     # orders of the products' sums
FILTER_TOL = 1e-6    # float32 logits, scaled and masked
# bf16: the port's and the JAX package's products round the same operands but
# sum in other orders; near ties may then pick other words (as the greedy
# bf16 tests in test_torch_s2vt.py bound them)
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
BF16_B = 32
BF16_TOKEN_AGREEMENT = 0.98


def _models(arch="s2vt", compute_dtype="float32", dims=DIMS, b=B, seed=0):
    """(JAX spec, JAX params, port spec, port params, feats), one tree."""
    jspec, jparams = graft._make_spec_and_params(
        **dims, arch=arch, compute_dtype=compute_dtype, vocab_pad_to=8,
        use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**dims, arch=arch, compute_dtype=compute_dtype,
                                          vocab_pad_to=8, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    feats = np.random.default_rng(seed + 1).standard_normal(
        (b, dims["num_frames"], dims["vid_feat"])).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module")
def s2vt():
    return _models()


@pytest.fixture(scope="module")
def rat():
    return _models("rationale")


def _jax_gumbel(rng, shape):
    """The noise ``rationale.generator`` draws from ``rng`` in the JAX package."""
    _, k_gumbel = jax.random.split(rng)
    u = jax.random.uniform(k_gumbel, shape, minval=1e-20, maxval=1.0)
    return np.array(-jnp.log(-jnp.log(u) + 1e-20))


# ------------------------------------------------------------ the search

@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_beam_search_matches_jax(kind, k):
    batch, vocab, hidden, steps, sos, eos = 5, 10, 8, 7, 8, 2
    r = np.random.default_rng(k)
    if kind == "random":
        w, e, u = (r.standard_normal(s).astype(np.float32) for s in
                   ((hidden, vocab + 2), (vocab, hidden), (hidden, hidden)))
        h0 = r.standard_normal((batch, hidden)).astype(np.float32)
        jstep = _random_stepper(jnp, *(jnp.asarray(a) for a in (w, e, u)), vocab)
        tstep = _random_stepper(torch, *(torch.from_numpy(a) for a in (w, e, u)), vocab)
        init = {"h": np.repeat(h0, k, axis=0)}
    else:
        jstep, tstep = _tie_stepper(jnp, vocab), _tie_stepper(torch, vocab)
        init = {"hist": np.repeat(np.arange(batch, dtype=np.int32) * 5, k)}
    jtok, jsc = jdecode.beam_search(jstep, {n: jnp.asarray(v) for n, v in init.items()},
                                    batch, k, steps, sos, eos)
    ttok, tsc = tdecode.beam_search(tstep, {n: torch.from_numpy(v) for n, v in init.items()},
                                    batch, k, steps, sos, eos)
    assert ttok.shape == (batch, k, steps) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=SCORE_TOL)
    if kind == "ties" and k > 1:
        # the forced ties do decide: some item has equal scores across beams
        s = tsc.numpy()
        assert (np.abs(np.diff(s, axis=1)) == 0).any()


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    values, idx = top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert values.tolist() == [[3.0, 3.0, 3.0], [2.0, 2.0, 2.0]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


# ------------------------------------------------------------ S2VT, RationaleNet

def test_s2vt_beam_decode_matches_jax(s2vt):
    jspec, jparams, tspec, tparams, feats = s2vt
    eos = jspec.sos_id + 1
    jtok, jsc = jdecode.s2vt_beam_decode(jparams, jspec, jnp.asarray(feats), K, eos)
    ttok, tsc = tdecode.s2vt_beam_decode(tparams, tspec, torch.from_numpy(feats), K, eos)
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
    # a seeded selection is the greedy forward's selection for that seed
    _, probs = trationale.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens",
                                rng=9)
    sel = tdecode._rationale_select(tparams, tspec, torch.from_numpy(feats),
                                    ts2vt.generator_for(9, "cpu"), None)
    assert torch.equal(sel, torch.from_numpy(feats) * probs[..., 1:2])


@pytest.mark.parametrize("arch", ["s2vt", "rationale"])
def test_bf16_beam_decode_matches_jax(arch):
    jspec, jparams, tspec, tparams, feats = _models(arch, "bfloat16", BF16_DIMS, BF16_B, 5)
    eos = jspec.sos_id + 1
    rng = jax.random.PRNGKey(0)
    jtok, _ = jdecode.decode_tokens(jparams, jspec, jnp.asarray(feats), eos, K, rng=rng)
    noise = _jax_gumbel(rng, (BF16_B, BF16_DIMS["num_frames"], 2))
    with torch.inference_mode():
        if arch == "s2vt":
            ttok, _ = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, K)
        else:
            ttok, _ = tdecode.rationale_beam_decode(
                tparams, tspec, torch.from_numpy(feats), K, eos,
                gumbel_noise=torch.from_numpy(noise))
    agreement = (ttok[:, 0].numpy() == np.asarray(jtok)[:, 0]).mean()
    assert agreement >= BF16_TOKEN_AGREEMENT


def _upto_eos(row, eos):
    row = list(row)
    return row[:row.index(eos) + 1] if eos in row else row


def test_beam_one_and_top_k_one_equal_greedy(s2vt):
    _, _, tspec, tparams, feats = s2vt
    eos = tspec.sos_id + 1
    x = torch.from_numpy(feats)
    greedy = ts2vt.apply(tparams, tspec, x, emit="tokens").numpy()
    beam, _ = tdecode.s2vt_beam_decode(tparams, tspec, x, 1, eos)
    sampled = tdecode.sample_tokens(tparams, tspec, x, eos, rng=3, top_k=1)
    for g, b_, s in zip(greedy, beam[:, 0].numpy(), sampled.numpy()):
        assert _upto_eos(b_, eos) == _upto_eos(g, eos) == _upto_eos(s, eos)


# ------------------------------------------------------------ sampling

@pytest.mark.parametrize("temperature, top_k, top_p", [
    (1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.8), (0.5, 4, 0.6), (1.0, 1, 0.0),
    (1.0, 0, 0.05)])
def test_sampling_filters_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(2).standard_normal((7, 40)).astype(np.float32) * 3
    logits[:, -5:] = tdecode.NEG_INF   # vocab padding
    want = np.asarray(jdecode.apply_sampling_filters(jnp.asarray(logits), temperature,
                                                     top_k, top_p))
    got = tdecode.apply_sampling_filters(torch.from_numpy(logits), temperature, top_k,
                                         top_p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_TOL)
    assert ((got == tdecode.NEG_INF) == (want == jdecode.NEG_INF)).all()


def _jax_sampling_noise(rng, steps, rows, vocab):
    """jax.random.categorical's Gumbel noise at each step of sample_search."""
    return np.stack([np.asarray(jax.random.gumbel(key, (rows, vocab), jnp.float32))
                     for key in jax.random.split(rng, steps)])


@pytest.mark.parametrize("temperature, top_k, top_p", [(1.0, 0, 0.0), (0.8, 6, 0.9)])
def test_sampling_with_jax_noise_matches_jax(s2vt, temperature, top_k, top_p):
    jspec, jparams, tspec, tparams, feats = s2vt
    eos = jspec.sos_id + 1
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jdecode.sample_tokens(jparams, jspec, jnp.asarray(feats), eos, rng,
                                            temperature, top_k, top_p))
    noise = _jax_sampling_noise(rng, DIMS["max_len"], B, tspec.padded_vocab_size)
    got = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 0,
                                temperature, top_k, top_p, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    # without injected noise: a seeded generator, deterministic per seed
    a = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 5, temperature)
    assert torch.equal(a, tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats),
                                                eos, 5, temperature))


# ------------------------------------------------------------ serving

def _patch_noise(monkeypatch, draws):
    """Serve ``draws`` in order to the port's Gumbel draws."""
    it = iter(draws)
    monkeypatch.setattr(tdecode, "sample_gumbel",
                        lambda shape, gen, device: torch.from_numpy(next(it)))


@pytest.mark.parametrize("family", ["s2vt", "rationale"])
@pytest.mark.parametrize("mode", ["beam", "sample"])
def test_captioner_matches_jax_serving(s2vt, rat, monkeypatch, family, mode):
    """build_captioner with beam_size=3, and with sampling, against
    vcr_tpu.serving (whose draws come from PRNGKey(0)), the port's draws
    replaced by the JAX package's noise."""
    jspec, jparams, tspec, tparams, feats = s2vt if family == "s2vt" else rat
    kw = {"beam_size": K} if mode == "beam" else {"sample_temperature": 0.9,
                                                  "sample_top_k": 8}
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none", **kw)(
        jnp.asarray(feats)))
    rng = jax.random.PRNGKey(0)
    draws = []
    if family == "rationale":
        rng, k_samp = jax.random.split(rng) if mode == "sample" else (rng, None)
        draws.append(_jax_gumbel(rng, (B, DIMS["num_frames"], 2)))
        rng = k_samp
    if mode == "sample":
        draws.extend(_jax_sampling_noise(rng, DIMS["max_len"], B,
                                         tspec.padded_vocab_size))
    _patch_noise(monkeypatch, draws)
    got = tserving.build_captioner(tparams, tspec, device="cpu", **kw)(feats)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kwargs", [
    {"beam_size": 3, "sample_temperature": 0.5}, {"sample_top_k": 3},
    {"sample_top_p": 0.9}])
def test_captioner_refuses_conflicting_decode_options(s2vt, kwargs):
    jspec, jparams, tspec, tparams, _ = s2vt
    if "beam_size" in kwargs:
        with pytest.raises(ValueError, match="mutually exclusive"):
            jserving.make_caption_fn(jspec, **kwargs)
    with pytest.raises(ValueError):
        tserving.build_captioner(tparams, tspec, device="cpu", **kwargs)


def test_decode_refusals(s2vt):
    _, _, tspec, tparams, feats = s2vt
    x = torch.from_numpy(feats)
    # int8 decode weights are ported (A13): an unknown mode still raises
    with pytest.raises(ValueError, match="decode_weights"):
        tdecode.decode_tokens(tparams, tspec, x, 1, 2, decode_weights="int4")
    # S2VT-att decodes since A9, SpatialNet since A11 and the Transformer
    # since A12; an unknown architecture takes the first's place, and the
    # Transformer's case holds what its modes still refuse, before its
    # encoder runs: int8 weights on the parity beam, an unknown cache mode
    with pytest.raises(NotImplementedError, match="Unknown"):
        tdecode.decode_tokens(tparams, tspec.with_(arch="lstm-lm"), x, 1, 2)
    with pytest.raises(NotImplementedError, match="Unknown"):
        tdecode.sample_tokens(tparams, tspec.with_(arch="lstm-lm"), x, 1)
    tf = tspec.with_(arch="transformer")
    with pytest.raises(NotImplementedError, match="parity beam"):
        tdecode.decode_tokens(tparams, tf, x, 1, 2, decode_weights="int8")
    with pytest.raises(ValueError, match="kv_cache"):
        tdecode.transformer_beam_decode_fast(tparams, tf, x, 2, 1, kv_cache="int2")
