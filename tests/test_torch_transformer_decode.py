"""The port's Transformer decodes against the JAX package on the CPU, from one
JAX parameter tree: the KV-cached greedy decode, the parity beam, the
KV-cached beams with gathered caches and with lineage, sampling under the
JAX package's own noise, serving; the cache machinery against the parity
decode with the sqrt(i+1) scale neutralized; the lineage bookkeeping against
a physical reorder, bit for bit; build_captioner's argument order; and the
quantized modes against JAX's (test_torch_quant_serving.py holds them step
by step)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu import decode as jdecode
from vcr_tpu import serving as jserving
from vcr_tpu.models import transformer as jtr
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import transformer as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_transformer import (B, BF16_B, BF16_TOKEN_AGREEMENT, DIMS,  # noqa: E402
                                    models)

K = 3
SCORE_TOL = 1e-5     # float32 beam scores: log-probabilities summed over 7
                     # steps, sums in other orders


@pytest.fixture(scope="module")
def f32():
    return models()


def _encoded(jspec, jparams, tspec, tparams, feats):
    jx, tx = jnp.asarray(feats), torch.from_numpy(feats)
    jeo = jtr.encode(jparams, jspec, jx, jtr.create_masks_inp(jx), jax.random.PRNGKey(0),
                     train=False)
    return jeo, ttr.encode(tparams, tspec, tx, ttr.create_masks_inp(tx))


def _eos(spec):
    return spec.sos_id + 1


# ---------------------------------------------------------------- greedy

def test_fast_greedy_matches_jax(f32):
    jeo, teo = _encoded(*f32)
    want = np.asarray(jtr.decode_greedy_fast(f32[1], f32[0], jeo))
    got = ttr.decode_greedy_fast(f32[3], f32[2], teo)
    assert got.dtype == torch.int32 and got.shape == (B, DIMS["max_len"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_fast_greedy_matches_jax():
    """bf16 on the features cast as serving casts them: tokens at least 98%
    equal (read 100%)."""
    jspec, jparams, tspec, tparams, feats = models("bfloat16", b=BF16_B)
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none")(
        jnp.asarray(feats)))
    got = tserving.build_captioner(tparams, tspec, device="cpu")(feats)
    assert (got.numpy() == want).mean() >= BF16_TOKEN_AGREEMENT


def test_cache_machinery_equals_parity_with_the_scale_neutralized(f32, monkeypatch):
    """With the sqrt(prefix length) scale at 1 the KV-cached decode must give
    the parity decode's tokens: the caches are then the same arithmetic
    (the two differ by design only through that scale). The scale as is
    gives other tokens here."""
    jspec, jparams, tspec, tparams, feats = f32
    _, teo = _encoded(*f32)
    mask = ttr.create_masks_inp(torch.from_numpy(feats))
    scaled = ttr.decode_greedy(tparams, tspec, teo, mask).argmax(-1)
    monkeypatch.setattr(ttr, "_pe_scale", lambda n: 1.0)
    parity = ttr.decode_greedy(tparams, tspec, teo, mask).argmax(-1).to(torch.int32)
    fast = ttr.decode_greedy_fast(tparams, tspec, teo)
    assert torch.equal(fast, parity)
    assert not torch.equal(scaled.to(torch.int32), parity)


# ---------------------------------------------------------------- beams

def _assert_beam_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=SCORE_TOL)


def test_parity_beam_matches_jax(f32):
    jspec, jparams, tspec, tparams, feats = f32
    eos = _eos(tspec)
    want = jdecode.decode_tokens(jparams, jspec, jnp.asarray(feats), eos, K)
    got = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, K)
    assert got[0].shape == (B, K, DIMS["max_len"])
    _assert_beam_equal(got, want)


@pytest.mark.parametrize("lineage", [False, True], ids=["gather", "lineage"])
def test_fast_beam_matches_jax(f32, lineage):
    jspec, jparams, tspec, tparams, feats = f32
    eos = _eos(tspec)
    want = jdecode.transformer_beam_decode_fast(jparams, jspec, jnp.asarray(feats), K, eos,
                                                lineage=lineage)
    got = tdecode.transformer_beam_decode_fast(tparams, tspec, torch.from_numpy(feats), K,
                                               eos, lineage=lineage)
    _assert_beam_equal(got, want)


@pytest.mark.parametrize("fast", [False, True], ids=["parity", "fast"])
def test_beam_width_one_equals_greedy(f32, fast):
    """Width 1's tokens equal the greedy decode's up to and including the
    first eos (after it the search holds finished rows at eos)."""
    _, _, tspec, tparams, feats = f32
    eos = _eos(tspec)
    x = torch.from_numpy(feats)
    if fast:
        greedy = tserving.build_captioner(tparams, tspec, device="cpu")(x)
        beam = tdecode.transformer_beam_decode_fast(tparams, tspec, x, 1, eos)[0][:, 0]
    else:
        greedy = ttr.apply(tparams, tspec, x, emit="tokens")
        beam = tdecode.decode_tokens(tparams, tspec, x, eos, 1)[0][:, 0]
    for g_row, b_row in zip(greedy.tolist(), beam.tolist()):
        end = g_row.index(eos) + 1 if eos in g_row else len(g_row)
        assert b_row[:end] == g_row[:end]


def _lineage_beam(tspec, tparams, feats, k, physical):
    """The lineage stepper's beam search, its caches reordered through the
    ancestry or, with ``physical``, gathered with their beams under an
    identity ancestry (the textbook bookkeeping)."""
    x = torch.from_numpy(feats)
    e_out = ttr.encode(tparams, tspec, x.to(tspec.cdtype), ttr.create_masks_inp(x))
    step_fn, init, reorder = ttr.make_cached_stepper(tparams, tspec, e_out, beam_tile=k,
                                                     lineage=True)
    if physical:
        identity = init["anc"]

        def reorder(state, flat_src):  # noqa: F811
            moved = tdecode.gather_rows({n: v for n, v in state.items() if n != "anc"},
                                        flat_src)
            return dict(moved, anc=identity)
    return tdecode.beam_search(step_fn, init, x.shape[0], k, tspec.max_len, tspec.sos_id,
                               _eos(tspec), reorder_fn=reorder)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_lineage_bookkeeping_equals_physical_reorder(cdt):
    """The same lineage stepper, its caches left in place behind the
    ancestry or physically reordered: tokens and scores bit for bit (as
    tests/test_lineage_bookkeeping.py holds the JAX package's)."""
    for seed in (0, 1):
        _, _, tspec, tparams, feats = models(cdt, dict(DIMS, max_len=8), seed=seed)
        anc = _lineage_beam(tspec, tparams, feats, 4, physical=False)
        phy = _lineage_beam(tspec, tparams, feats, 4, physical=True)
        assert torch.equal(anc[0], phy[0]) and torch.equal(anc[1], phy[1])


def test_lineage_and_gather_steppers_in_lockstep():
    """bf16: the lineage and gather steppers given the same words and the same
    reorders each step stay within tpu_checks.py's 0.5 logit gap (products
    of other shapes; a fault of the bookkeeping would be O(1))."""
    _, _, tspec, tparams, feats = models("bfloat16", b=6)
    x = torch.from_numpy(feats).to(tspec.cdtype)
    e_out = ttr.encode(tparams, tspec, x, ttr.create_masks_inp(x))
    step_l, st_l, reorder_l = ttr.make_cached_stepper(tparams, tspec, e_out, beam_tile=K,
                                                      lineage=True)
    step_g, st_g = ttr.make_cached_stepper(tparams, tspec, e_out, beam_tile=K)
    g = torch.Generator().manual_seed(42)
    gap = 0.0
    for i in range(tspec.max_len):
        words = torch.randint(0, tspec.vocab_size, (6 * K,), generator=g, dtype=torch.int32)
        if i > 0:
            flat = (torch.arange(6)[:, None] * K
                    + torch.randint(0, K, (6, K), generator=g)).reshape(-1)
            st_l, st_g = reorder_l(st_l, flat), tdecode.gather_rows(st_g, flat)
        st_l, lg_l = step_l(st_l, words, i)
        st_g, lg_g = step_g(st_g, words, i)
        gap = max(gap, (lg_l - lg_g).abs().max().item())
    assert gap < 0.5


# ---------------------------------------------------------------- sampling and serving

def _jax_sampling_noise(rng, steps, rows, vocab):
    """jax.random.categorical's Gumbel noise at each step of sample_search."""
    return np.stack([np.asarray(jax.random.gumbel(key, (rows, vocab), jnp.float32))
                     for key in jax.random.split(rng, steps)])


@pytest.mark.parametrize("temperature, top_k, top_p", [(1.0, 0, 0.0), (0.8, 6, 0.9)])
def test_sampling_under_jax_noise_matches_jax(f32, temperature, top_k, top_p):
    jspec, jparams, tspec, tparams, feats = f32
    eos, rng = _eos(tspec), jax.random.PRNGKey(7)
    want = np.asarray(jdecode.sample_tokens(jparams, jspec, jnp.asarray(feats), eos, rng,
                                            temperature, top_k, top_p))
    noise = _jax_sampling_noise(rng, DIMS["max_len"], B, tspec.padded_vocab_size)
    got = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 0, temperature,
                                top_k, top_p, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    # top_k=1 is the KV-cached greedy decode up to the first eos
    greedy = tserving.build_captioner(tparams, tspec, device="cpu")(feats).tolist()
    sampled = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 3, 1.0,
                                    1).tolist()
    for g_row, s_row in zip(greedy, sampled):
        end = g_row.index(eos) + 1 if eos in g_row else len(g_row)
        assert s_row[:end] == g_row[:end]


@pytest.mark.parametrize("kw", [{}, {"beam_size": K},
                                {"sample_temperature": 0.9, "sample_top_k": 8}],
                         ids=["greedy", "beam", "sample"])
def test_captioner_matches_jax_serving(f32, monkeypatch, kw):
    """build_captioner against vcr_tpu.serving: the KV-cached greedy, the
    gathered-cache beam, and sampling with the port's draws replaced by the
    JAX package's noise (its draws come from PRNGKey(0))."""
    jspec, jparams, tspec, tparams, feats = f32
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none", **kw)(
        jnp.asarray(feats)))
    if "sample_temperature" in kw:
        it = iter(_jax_sampling_noise(jax.random.PRNGKey(0), DIMS["max_len"], B,
                                      tspec.padded_vocab_size))
        monkeypatch.setattr(tdecode, "sample_gumbel",
                            lambda shape, gen, device: torch.from_numpy(next(it)))
    got = tserving.build_captioner(tparams, tspec, device="cpu", **kw)(feats)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_captioner_takes_jax_argument_order(f32):
    """One positional call, (params, spec, featurizer, feat_params, rng,
    beam_size), means the same in both packages: beam 3 on precomputed
    features."""
    jspec, jparams, tspec, tparams, feats = f32
    want = np.asarray(jserving.build_captioner(jparams, jspec, "none", None, None, 3)(
        jnp.asarray(feats)))
    got = tserving.build_captioner(tparams, tspec, "none", None, None, 3, device="cpu")(feats)
    np.testing.assert_array_equal(got.numpy(), want)
    beam = tdecode.transformer_beam_decode_fast(tparams, tspec, torch.from_numpy(feats), 3,
                                                _eos(tspec))[0][:, 0]
    assert torch.equal(got, beam)
    with pytest.raises(NotImplementedError, match="A17"):
        tserving.build_captioner(tparams, tspec, "none", {"w": 0}, device="cpu")


@pytest.mark.parametrize("kw", [{"kv_cache": "int8"}, {"kv_cache": "int4"},
                                {"decode_weights": "int8"},
                                {"beam_size": K, "kv_cache": "int8"}])
def test_quantized_modes_raise_naming_a13(f32, kw):
    """The quantized modes are ported (A13); the cases keep their ids and
    run each mode against JAX's: build_captioner's tokens, and the KV-cached
    greedy and beam. What still raises: int8 weights on the parity beam,
    which has no stepper."""
    jspec, jparams, tspec, tparams, feats = f32
    x, jx = torch.from_numpy(feats), jnp.asarray(feats)
    want = jserving.build_captioner(jparams, jspec, featurizer="none", **kw)(jx)
    got = tserving.build_captioner(tparams, tspec, device="cpu", **kw)(feats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    step_kw = {k: v for k, v in kw.items() if k != "beam_size"}
    jeo, teo = _encoded(*f32)
    np.testing.assert_array_equal(
        ttr.decode_greedy_fast(tparams, tspec, teo, **step_kw).numpy(),
        np.asarray(jtr.decode_greedy_fast(jparams, jspec, jeo, **step_kw)))
    _assert_beam_equal(
        tdecode.transformer_beam_decode_fast(tparams, tspec, x, K, _eos(tspec), **step_kw),
        jdecode.transformer_beam_decode_fast(jparams, jspec, jx, K, _eos(jspec), **step_kw))
    if "decode_weights" in kw:
        with pytest.raises(NotImplementedError, match="parity beam"):
            tdecode.decode_tokens(tparams, tspec, x, 1, K, decode_weights="int8")
