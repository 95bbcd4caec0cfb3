"""The int8 decode weights of the GRU families (S2VT, S2VT-att, and
RationaleNet and SpatialNet over S2VT) and the quantized slot pool of all
five families, against the JAX package's on the CPU in float32, from one
JAX parameter tree: ``decode_tokens``' int8-weight beam, ``build_captioner``,
int8-weight sampling, the pool in every mode the JAX package's pool serves
(greedy, beam, sampling), and within a mode the pool against the batch
decode."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu import decode as jdecode
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch import serving_continuous as tsc
from vcr_tpu_torch.models import transformer as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_decode import _jax_gumbel  # noqa: E402
from test_torch_quant_serving import GRU_ARCHS, K, MODES, SCORE_TOL  # noqa: E402
from test_torch_serving_continuous import (N_REQ, _assert_same, _cut, _eos,  # noqa: E402
                                           _models, _sample_noise_jax, _serve_both)


# ---------------------------------------------------------------- GRU families

@pytest.fixture(scope="module", params=GRU_ARCHS)
def gru(request):
    return _models(request.param)


def test_gru_w8_beam_matches_jax(gru):
    """decode_tokens' int8-weight beam (RationaleNet under JAX's own
    selection noise): tokens equal, scores within SCORE_TOL; and
    build_captioner's beam forwards the mode."""
    jspec, jparams, tspec, tparams, feats = gru
    eos = _eos(tspec)
    jx, tx = jnp.asarray(feats), torch.from_numpy(feats)
    if tspec.arch == "rationale":
        rng = jax.random.PRNGKey(4)
        noise = torch.from_numpy(_jax_gumbel(rng, (len(feats), tspec.num_frames, 2)))
        jt, js = jdecode.rationale_beam_decode(jparams, jspec, jx, K, eos, rng=rng,
                                               decode_weights="int8")
        tt, ts = tdecode.rationale_beam_decode(tparams, tspec, tx, K, eos,
                                               gumbel_noise=noise, decode_weights="int8")
    else:
        jt, js = jdecode.decode_tokens(jparams, jspec, jx, eos, K, decode_weights="int8")
        tt, ts = tdecode.decode_tokens(tparams, tspec, tx, eos, K, decode_weights="int8")
        cap = tserving.build_captioner(tparams, tspec, beam_size=K, decode_weights="int8",
                                       device="cpu")
        assert torch.equal(cap(feats), tt[:, 0])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    # the mode is not dropped: the float weights score otherwise
    assert not torch.equal(tdecode.decode_tokens(tparams, tspec, tx, eos, K)[1], ts)


def test_gru_w8_sampling_top_k_one_equals_w8_beam_one(gru):
    """The int8-weight sampling decode: top_k=1 is argmax, so it gives the
    int8-weight beam-1 tokens up to the first eos (RationaleNet's selection
    comes first from seed 0 in both)."""
    _, _, tspec, tparams, feats = gru
    eos, tx = _eos(tspec), torch.from_numpy(feats)
    beam = tdecode.decode_tokens(tparams, tspec, tx, eos, 1, decode_weights="int8")[0][:, 0]
    sampled = tdecode.sample_tokens(tparams, tspec, tx, eos, 0, 1.0, 1,
                                    decode_weights="int8")
    for a, b in zip(_cut(beam.numpy(), eos), _cut(sampled.numpy(), eos)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the pool

POOL_CASES = ([(arch, "bf16", "int8") for arch in GRU_ARCHS]
              + [("transformer", kv, dw) for kv, dw in MODES])


@pytest.mark.parametrize("arch,kv,dw", POOL_CASES,
                         ids=[f"{a}-{kv}-{dw}" for a, kv, dw in POOL_CASES])
def test_quantized_pool_matches_jax_pool(arch, kv, dw):
    """The slot pool in a quantized mode against JAX's pool in that mode:
    the same harvested tokens."""
    family = _models(arch)
    modes = {"kv_cache": kv, "decode_weights": dw}
    want, got, pool = _serve_both(family, modes, modes)
    _assert_same(got, want)
    assert (pool.kv_cache, pool.decode_weights) == (kv, dw)


@pytest.mark.parametrize("arch", ["s2vt", "transformer"])
def test_quantized_beam_pool_matches_jax_pool(arch):
    """Beam 3 in the pool: S2VT under int8 weights, the Transformer's
    lineage slot stepper under an int8 cache and int8 weights."""
    family = _models(arch)
    modes = {"beam_size": K, "decode_weights": "int8",
             **({"kv_cache": "int8"} if arch == "transformer" else {})}
    want, got, _ = _serve_both(family, modes, modes)
    _assert_same(got, want)


def test_w8_sampling_pool_matches_jax_pool():
    """Per-slot sampling on int8 weights, under JAX's own noise."""
    family = _models("s2vt")
    modes = {"decode_weights": "int8", "sample_temperature": 0.8, "sample_top_k": 5}
    want, got, _ = _serve_both(family, modes,
                               dict(modes, sample_noise=_sample_noise_jax(family[2], 0)))
    _assert_same(got, want)


@pytest.mark.parametrize("arch,kv,dw", [(a, "bf16", "int8") for a in GRU_ARCHS]
                         + [("transformer", "int4", "int8"), ("transformer", "int8", "bf16")])
def test_pool_equals_batch_within_mode(arch, kv, dw):
    """Within a mode the pool's tokens are the batch decode's cut at the
    first eos (the counterparts of the JAX package's
    test_weight_quant.py:207 and :307): the GRU families against
    decode_tokens' int8-weight beam 1 (RationaleNet under zero selection
    noise in both), the Transformer against decode_greedy_fast."""
    _, _, tspec, tparams, feats = _models(arch)
    eos = _eos(tspec)
    x = torch.from_numpy(feats)
    extra = {}
    if arch == "rationale":
        zeros = torch.zeros((len(feats), tspec.num_frames, 2))
        rows = tdecode.rationale_beam_decode(tparams, tspec, x, 1, eos, gumbel_noise=zeros,
                                             decode_weights=dw)[0][:, 0]
        extra["select_noise"] = lambda c: np.zeros((2, tspec.num_frames, 2), np.float32)
    elif arch == "transformer":
        rows = ttr.decode_greedy_fast(tparams, tspec,
                                      ttr.encode(tparams, tspec, x, ttr.create_masks_inp(x)),
                                      kv_cache=kv, decode_weights=dw)
    else:
        rows = tdecode.decode_tokens(tparams, tspec, x, eos, 1, decode_weights=dw)[0][:, 0]
    pool = tsc.ContinuousCaptioner(tparams, tspec, slots=3, admit_chunk=2, step_chunk=2,
                                   eos_id=eos, kv_cache=kv, decode_weights=dw,
                                   device="cpu", **extra)
    got = pool.caption_all({i: feats[i] for i in range(N_REQ)})
    for i, want in enumerate(_cut(rows.numpy(), eos)):
        np.testing.assert_array_equal(got[i], want)


def test_pool_beam_equals_lineage_batch_beam_within_mode():
    """The Transformer's beam pool under int4 caches and int8 weights: each
    slot's harvest is the lineage batch beam's best row, cut."""
    _, _, tspec, tparams, feats = _models("transformer")
    eos = _eos(tspec)
    modes = {"kv_cache": "int4", "decode_weights": "int8"}
    rows = tdecode.transformer_beam_decode_fast(tparams, tspec, torch.from_numpy(feats), K,
                                                eos, lineage=True, **modes)[0][:, 0]
    pool = tsc.ContinuousCaptioner(tparams, tspec, slots=3, admit_chunk=2, step_chunk=2,
                                   eos_id=eos, beam_size=K, device="cpu", **modes)
    got = pool.caption_all({i: feats[i] for i in range(N_REQ)})
    for i, want in enumerate(_cut(rows.numpy(), eos)):
        np.testing.assert_array_equal(got[i], want)
