"""The quantized serving modes of the port (int8/int4 K/V caches, int8
decode weights) against the JAX package's on the CPU in float32, from one
JAX parameter tree: the Transformer's KV-cached stepper (plain and lineage,
under beam reorders) and its slot stepper step by step, its greedy and
beams through ``build_captioner`` and ``decode``; the refusals that stand.
The GRU families and the slot pool: ``test_torch_quant_pool.py``."""

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
from vcr_tpu_torch import serving_continuous as tsc
from vcr_tpu_torch.models import transformer as ttr
from vcr_tpu_torch.ops import kvquant

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_serving_continuous import _eos, _models  # noqa: E402

# (kv_cache, decode_weights): every quantized combination the JAX package serves
MODES = [("int8", "bf16"), ("int4", "bf16"), ("bf16", "int8"), ("int8", "int8"),
         ("int4", "int8")]
MODE_IDS = [f"{kv}-{dw}" for kv, dw in MODES]
K = 3
STEPS = 4            # stepper steps held against JAX's (of max_len 7)
LOGIT_TOL = 1e-4     # float32 logits of a quantized stepper against JAX's while
                     # every code agrees: sums in other orders through 2 layers
                     # and 4 steps (read <= 1.2e-6, no code differed)
SCALE_RTOL = 1e-6    # a scale is max|v| / qmax of float32 products whose sums
                     # differ from XLA's in the last bit
ENVELOPE = {"int8": 0.05, "int4": 0.8, "bf16": LOGIT_TOL}  # tests/test_kv_quant.py:185
SCORE_TOL = 1e-5     # float32 beam scores, as test_torch_decode.py's
GRU_ARCHS = ["s2vt", "s2vt-att", "spatial", "rationale"]


@pytest.fixture(scope="module")
def tf32():
    return _models("transformer")


def _encoded(jspec, jparams, tspec, tparams, feats):
    jx, tx = jnp.asarray(feats), torch.from_numpy(feats)
    jeo = jtr.encode(jparams, jspec, jx, jtr.create_masks_inp(jx), jax.random.PRNGKey(0),
                     train=False)
    return jeo, ttr.encode(tparams, tspec, tx, ttr.create_masks_inp(tx))


def _codes(leaf):
    """A cache leaf as numpy: int codes (the port's int4 unpacked), or scales."""
    if isinstance(leaf, torch.Tensor):
        leaf = kvquant.unpack(leaf) if leaf.dtype in (torch.int8, torch.uint8) else leaf
        return leaf.float().numpy()
    return np.asarray(leaf).astype(np.float32)


def _cache_code_diffs(tstate, jstate, kv):
    """Hold every cache leaf against JAX's: the ancestry bit for bit, the
    scales within SCALE_RTOL, a bf16 cache within LOGIT_TOL, and return the count of
    codes that differ (a last-bit difference of a product can put a value on
    the other side of a rounding)."""
    diffs = 0
    for name, jleaves in jstate.items():
        if name == "anc":
            np.testing.assert_array_equal(tstate[name].numpy(), np.asarray(jleaves))
            continue
        assert len(tstate[name]) == len(jleaves) == (2 if kv == "bf16" else 4)
        for j, (t, w) in enumerate(zip(tstate[name], jleaves)):
            if kv == "bf16":
                np.testing.assert_allclose(_codes(t), _codes(w), rtol=0, atol=LOGIT_TOL,
                                           err_msg=name)
            elif j % 2 == 0:
                diffs += int((_codes(t) != _codes(w)).sum())
            else:
                np.testing.assert_allclose(_codes(t), _codes(w), rtol=SCALE_RTOL,
                                           atol=1e-30, err_msg=name)
    return diffs


def _assert_logits(errs, diffs, kv):
    """Logits within LOGIT_TOL while every code agrees, else within the JAX
    package's own envelope of the mode (tests/test_kv_quant.py)."""
    bound = LOGIT_TOL if diffs == 0 else ENVELOPE[kv]
    assert max(errs) <= bound, (max(errs), diffs)


@pytest.mark.parametrize("lineage", [False, True], ids=["plain", "lineage"])
@pytest.mark.parametrize("kv,dw", MODES, ids=MODE_IDS)
def test_cached_stepper_matches_jax(tf32, kv, dw, lineage):
    """The same words through both steppers, and in the lineage form the
    same random within-item beam reorders after each step: logits within
    LOGIT_TOL, every cache code and scale equal."""
    jspec, jparams, tspec, tparams, feats = tf32
    jeo, teo = _encoded(*tf32)
    jeo, teo, feats = jeo[:3], teo[:3], feats[:3]
    bt = K if lineage else 1
    jout = jtr.make_cached_stepper(jparams, jspec, jeo, beam_tile=bt, lineage=lineage,
                                   kv_cache=kv, decode_weights=dw)
    tout = ttr.make_cached_stepper(tparams, tspec, teo, beam_tile=bt, lineage=lineage,
                                   kv_cache=kv, decode_weights=dw)
    (jstep, jst), (tstep, tst) = jout[:2], tout[:2]
    rows = feats.shape[0] * bt
    rng = np.random.default_rng(5)
    errs = []
    for i in range(STEPS):
        words = rng.integers(0, tspec.vocab_size, size=rows).astype(np.int32)
        jst, jl = jstep(jst, jnp.asarray(words), i)
        tst, tl = tstep(tst, torch.from_numpy(words), i)
        errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
        if lineage:
            flat_src = (np.arange(rows) // bt * bt
                        + rng.integers(0, bt, size=rows)).astype(np.int32)
            jst = jout[2](jst, jnp.asarray(flat_src))
            tst = tout[2](tst, torch.from_numpy(flat_src).long())
    diffs = _cache_code_diffs(tst, jst, kv)
    print(f"max logit gap {max(errs):.3g}, {diffs} codes differ")
    _assert_logits(errs, diffs, kv)


@pytest.mark.parametrize("lineage", [False, True], ids=["plain", "lineage"])
@pytest.mark.parametrize("kv,dw", MODES, ids=MODE_IDS)
def test_slot_stepper_matches_jax(tf32, kv, dw, lineage):
    """Per-row positions (slots admitted at different times), the JAX
    package's slot stepper: logits within LOGIT_TOL, caches equal."""
    jspec, jparams, tspec, tparams, feats = tf32
    jeo, teo = _encoded(*tf32)
    jeo, teo, feats = jeo[:4], teo[:4], feats[:4]
    bt = K if lineage else 1
    rows = feats.shape[0] * bt
    jstep, jinit, jcross = jtr.make_slot_stepper(jparams, jspec, beam_tile=bt,
                                                 lineage=lineage, kv_cache=kv,
                                                 decode_weights=dw)
    tstep, tinit, tcross = ttr.make_slot_stepper(tparams, tspec, beam_tile=bt,
                                                 lineage=lineage, kv_cache=kv,
                                                 decode_weights=dw)
    jst = {**jinit(rows), **jcross(jnp.repeat(jeo, bt, axis=0))}
    tst = {**tinit(rows), **tcross(teo.repeat_interleave(bt, 0))}
    start = np.repeat(np.arange(rows // bt) % 4, bt)       # ragged positions
    rng = np.random.default_rng(6)
    errs = []
    for s in range(STEPS):
        i_vec = np.minimum(start + s, tspec.max_len - 1).astype(np.int32)
        words = rng.integers(0, tspec.vocab_size, size=rows).astype(np.int32)
        jst, jl = jstep(jst, jnp.asarray(words), jnp.asarray(i_vec))
        tst, tl = tstep(tst, torch.from_numpy(words), torch.from_numpy(i_vec))
        errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
    diffs = _cache_code_diffs(tst, jst, kv)
    print(f"max logit gap {max(errs):.3g}, {diffs} codes differ")
    _assert_logits(errs, diffs, kv)


@pytest.mark.parametrize("kv,dw", MODES, ids=MODE_IDS)
def test_transformer_decodes_match_jax(tf32, kv, dw):
    """The KV-cached greedy through build_captioner, and the gathered and
    lineage beams: tokens equal to JAX's in the same mode."""
    jspec, jparams, tspec, tparams, feats = tf32
    eos = _eos(tspec)
    modes = {"kv_cache": kv, "decode_weights": dw}
    want = jserving.build_captioner(jparams, jspec, featurizer="none", **modes)(
        jnp.asarray(feats))
    got = tserving.build_captioner(tparams, tspec, device="cpu", **modes)(feats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for lineage in (False, True):
        jt, js = jdecode.transformer_beam_decode_fast(jparams, jspec, jnp.asarray(feats), K,
                                                      eos, lineage=lineage, **modes)
        tt, ts = tdecode.transformer_beam_decode_fast(tparams, tspec,
                                                      torch.from_numpy(feats), K, eos,
                                                      lineage=lineage, **modes)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)


def test_int4_cache_holds_a_quarter_of_the_bytes(tf32):
    """int4 codes really take half a byte each: a layer's stored codes are
    a quarter of the bf16 cache's bytes, int8's a half."""
    _, _, tspec, tparams, feats = tf32
    _, teo = _encoded(*tf32)
    sizes = {}
    for kv in ("bf16", "int8", "int4"):
        _, st = ttr.make_cached_stepper(tparams, tspec.with_(compute_dtype="bfloat16"),
                                        teo, kv_cache=kv)
        sizes[kv] = sum(t.numel() * t.element_size() for t in st["c0"]
                        if t.dtype != torch.float32)
    assert sizes["int8"] * 2 == sizes["bf16"] == sizes["int4"] * 4


# ---------------------------------------------------------------- what stands

def test_bf16_mode_is_the_default_path(tf32):
    """``"bf16"`` given explicitly is the unquantized path, bit for bit."""
    _, _, tspec, tparams, feats = tf32
    _, teo = _encoded(*tf32)
    base = ttr.decode_greedy_fast(tparams, tspec, teo)
    assert torch.equal(base, ttr.decode_greedy_fast(tparams, tspec, teo, kv_cache="bf16",
                                                    decode_weights="bf16"))


@pytest.fixture(scope="module", params=GRU_ARCHS)
def gru(request):
    return _models(request.param)


def test_refusals_that_stand(gru, tf32):
    """The GRU families' greedy batch decode has no int8-weight form and
    their quantized KV cache has no cache to quantize (ValueError, where the
    JAX package drops the first); the Transformer's parity beam refuses int8
    weights as the JAX package's does; an unknown mode raises."""
    _, _, tspec, tparams, feats = gru
    with pytest.raises(ValueError, match="slot pool"):
        tserving.build_captioner(tparams, tspec, decode_weights="int8", device="cpu")
    for kw in ({"kv_cache": "int8"}, {"kv_cache": "int4", "beam_size": K}):
        with pytest.raises(ValueError, match="has none"):
            tserving.build_captioner(tparams, tspec, device="cpu", **kw)
        with pytest.raises(ValueError, match="has none"):
            tsc.ContinuousCaptioner(tparams, tspec, slots=2, admit_chunk=1, device="cpu",
                                    kv_cache=kw["kv_cache"])
    jspec, jparams, ttspec, ttparams, tfeats = tf32
    x = torch.from_numpy(tfeats)
    with pytest.raises(NotImplementedError, match="parity"):
        tdecode.decode_tokens(ttparams, ttspec, x, 1, K, decode_weights="int8")
    with pytest.raises(NotImplementedError):
        jdecode.decode_tokens(jparams, jspec, jnp.asarray(tfeats), 1, K,
                              decode_weights="int8")
    with pytest.raises(ValueError, match="kv_cache"):
        ttr.make_cached_stepper(ttparams, ttspec, x, kv_cache="int2")
    with pytest.raises(ValueError, match="decode_weights"):
        tsc.ContinuousCaptioner(ttparams, ttspec, slots=2, admit_chunk=1, device="cpu",
                                decode_weights="int4")
