"""The port's SpatialNet against the JAX package on the CPU (Pallas GRU in
interpret mode), from one JAX parameter tree, over both base captioners:
conv2d and the functional BatchNorm, S2VT's encode_step, the spatial
encoder (outputs, state, attention maps), the eval forward in float32 and
bf16, the beam and sampling decodes under the JAX package's own noise, and
the served captioner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import decode as jdecode
from vcr_tpu import serving as jserving
from vcr_tpu.models import s2vt as js2vt
from vcr_tpu.models import spatial as jspatial
from vcr_tpu.nn import layers as jlayers
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import s2vt as ts2vt
from vcr_tpu_torch.models import spatial as tspatial
from vcr_tpu_torch.nn import layers as tlayers

from test_torch_decode import _jax_sampling_noise

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
GRID, B, K = 4, 6, 3
BASES = ["s2vt", "s2vt-att"]
LOGIT_TOL = 1e-4     # float32 logits: sums in other orders through the conv
                     # trunk, 5 attended encoder steps and 6 decode steps;
                     # read 1.8e-7 (over S2VT) and 1.2e-7 (S2VT-att)
ALPHA_TOL = 1e-6     # float32 attention maps (softmax outputs in [0, 1]);
                     # read 3.0e-8
STATE_TOL = 1e-5     # float32 encoder outputs and state
SCORE_TOL = 1e-5     # float32 beam scores, log-probabilities over 6 steps
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=32, max_len=10,
                 num_frames=8)
BF16_B = 8
BF16_LOGIT_TOL = 2e-3      # the other captioners' bf16 bound: the same
                           # roundings, float32 sums in other orders; read
                           # 5.9e-6 (over S2VT) and 6.3e-4 (S2VT-att), maps
                           # 3.5e-5, tokens 100% equal
BF16_TOKEN_AGREEMENT = 0.98


def _models(base_arch="s2vt", compute_dtype="float32", dims=DIMS, b=B):
    """(JAX spec, JAX params, port spec, port params, feats (B, N, F, K, K)),
    one parameter tree; the BN running stats moved off their init values, so
    the eval forward reads them."""
    kw = dict(arch="spatial", base_arch=base_arch, grid_size=GRID,
              compute_dtype=compute_dtype, vocab_pad_to=8)
    jspec, jparams = graft._make_spec_and_params(**dims, use_pallas=True, **kw)
    tspec, _ = entry.make_spec_and_params(**dims, device="cpu", **kw)
    r = np.random.default_rng(5)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    for bn in ("bn1", "bn2"):
        h = dims["hidden"]
        jparams[bn] = dict(jparams[bn], mean=r.normal(0, 0.1, h).astype(np.float32),
                           var=r.uniform(0.5, 2.0, h).astype(np.float32))
    feats = r.standard_normal((b, dims["num_frames"], dims["vid_feat"], GRID, GRID)
                              ).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module", params=BASES)
def sp(request):
    return _models(request.param)


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("cdt, tol", [("float32", 1e-5), ("bfloat16", 1e-5)])
def test_conv2d_matches_jax(cdt, tol):
    """SAME 3x3 conv, NCHW/OIHW: the output rounded to the compute dtype,
    then the bias; and its gradients. Read: float32 1.9e-6, bf16 3.8e-6
    (one bf16 rounding of sums in other orders lands on the same value, or
    one ulp apart at these magnitudes)."""
    r = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(np.asarray, jlayers.conv2d_init(jax.random.PRNGKey(2),
                                                                6, 5, 3))
    x = r.standard_normal((3, 6, 4, 4)).astype(np.float32)
    cot = r.standard_normal((3, 5, 4, 4)).astype(np.float32)
    jdt, tdt = jnp.dtype(cdt), getattr(torch, cdt)

    def jf(p, xx):
        return jnp.sum(jlayers.conv2d(p, xx, compute_dtype=jdt) * cot)

    want = np.asarray(jlayers.conv2d(jp, jnp.asarray(x), compute_dtype=jdt))
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = bridge.from_jax_params(jp, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tlayers.conv2d(tp, tx, tdt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)
    if cdt == "bfloat16":     # with a zero bias: a bf16 number
        y = tlayers.conv2d({"w": tp["w"], "b": torch.zeros_like(tp["b"])}, tx,
                           tdt).detach()
        assert torch.equal(y, y.bfloat16().float())
    gw, gb, gx = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                     (tp["w"], tp["b"], tx))
    for g, w in ((gw, jgp["w"]), (gb, jgp["b"]), (gx, jgx)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-2 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(train, cdt):
    """Normalized output and the new running stats (train: batch mean and
    biased variance normalize, momentum 0.1 takes the unbiased variance;
    eval: the stored stats, unchanged) against vcr_tpu.nn.layers, on the
    output of a conv in ``cdt``."""
    r = np.random.default_rng(3)
    jp = dict(jax.tree_util.tree_map(np.asarray, jlayers.batchnorm_init(5)))
    jp.update(scale=r.uniform(0.5, 1.5, 5).astype(np.float32),
              bias=r.normal(0, 0.1, 5).astype(np.float32),
              mean=r.normal(0, 0.1, 5).astype(np.float32),
              var=r.uniform(0.5, 2.0, 5).astype(np.float32))
    jc = jax.tree_util.tree_map(np.asarray, jlayers.conv2d_init(jax.random.PRNGKey(4),
                                                                6, 5, 3))
    x = r.standard_normal((4, 6, 3, 3)).astype(np.float32)
    jx = jlayers.conv2d(jc, jnp.asarray(x), compute_dtype=jnp.dtype(cdt))
    tx = tlayers.conv2d(bridge.from_jax_params(jc, "cpu"), torch.from_numpy(x),
                        getattr(torch, cdt))
    jy, jnew = jlayers.batchnorm(jp, jx, train)
    tp = bridge.from_jax_params(jp, "cpu")
    ty, tnew = tlayers.batchnorm(tp, tx, train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    for k in ("scale", "bias", "mean", "var"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    if train:
        assert not torch.equal(tnew["mean"], tp["mean"])
    else:
        assert tnew is tp
    # functional: the input's stats are never written
    np.testing.assert_array_equal(tp["mean"].numpy(), jp["mean"])


def test_s2vt_encode_step_matches_jax():
    jspec, jparams = graft._make_spec_and_params(**DIMS, compute_dtype="float32",
                                                 vocab_pad_to=8)
    tspec, _ = entry.make_spec_and_params(**DIMS, compute_dtype="float32", vocab_pad_to=8,
                                          device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = bridge.from_jax_params(jparams, "cpu")
    r = np.random.default_rng(6)
    x = r.standard_normal((B, DIMS["vid_feat"])).astype(np.float32)
    h = r.standard_normal((B, DIMS["hidden"])).astype(np.float32)
    jout, jh = js2vt.encode_step(jparams, jspec, jnp.asarray(x), jnp.asarray(h))
    tout, th = ts2vt.encode_step(tparams, tspec, torch.from_numpy(x), torch.from_numpy(h))
    assert tout is th
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)


# ------------------------------------------------------------ the model

def test_encode_spatial_matches_jax(sp):
    """output1 (N, B, H), the final state and seq_alphas (B, N, K, K) in
    eval and train (the train BN state too)."""
    jspec, jparams, tspec, tparams, feats = sp
    for train in (False, True):
        jo, js, ja, jbn = jspatial.encode_spatial(jparams, jspec, jnp.asarray(feats), train)
        to, ts, ta, tbn = tspatial.encode_spatial(tparams, tspec, torch.from_numpy(feats),
                                                  train)
        assert to.shape == (DIMS["num_frames"], B, DIMS["hidden"])
        assert ta.shape == (B, DIMS["num_frames"], GRID, GRID)
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                                   atol=STATE_TOL)
        np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=0,
                                   atol=STATE_TOL)
        np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=0,
                                   atol=ALPHA_TOL)
        np.testing.assert_allclose(ta.sum(dim=(2, 3)).detach().numpy(), 1.0, atol=1e-6)
        for bn in ("bn1", "bn2"):
            for k in ("mean", "var"):
                np.testing.assert_allclose(tbn[bn][k].detach().numpy(),
                                           np.asarray(jbn[bn][k]), rtol=0, atol=1e-6)


def test_eval_apply_matches_jax(sp):
    """float32: logits within LOGIT_TOL, tokens identical, alphas within
    ALPHA_TOL; the eval BN state is the stored one."""
    jspec, jparams, tspec, tparams, feats = sp
    jl, ja, _ = jspatial.apply(jparams, jspec, jnp.asarray(feats), train=False)
    tl, ta, tbn = tspatial.apply(tparams, tspec, torch.from_numpy(feats))
    assert tl.shape == (B, DIMS["max_len"], 24) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=ALPHA_TOL)
    assert tbn["bn1"] is tparams["bn1"]
    tok, _, _ = tspatial.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens")
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("base_arch", BASES)
def test_bf16_eval_matches_jax(base_arch):
    """bf16 products, float32 state, vocab 300, H=128, F=32, K=4, N=8, B=8,
    L=10: logits within BF16_LOGIT_TOL, tokens at least
    BF16_TOKEN_AGREEMENT equal."""
    jspec, jparams, tspec, tparams, feats = _models(base_arch, "bfloat16", BF16_DIMS,
                                                    BF16_B)
    jl, ja, _ = jspatial.apply(jparams, jspec, jnp.asarray(feats), train=False)
    with torch.inference_mode():
        tl, ta, _ = tspatial.apply(tparams, tspec, torch.from_numpy(feats))
    want, got = np.asarray(jl), tl.numpy()
    valid = slice(0, BF16_DIMS["vocab_size"])
    assert np.abs(got[..., valid] - want[..., valid]).max() <= BF16_LOGIT_TOL
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= BF16_TOKEN_AGREEMENT
    assert np.abs(ta.numpy() - np.asarray(ja)).max() <= BF16_LOGIT_TOL


def test_train_logits_match_jax(sp):
    """The train branch at dropout 0 and teacher forcing 1.0: logits and the
    new BN state."""
    jspec, jparams, tspec, tparams, feats = sp
    jspec, tspec = jspec.with_(dropout_p=0.0), tspec.with_(dropout_p=0.0)
    s = np.random.default_rng(8).integers(0, DIMS["vocab_size"], (B, DIMS["max_len"]))
    jl, _, jbn = jspatial.apply(jparams, jspec, jnp.asarray(feats), jnp.asarray(s),
                                rng=jax.random.PRNGKey(0), train=True)
    tl, _, tbn = tspatial.apply(tparams, tspec, torch.from_numpy(feats),
                                torch.from_numpy(s), rng=0, train=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(tbn["bn2"]["var"].detach().numpy(),
                               np.asarray(jbn["bn2"]["var"]), rtol=0, atol=1e-6)


def test_unknown_base_raises(sp):
    _, _, tspec, tparams, feats = sp
    with pytest.raises(NotImplementedError, match="unknown video captioning arch"):
        tspatial.apply(tparams, tspec.with_(base_arch="transformer"),
                       torch.from_numpy(feats))
    assert tbase.build_model("spatial") == (tspatial.init_params, tspatial.apply)


# ------------------------------------------------------------ decode, serving

def test_beam_decode_matches_jax(sp):
    jspec, jparams, tspec, tparams, feats = sp
    eos = jspec.sos_id + 1
    jtok, jsc = jdecode.decode_tokens(jparams, jspec, jnp.asarray(feats), eos, K)
    ttok, tsc = tdecode.decode_tokens(tparams, tspec, torch.from_numpy(feats), eos, K)
    assert ttok.shape == (B, K, DIMS["max_len"]) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("temperature, top_k, top_p", [(1.0, 0, 0.0), (0.8, 6, 0.9)])
def test_sampling_with_jax_noise_matches_jax(sp, temperature, top_k, top_p):
    jspec, jparams, tspec, tparams, feats = sp
    eos = jspec.sos_id + 1
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jdecode.sample_tokens(jparams, jspec, jnp.asarray(feats), eos, rng,
                                            temperature, top_k, top_p))
    noise = _jax_sampling_noise(rng, DIMS["max_len"], B, tspec.padded_vocab_size)
    got = tdecode.sample_tokens(tparams, tspec, torch.from_numpy(feats), eos, 0,
                                temperature, top_k, top_p, gumbel=torch.from_numpy(noise))
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["greedy", "beam", "sample"])
def test_captioner_matches_jax_serving(sp, monkeypatch, mode):
    """build_captioner greedy, at beam 3 and sampling, against
    vcr_tpu.serving (whose sampling draws come from PRNGKey(0)), the port's
    draws replaced by the JAX package's noise."""
    jspec, jparams, tspec, tparams, feats = sp
    kw = {"greedy": {}, "beam": {"beam_size": K},
          "sample": {"sample_temperature": 0.9, "sample_top_k": 8}}[mode]
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none", **kw)(
        jnp.asarray(feats)))
    it = iter(_jax_sampling_noise(jax.random.PRNGKey(0), DIMS["max_len"], B,
                                  tspec.padded_vocab_size))
    monkeypatch.setattr(tdecode, "sample_gumbel",
                        lambda shape, gen, device: torch.from_numpy(next(it)))
    got = tserving.build_captioner(tparams, tspec, device="cpu", **kw)(feats)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the YOLO featurizer is ported (A17; tests/test_torch_featurize.py): it
    # needs its Darknet
    with pytest.raises(ValueError, match="needs feat_params"):
        tserving.build_captioner(tparams, tspec, featurizer="yolo", device="cpu")
