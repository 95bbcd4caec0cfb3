"""The port's S2VT-att against the JAX package on the CPU (Pallas GRU in
interpret mode), from one JAX parameter tree: Bahdanau attention, the eval
forward (logits and greedy tokens, float32 and bf16), the train branch's
logits, and ``AttentionScan``'s hand-scheduled backward against autograd of
the plain loop and ``jax.grad`` through ``s2vt_att._attention_scan``, as
``tests/test_att_scan_vjp.py`` holds the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import __graft_entry__ as graft
from vcr_tpu import serving as jserving
from vcr_tpu.models import s2vt_att as js2vt_att
from vcr_tpu.nn import attention as jattention
from vcr_tpu.nn.rnn import gru_init as jgru_init
from vcr_tpu.train import losses as jlosses
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import s2vt_att as ts2vt_att
from vcr_tpu_torch.nn import attention as tattention
from vcr_tpu_torch.train import losses as tlosses

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 6
LOGIT_TOL = 1e-5     # float32 sums in other orders through 5 encoder and 6
                     # decode steps; read 1.8e-7
BF16_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
BF16_B = 32
BF16_LOGIT_TOL = 2e-3      # the bound of test_torch_s2vt.py's bf16 test: the
                           # same roundings, sums in other orders; read 1.0e-3,
                           # tokens 100% equal
BF16_TOKEN_AGREEMENT = 0.98
# AttentionScan's gradients, per leaf relative to max(1, max|g|): the bounds
# of tests/test_att_scan_vjp.py (the JAX package's custom VJP against its
# autodiff). In bf16, d_proj_key's hand-built form does not round d_energy
# to bf16 as autodiff of the cast does, so it differs from autodiff by up to
# one bf16 rounding of the largest term. Read: float32 1.6e-7 (autograd) and
# 3.4e-7 (JAX); bf16 1.2e-3 (autograd) and 2.6e-6 (JAX, the same formula).
SCAN_TOLS = {"float32": 5e-6, "bfloat16": 5e-3}
MODEL_GRAD_TOL = 1e-5   # whole-model float32 gradients, relative as above;
                        # read 1.9e-8


def _models(compute_dtype="float32", dims=DIMS, b=B, **kw):
    """(JAX spec, JAX params, port spec, port params, feats), one tree."""
    jspec, jparams = graft._make_spec_and_params(
        **dims, arch="s2vt-att", compute_dtype=compute_dtype, vocab_pad_to=8,
        use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**dims, arch="s2vt-att",
                                          compute_dtype=compute_dtype, vocab_pad_to=8,
                                          device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    feats = np.random.default_rng(7).standard_normal(
        (b, dims["num_frames"], dims["vid_feat"])).astype(np.float32)
    return (jspec.with_(**kw), jparams, tspec.with_(**kw),
            bridge.from_jax_params(jparams, "cpu"), feats)


@pytest.fixture(scope="module")
def f32():
    return _models()


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------- Bahdanau

@pytest.mark.parametrize("cdt, tol", [("float32", 1e-6), ("bfloat16", 1e-5)])
def test_bahdanau_matches_jax(cdt, tol):
    """Keys, context and alphas against vcr_tpu.nn.attention; the same
    roundings, float32 sums in other orders (read 2.4e-7 and 9.5e-7)."""
    r = np.random.default_rng(0)
    b, n, h = 5, 7, 16
    jp = jax.tree_util.tree_map(np.asarray, jattention.bahdanau_init(
        jax.random.PRNGKey(3), h))
    tp = bridge.from_jax_params(jp, "cpu")
    keys, query = (r.standard_normal(s).astype(np.float32) for s in ((b, n, h), (b, h)))
    jdt, tdt = jnp.dtype(cdt), getattr(torch, cdt)
    jpk = jattention.bahdanau_project_keys(jp, jnp.asarray(keys), jdt)
    tpk = tattention.bahdanau_project_keys(tp, torch.from_numpy(keys), tdt)
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=0, atol=tol)
    jctx, jalpha = jattention.bahdanau_attend(jp, jnp.asarray(query), jpk,
                                              jnp.asarray(keys), jdt)
    tctx, talpha = tattention.bahdanau_attend(tp, torch.from_numpy(query), tpk,
                                              torch.from_numpy(keys), tdt)
    assert tctx.dtype == talpha.dtype == torch.float32
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), rtol=0, atol=tol)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), rtol=0, atol=tol)


# ---------------------------------------------------------------- eval

def test_eval_logits_and_tokens_match_jax(f32):
    jspec, jparams, tspec, tparams, feats = f32
    want = np.asarray(js2vt_att.apply(jparams, jspec, jnp.asarray(feats), train=False))
    got = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats))
    assert got.shape == (B, DIMS["max_len"], 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    want_tok = np.asarray(js2vt_att.apply(jparams, jspec, jnp.asarray(feats),
                                          train=False, emit="tokens"))
    got_tok = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens")
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    # the stages: the encoder (one B1 sequence) and one encoder step
    jeo, jef = js2vt_att.encode(jparams, jspec, jnp.asarray(feats))
    teo, tef = ts2vt_att.encode(tparams, tspec, torch.from_numpy(feats))
    np.testing.assert_allclose(teo.numpy(), np.asarray(jeo), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(tef.numpy(), np.asarray(jef), rtol=0, atol=LOGIT_TOL)
    jh, _ = js2vt_att.encode_step(jparams, jspec, jnp.asarray(feats[:, 0]), jef)
    th, _ = ts2vt_att.encode_step(tparams, tspec, torch.from_numpy(feats[:, 0]), tef)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=LOGIT_TOL)


def test_build_captioner_matches_jax(f32):
    jspec, jparams, tspec, tparams, feats = f32
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer="none")(
        jnp.asarray(feats)))
    got = tserving.build_captioner(tparams, tspec, device="cpu")(feats)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_eval_matches_jax():
    """bf16 products and float32 state on both sides, vocab 300, H=128,
    B=32, N=8, L=10 (as test_bf16_s2vt_matches_jax): logits within
    BF16_LOGIT_TOL, greedy tokens at least BF16_TOKEN_AGREEMENT equal."""
    jspec, jparams, tspec, tparams, feats = _models("bfloat16", BF16_DIMS, BF16_B)
    want = np.asarray(js2vt_att.apply(jparams, jspec, jnp.asarray(feats), train=False))
    got = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (BF16_B, BF16_DIMS["max_len"], 304)
    valid = slice(0, BF16_DIMS["vocab_size"])
    assert np.abs(got[..., valid] - want[..., valid]).max() <= BF16_LOGIT_TOL
    want_tok = np.asarray(js2vt_att.apply(jparams, jspec, jnp.asarray(feats), train=False,
                                          emit="tokens"))
    got_tok = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats),
                              emit="tokens").numpy()
    assert (got_tok == want_tok).mean() >= BF16_TOKEN_AGREEMENT


def test_init_tree_matches_jax_structure(f32):
    _, jparams, _, _, _ = f32
    _, tparams = entry.make_spec_and_params(**DIMS, arch="s2vt-att", vocab_pad_to=8,
                                            device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), bridge.to_numpy(tparams))
    assert jshapes == tshapes


# ---------------------------------------------------------------- train

def _sent(b=B, dims=DIMS, seed=2):
    return np.random.default_rng(seed).integers(0, dims["vocab_size"],
                                                (b, dims["max_len"])).astype(np.int32)


def test_train_logits_match_jax():
    """p=0: the teacher-forced branch (AttentionScan, then one vocab
    product)."""
    jspec, jparams, tspec, tparams, feats = _models(dropout_p=0.0)
    sent = _sent()
    want = js2vt_att.apply(jparams, jspec, jnp.asarray(feats), jnp.asarray(sent),
                           rng=jax.random.PRNGKey(0), train=True)
    got = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats), torch.from_numpy(sent),
                          rng=0, train=True)
    assert got.shape == (B, DIMS["max_len"], 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_train_dropout_is_drawn_from_the_seed():
    _, _, tspec, tparams, feats = _models(dropout_p=0.3)
    x, s = torch.from_numpy(feats), torch.from_numpy(_sent())
    a = ts2vt_att.apply(tparams, tspec, x, s, rng=5, train=True)
    b = ts2vt_att.apply(tparams, tspec, x, s, rng=5, train=True)
    c = ts2vt_att.apply(tparams, tspec, x, s, rng=6, train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="eval-only"):
        eo, ef = ts2vt_att.encode(tparams, tspec, x)
        ts2vt_att.decode(tparams, tspec, eo, ef, s, train=True, emit="tokens")


# ------------------------------------------------------------ AttentionScan

def _scan_inputs(cdt, b=4, n=5, h=16, e=8, steps=6):
    """tests/test_att_scan_vjp.py's inputs: JAX parameters and numpy arrays."""
    rng = np.random.default_rng(0)
    att = jattention.bahdanau_init(jax.random.PRNGKey(0), h)
    qv = {"query_layer": att["query_layer"], "energy_layer": att["energy_layer"]}
    rnn = jgru_init(jax.random.PRNGKey(1), h + e, h)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, n, h), (b, n, h), (b, h), (steps, b, e))]
    cot = rng.standard_normal((steps, b, h)).astype(np.float32)
    return (jax.tree_util.tree_map(np.asarray, qv), jax.tree_util.tree_map(np.asarray, rnn),
            arrays, cot)


def _torch_leaves(qv, rnn, arrays):
    qv_t, rnn_t = bridge.from_jax_params(qv, "cpu"), bridge.from_jax_params(rnn, "cpu")
    arrays_t = [torch.from_numpy(a) for a in arrays]
    leaves = (jax.tree_util.tree_leaves(qv_t) + jax.tree_util.tree_leaves(rnn_t)
              + arrays_t)
    for x in leaves:
        x.requires_grad_(True)
    return qv_t, rnn_t, arrays_t, leaves


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_attention_scan_matches_autograd_and_jax(cdt):
    """The forward equals the plain loop bit for bit; the gradient of every
    input equals autograd of the plain loop and jax.grad through the JAX
    package's custom VJP, within SCAN_TOLS."""
    qv, rnn, arrays, cot = _scan_inputs(cdt)
    tdt, tol = getattr(torch, cdt), SCAN_TOLS[cdt]
    qv_t, rnn_t, arrays_t, leaves = _torch_leaves(qv, rnn, arrays)
    states = ts2vt_att.attention_scan(qv_t, rnn_t, *arrays_t, tdt)
    plain = ts2vt_att.attention_scan_plain(qv_t, rnn_t, *arrays_t, tdt)
    assert torch.equal(states, plain)
    got = torch.autograd.grad(states, leaves, torch.from_numpy(cot))
    oracle = torch.autograd.grad(plain, leaves, torch.from_numpy(cot))

    def jloss(qv, rnn, pk, vals, h0, embs):
        s = js2vt_att._attention_scan(cdt, qv, rnn, pk, vals, h0, embs)
        return jnp.sum(s * cot)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5)))(
        qv, rnn, *(jnp.asarray(a) for a in arrays))
    want = jax.tree_util.tree_leaves(jgrads)
    names = ([f"{k}.w" for k in sorted(qv)] + [f"rnn.{k}" for k in sorted(rnn)]
             + ["proj_key", "values", "h0", "embs"])
    assert len(got) == len(want) == len(names)
    for g, o, w, name in zip(got, oracle, want, names):
        assert _rel_err(g.numpy(), o.numpy()) <= tol, (name, "autograd")
        assert _rel_err(g.numpy(), w) <= tol, (name, "jax")


def test_attention_scan_composes_with_checkpoint():
    """remat=True checkpoints the whole forward: the scan runs again in the
    backward, and the gradients stay the same bit for bit."""
    qv, rnn, arrays, cot = _scan_inputs("float32")
    qv_t, rnn_t, arrays_t, leaves = _torch_leaves(qv, rnn, arrays)

    def fn(*xs):
        return ts2vt_att.attention_scan(qv_t, rnn_t, *xs, torch.float32)

    plain = torch.autograd.grad(fn(*arrays_t), leaves, torch.from_numpy(cot))
    remat = torch.autograd.grad(
        torch.utils.checkpoint.checkpoint(fn, *arrays_t, use_reentrant=False), leaves,
        torch.from_numpy(cot))
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_whole_model_gradients_match_jax():
    """The masked cross-entropy's gradient for every leaf of S2VT-att (B1's
    Function, AttentionScan, the vocab product), float32, p=0, against
    jax.grad of the JAX package's composition."""
    jspec, jparams, tspec, tparams, feats = _models(dropout_p=0.0)
    sent = _sent(seed=3)
    sent_len = np.array([6, 4, 3, 6, 2, 5], np.int32)

    def jloss(p):
        logits = js2vt_att.apply(p, jspec, jnp.asarray(feats), jnp.asarray(sent), train=True)
        return jlosses.masked_cross_entropy(logits, jnp.asarray(sent), jnp.asarray(sent_len))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    leaves = jax.tree_util.tree_leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    logits = ts2vt_att.apply(tparams, tspec, torch.from_numpy(feats), torch.from_numpy(sent),
                             train=True)
    loss = tlosses.masked_cross_entropy(logits, torch.from_numpy(sent),
                                        torch.from_numpy(sent_len))
    assert abs(loss.item() - float(want_loss)) <= LOGIT_TOL
    got = torch.autograd.grad(loss, leaves)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], got):
        assert _rel_err(g.numpy(), w) <= MODEL_GRAD_TOL, jax.tree_util.keystr(path)
