"""The port's Transformer against the JAX package on the CPU, from one JAX
parameter tree: the positional encoding, the reference's Norm, multi-head
attention (masked and unmasked, and its dropout under the JAX package's own
keep-mask), the parameter tree, the encoder, the parallel train pass, the
parity greedy decode, the whole train forward under JAX's dropout masks, and
the eval forward in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.models import transformer as jtr
from vcr_tpu.nn import attention as jattention
from vcr_tpu.nn import layers as jlayers
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.models import transformer as ttr
from vcr_tpu_torch.nn import attention as tattention
from vcr_tpu_torch.nn import layers as tlayers

DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=32, max_len=7,
            num_frames=5)
TF = dict(tf_layers=2, tf_heads=2)
B = 4
LAYER_TOL = 1e-6     # one Norm or one attention: float32 sums in other
                     # orders; read 4.8e-7 (bf16 attention 1.2e-7)
MODEL_TOL = 1e-5     # encoder, train logits, eval logits through 2 layers each;
                     # read 8.3e-7
BF16_B = 32
BF16_LOGIT_TOL = 2e-3      # the bound of test_torch_s2vt.py's bf16 test: the same
                           # roundings, float32 sums in other orders; read 1.52e-3,
                           # tokens 100% equal. The decoder alone, fed one encoder
                           # output, reads 2.4e-7: the encoder's float32 outputs
                           # differ by 1.3e-5 (sums in another order), and the bf16
                           # decoder carries that to 1.5e-3
BF16_TOKEN_AGREEMENT = 0.98
# At H=128 (the width of test_torch_s2vt.py's bf16 test) the float32 sums of
# the two packages differ in their last bit often enough that some operand
# lands on the other side of a bf16 rounding (the Norm's mean alone differs
# from XLA's in ~80% of rows); each such flip moves a product by up to one
# bf16 quantum, and 2 encoder and 2 decoder layers carry it on. Read 2.2e-3
# after the encoder and 7.5e-3 on the logits, tokens 100% equal.
WIDE_DIMS = dict(vocab_size=300, embed_size=64, hidden=128, vid_feat=128, max_len=10,
                 num_frames=8)
WIDE_TF = dict(tf_layers=2, tf_heads=4)
WIDE_LOGIT_TOL = 2e-2


def models(compute_dtype="float32", dims=DIMS, tf=TF, b=B, seed=0):
    """(JAX spec, JAX params as numpy, port spec, port params, feats (B, N,
    V) float32), one parameter tree."""
    jspec, jparams = graft._make_spec_and_params(
        **dims, arch="transformer", compute_dtype=compute_dtype, vocab_pad_to=8, seed=seed,
        **tf)
    tspec, _ = entry.make_spec_and_params(**dims, arch="transformer",
                                          compute_dtype=compute_dtype, vocab_pad_to=8,
                                          seed=seed, device="cpu", **tf)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    feats = np.random.default_rng(seed + 7).standard_normal(
        (b, dims["num_frames"], dims["vid_feat"])).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module")
def f32():
    return models()


def _max_err(got, want):
    return np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("d_model", [16, 300, 7])
def test_positional_encoding_matches_jax(d_model):
    np.testing.assert_array_equal(ttr.make_positional_encoding(d_model),
                                  jtr.make_positional_encoding(d_model))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_norm_matches_jax(dtype):
    """The unbiased std with eps on the std; float32 statistics, the result
    in the input's dtype. bf16: the float32 results agree to 1e-6, and
    their roundings to bf16 agree except where a last-ulp difference sits
    on a rounding boundary (read: 1 element of 640)."""
    r = np.random.default_rng(1)
    x = r.standard_normal((4, 5, 32)).astype(np.float32) * 3 + 1
    params = {"alpha": r.standard_normal(32).astype(np.float32),
              "bias": r.standard_normal(32).astype(np.float32)}
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jlayers.torch_norm(params, jx)
    got = tlayers.torch_norm(bridge.from_jax_params(params, "cpu"), tx)
    assert got.dtype == tx.dtype and want.dtype == jx.dtype
    if dtype == "float32":
        assert _max_err(got.numpy(), want) <= LAYER_TOL
        # the reference's form: unbiased std, eps on the std
        ref = params["alpha"] * (x - x.mean(-1, keepdims=True)) / (
            x.std(-1, ddof=1, keepdims=True) + 1e-6) + params["bias"]
        assert _max_err(got.numpy(), ref) <= LAYER_TOL * 10
    else:
        got32, want32 = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert (got32 != want32).mean() <= 0.01


@pytest.mark.parametrize("flag", ["e", "ed"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_mha_matches_jax(flag, masked, cdt):
    """Multi-head attention at the reference's widths (encoder self-attention
    and cross-attention), with the causal mask or none; both products with
    float32 results."""
    r = np.random.default_rng(2)
    e_w, d_w, hidden, heads = 12, 16, 16, 4
    jp = jax.tree_util.tree_map(np.asarray, jattention.mha_init(
        jax.random.PRNGKey(0), heads, hidden, flag, e_width=e_w, d_width=d_w))
    q_w = e_w if flag == "e" else d_w
    q = r.standard_normal((3, 6, q_w)).astype(np.float32)
    kv = q if flag == "e" else r.standard_normal((3, 5, e_w)).astype(np.float32)
    mask = None
    if masked:
        mask = np.tril(np.ones((6, kv.shape[1]), bool))[None, None]
    jdt, tdt = jnp.dtype(cdt), getattr(torch, cdt)
    want = jattention.mha_apply(jp, heads, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                None if mask is None else jnp.asarray(mask),
                                compute_dtype=jdt)
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    got = tattention.mha_apply(bridge.from_jax_params(jp, "cpu"), heads, tq, tkv, tkv,
                               None if mask is None else torch.from_numpy(mask),
                               compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (3, 6, q_w)
    assert _max_err(got.numpy(), want) <= LAYER_TOL


def test_mha_dropout_under_jax_keep_mask():
    """Dropout on the attention probabilities: the port given the JAX
    package's own keep-mask (``jax.random.bernoulli`` of the dropout key)
    equals its train-mode attention."""
    r = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(np.asarray, jattention.mha_init(
        jax.random.PRNGKey(1), 2, 16, "d", d_width=16))
    x = r.standard_normal((3, 6, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jattention.mha_apply(jp, 2, *(jnp.asarray(x),) * 3, dropout_key=key,
                                dropout_rate=0.1, train=True, compute_dtype=jnp.float32)
    keep = np.asarray(jax.random.bernoulli(key, p=0.9, shape=(3, 2, 6, 6)))
    tx = torch.from_numpy(x)
    got = tattention.mha_apply(bridge.from_jax_params(jp, "cpu"), 2, tx, tx, tx,
                               keep=torch.from_numpy(keep), dropout_rate=0.1,
                               compute_dtype=torch.float32)
    assert _max_err(got.numpy(), want) <= LAYER_TOL
    assert not keep.all()


# ---------------------------------------------------------------- the model

def test_init_params_has_jax_structure():
    """The port's initial tree has the JAX package's keys and shapes (layers
    stacked on a leading axis), its PE tables and zero-padded embedding."""
    jspec, jparams, tspec, _, _ = models()
    init_fn, _ = entry.base.build_model("transformer")
    tparams = init_fn(torch.Generator().manual_seed(0), tspec,
                      np.asarray(jparams["decoder"]["embedding"]["table"][:21]))
    jleaves, jtree = jax.tree_util.tree_flatten(jparams)
    tleaves, ttree = jax.tree_util.tree_flatten(tparams)
    assert jtree == ttree
    assert [x.shape for x in jleaves] == [tuple(x.shape) for x in tleaves]
    for part in ("encoder", "decoder"):
        np.testing.assert_array_equal(tparams[part]["pe"].numpy(), jparams[part]["pe"])
    np.testing.assert_array_equal(tparams["decoder"]["embedding"]["table"].numpy(),
                                  jparams["decoder"]["embedding"]["table"])


def test_encode_train_pass_and_eval_match_jax(f32):
    jspec, jparams, tspec, tparams, feats = f32
    jx, tx = jnp.asarray(feats), torch.from_numpy(feats)
    jmask, tmask = jtr.create_masks_inp(jx), ttr.create_masks_inp(tx)
    jeo = jtr.encode(jparams, jspec, jx, jmask, jax.random.PRNGKey(0), train=False)
    teo = ttr.encode(tparams, tspec, tx, tmask)
    assert _max_err(teo.numpy(), jeo) <= MODEL_TOL
    s = np.random.default_rng(4).integers(0, 21, (B, DIMS["max_len"])).astype(np.int32)
    s_len = np.array([7, 3, 5, 1], np.int32)
    np.testing.assert_array_equal(
        ttr.create_masks_trg(torch.from_numpy(s), torch.from_numpy(s_len)).numpy(),
        np.asarray(jtr.create_masks_trg(jnp.asarray(s), jnp.asarray(s_len))))
    jlog = jtr.decode_train(jparams, jspec, jeo, jnp.asarray(s), jmask,
                            jtr.create_masks_trg(jnp.asarray(s), jnp.asarray(s_len)),
                            jax.random.PRNGKey(0), train=False)
    tlog = ttr.decode_train(tparams, tspec, teo, torch.from_numpy(s), tmask,
                            ttr.create_masks_trg(torch.from_numpy(s),
                                                 torch.from_numpy(s_len)))
    assert _max_err(tlog.numpy(), jlog) <= MODEL_TOL
    want = np.asarray(jtr.apply(jparams, jspec, jx, train=False))
    got = ttr.apply(tparams, tspec, tx)
    assert got.shape == (B, DIMS["max_len"], 24) and got.dtype == torch.float32
    assert _max_err(got.numpy(), want) <= MODEL_TOL
    tokens = ttr.apply(tparams, tspec, tx, emit="tokens")
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), want.argmax(-1))


def _jax_train_noise(key, spec, b, n, length):
    """The keep-masks JAX's ``transformer.apply(train=True)`` draws from
    ``key``, in the layout of the port's ``draw_train_noise``."""
    keep, heads, ew, dw = 0.9, spec.tf_heads, spec.vid_feat_size, spec.embed_size

    def bern(k, shape, p=keep):
        return torch.from_numpy(np.asarray(jax.random.bernoulli(k, p=p, shape=shape)))

    k_enc, k_dec = jax.random.split(key)
    encoder = []
    for k in jax.random.split(k_enc, spec.tf_layers):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        encoder.append({"attn": bern(k2, (b, heads, n, n)), "attn_out": bern(k1, (b, n, ew)),
                        "ff": bern(k4, (b, n, ttr.D_FF)), "ff_out": bern(k3, (b, n, ew))})
    k_layers, k_pred = jax.random.split(k_dec)
    decoder = []
    for k in jax.random.split(k_layers, spec.tf_layers):
        ks = jax.random.split(k, 6)
        decoder.append({"self": bern(ks[1], (b, heads, length, length)),
                        "self_out": bern(ks[0], (b, length, dw)),
                        "cross": bern(ks[3], (b, heads, length, n)),
                        "cross_out": bern(ks[2], (b, length, dw)),
                        "ff": bern(ks[5], (b, length, ttr.D_FF)),
                        "ff_out": bern(ks[4], (b, length, dw))})
    return {"encoder": encoder, "decoder": decoder,
            "pred": bern(k_pred, (b, length, dw), 1.0 - spec.dropout_p)}


def test_train_forward_under_jax_dropout_masks(f32):
    """The whole train forward with every dropout on (internal 0.1, the
    output projection's 0.2), the port given the masks the JAX package
    draws from its key: equal logits."""
    jspec, jparams, tspec, tparams, feats = f32
    s = np.random.default_rng(5).integers(0, 21, (B, DIMS["max_len"])).astype(np.int32)
    s_len = np.array([7, 2, 6, 4], np.int32)
    key = jax.random.PRNGKey(11)
    want = jtr.apply(jparams, jspec, jnp.asarray(feats), jnp.asarray(s), jnp.asarray(s_len),
                     rng=key, train=True)
    noise = _jax_train_noise(key, tspec, B, DIMS["num_frames"], DIMS["max_len"])
    got = ttr.apply(tparams, tspec, torch.from_numpy(feats), torch.from_numpy(s),
                    torch.from_numpy(s_len), train=True, noise=noise)
    assert _max_err(got.detach().numpy(), want) <= MODEL_TOL
    # the port's own draws: deterministic per seed, and dropout does drop
    a = ttr.apply(tparams, tspec, torch.from_numpy(feats), torch.from_numpy(s),
                  torch.from_numpy(s_len), train=True, rng=3)
    b = ttr.apply(tparams, tspec, torch.from_numpy(feats), torch.from_numpy(s),
                  torch.from_numpy(s_len), train=True, rng=3)
    assert torch.equal(a, b) and not torch.equal(a, got)


@pytest.mark.parametrize("dims, tf, tol", [(DIMS, TF, BF16_LOGIT_TOL),
                                           (WIDE_DIMS, WIDE_TF, WIDE_LOGIT_TOL)],
                         ids=["small", "h128"])
def test_bf16_eval_matches_jax(dims, tf, tol):
    """bf16 products: the eval logits (the parity greedy decode) of the real
    vocabulary within the bound, its tokens at least 98% equal."""
    jspec, jparams, tspec, tparams, feats = models("bfloat16", dims, tf, BF16_B)
    want = np.asarray(jtr.apply(jparams, jspec, jnp.asarray(feats), train=False))
    got = ttr.apply(tparams, tspec, torch.from_numpy(feats)).numpy()
    real = slice(0, dims["vocab_size"])
    assert _max_err(got[..., real], want[..., real]) <= tol
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= BF16_TOKEN_AGREEMENT
