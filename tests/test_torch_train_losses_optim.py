"""The port's training primitives against the JAX package on the CPU: the
losses, the teacher-forcing schedule, the optimizer (clip, decay, Adam or
SGD, frozen leaves) and the gradient of the bf16 product ``vdot``, on the
CPU branch and through the card branch's backward formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.nn import layers as jlayers
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import schedule as jschedule
from vcr_tpu_torch import bridge
from vcr_tpu_torch.nn import layers as tlayers
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import schedule as tschedule

B, L, V, N = 5, 7, 11, 6
LOSS_TOL = 1e-6  # float32 sums over at most B*L terms, in other orders


@pytest.fixture(scope="module")
def loss_inputs():
    r = np.random.default_rng(3)
    return {
        "logits": r.standard_normal((B, L, V)).astype(np.float32) * 3,
        "target": r.integers(0, V, (B, L)).astype(np.int32),
        "s_len": np.array([7, 1, 4, 0, 5], np.int32),   # one empty sentence
        "probs": np.array(jax.nn.softmax(r.standard_normal((B, N, 2)), -1),
                            np.float32),
        "valid": np.array([1, 1, 0, 1, 0], np.float32),
    }


LOSSES = [
    ("masked_cross_entropy", ("logits", "target", "s_len")),
    ("masked_accuracy", ("logits", "target", "s_len")),
    ("continuity_loss", ("probs",)),
    ("brevity_loss", ("probs",)),
    ("rationale_length", ("probs",)),
]


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("name, args", LOSSES, ids=[n for n, _ in LOSSES])
def test_loss_matches_jax(loss_inputs, name, args, with_valid):
    jargs = [jnp.asarray(loss_inputs[a]) for a in args]
    targs = [torch.from_numpy(loss_inputs[a]) for a in args]
    if with_valid:
        jargs.append(jnp.asarray(loss_inputs["valid"]))
        targs.append(torch.from_numpy(loss_inputs["valid"]))
    want = float(getattr(jlosses, name)(*jargs))
    got = getattr(tlosses, name)(*targs)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) <= LOSS_TOL


def test_sentence_mask_matches_jax(loss_inputs):
    s_len = loss_inputs["s_len"]
    np.testing.assert_array_equal(
        tlosses.sentence_mask(L, torch.from_numpy(s_len)).numpy(),
        np.asarray(jlosses.sentence_mask(L, jnp.asarray(s_len))))


@pytest.mark.parametrize("schedule_sample", [False, True])
def test_schedule_matches_jax(schedule_sample):
    np.testing.assert_array_equal(
        tschedule.teacher_force_schedule(300, schedule_sample),
        jschedule.teacher_force_schedule(300, schedule_sample))
    np.testing.assert_array_equal(tschedule.inverse_sigmoid(50, 20.0),
                                  jschedule.inverse_sigmoid(50, 20.0))


def _tree(r):
    """A small parameter tree with every kind of frozen leaf: a "pe" table,
    a BatchNorm mean/var pair, and a Transformer decoder.norm beside its
    norm_out."""
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {
        "enc": {"w": f(4, 3), "b": f(3)},
        "pe": f(5, 4),
        "bn": {"mean": f(3), "var": np.abs(f(3)), "gamma": f(3)},
        "decoder": {"norm": {"alpha": f(4), "bias": f(4)},
                    "norm_out": {"alpha": f(4), "bias": f(4)}, "w": f(4, 4)},
    }


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


OPT_TOL = 1e-6  # five updates of float32 moments, the same formulas


@pytest.mark.parametrize("max_norm", [0.05, 100.0], ids=["clipping", "no-clipping"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_jax(name, max_norm):
    """Five updates from the same gradients: parameters within OPT_TOL of
    the optax chain, frozen leaves unchanged bit for bit on both sides."""
    r = np.random.default_rng(4)
    init = _tree(r)
    assert toptim.trainable_labels(init) == joptim.trainable_labels(init)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    tparams = bridge.from_jax_params(init, "cpu")
    jopt = joptim.build_optimizer(name, 1e-2, 1e-3, max_norm, momentum=0.8)
    jstate = jopt.init(jparams)
    topt = toptim.build_optimizer(name, 1e-2, 1e-3, max_norm, momentum=0.8)
    tstate = topt.init(tparams)
    assert [p[-1] for p in tstate.paths] == ["w", "b", "gamma", "alpha", "bias", "w"]
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda a: r.standard_normal(a.shape).astype(
            np.float32), init)
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                                      jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        topt.step(tstate, [torch.from_numpy(_get(grads, p)) for p in tstate.paths])
    got = bridge.to_numpy(tparams)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = tuple(k.key for k in path)
        np.testing.assert_allclose(_get(got, keys), np.asarray(want), rtol=0,
                                   atol=OPT_TOL, err_msg=str(keys))
    for keys in (("pe",), ("bn", "mean"), ("bn", "var"), ("decoder", "norm", "alpha"),
                 ("decoder", "norm", "bias")):
        np.testing.assert_array_equal(_get(got, keys), _get(init, keys))
        np.testing.assert_array_equal(np.asarray(_get(jparams, keys)), _get(init, keys))


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="Unknown optim type"):
        toptim.build_optimizer("adagrad", 1e-3, 0.0, 1.0)


def _vdot_case():
    """bf16 operands and a cotangent whose float32 products and sums are
    exact (multiples of 1/4 and 1/8), so the order of the sums cannot move a
    result across a bf16 rounding step; the rounding of the gradients to
    bf16 still happens (their sums need up to 11 bits)."""
    r = np.random.default_rng(6)
    x = (r.integers(-8, 9, (12, 16)) / 4).astype(np.float32)
    w = (r.integers(-8, 9, (16, 10)) / 4).astype(np.float32)
    g = (r.integers(-16, 17, (12, 10)) / 8).astype(np.float32)
    return x, w, g


def _jax_vdot_grads(x, w, g):
    return jax.grad(lambda a, b: jnp.sum(jlayers.vdot(a, b, jnp.bfloat16) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


def test_bf16_vdot_gradients_match_jax():
    """The CPU branch's autograd against jax.grad of vcr_tpu's vdot."""
    x, w, g = _vdot_case()
    want_x, want_w = _jax_vdot_grads(x, w, g)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = tlayers.vdot(tx, tw, torch.bfloat16)
    got_x, got_w = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    assert got_x.dtype == got_w.dtype == torch.float32
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
    assert not np.array_equal(got_w.numpy(), x.T @ g)  # the bf16 rounding happened


def test_card_vdot_backward_formula_matches_jax():
    """The card branch's backward (``_MatmulF32``), run on CPU tensors: its
    forward needs cuBLAS, its backward is plain torch. Rounded to bf16 and
    cast back as ``vdot``'s casts do, it gives JAX's gradients."""

    class Ctx:
        needs_input_grad = (True, True)

    x, w, g = _vdot_case()
    want_x, want_w = _jax_vdot_grads(x, w, g)
    ctx = Ctx()
    ctx.saved_tensors = (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    gx, gw = tlayers._MatmulF32.backward(ctx, torch.from_numpy(g))
    assert gx.dtype == gw.dtype == torch.bfloat16
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gw.float().numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
