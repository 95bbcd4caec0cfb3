"""The port's S2VT training against the JAX package on the CPU (Pallas GRU in
interpret mode), from one JAX parameter tree: the train forward in both of
its forms, train steps through ``build_step_fns`` (Adam with clipping,
gradient accumulation, remat), the bf16 step, and the eval step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.models import s2vt as js2vt
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.models import s2vt as ts2vt
from vcr_tpu_torch.nn import rnn as trnn
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 6
LR, WD, MAX_NORM = 1e-3, 1e-4, 0.1   # the clip is active at every step
# the bounds of tests/test_train_equivalence.py for the JAX package against
# the torch reference: float32 sums in other orders through 3 steps
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
LOGIT_TOL = 1e-5


def _specs(compute_dtype="float32", dims=DIMS, **kw):
    """(JAX spec, JAX params, port spec, port params), one parameter tree."""
    jspec, jparams = graft._make_spec_and_params(
        **dims, compute_dtype=compute_dtype, vocab_pad_to=8, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**dims, compute_dtype=compute_dtype,
                                          vocab_pad_to=8, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec.with_(**kw), jparams, tspec.with_(**kw), bridge.from_jax_params(
        jparams, "cpu")


def _batch(r, b=B, dims=DIMS, valid=None):
    return {
        "vid_feats": r.standard_normal((b, dims["num_frames"], dims["vid_feat"])
                                       ).astype(np.float32),
        "sent": r.integers(0, dims["vocab_size"], (b, dims["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, dims["max_len"] + 1, (b,)).astype(np.int32),
        "valid": np.ones((b,), np.float32) if valid is None else valid,
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_params_close(tparams, jparams, atol):
    got = bridge.to_numpy(tparams)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def f32():
    """The float32 models at p=0 and the JAX train step at static tf=1.0,
    Adam with clipping, compiled once for the module."""
    jspec, jparams, tspec, tparams = _specs(dropout_p=0.0)
    jopt = joptim.build_optimizer("adam", LR, WD, MAX_NORM)
    jtrain, jeval = jstep.build_step_fns("s2vt", jspec, jopt, static_tf=1.0)
    return dict(jspec=jspec, jparams=jparams, tspec=tspec, tparams=tparams, jopt=jopt,
                jtrain=jtrain, jeval=jeval)


def _fresh(params):
    return jax.tree_util.tree_map(lambda a: a.detach().clone() if isinstance(a, torch.Tensor)
                                  else jnp.array(a), params)


def test_hoisted_equals_general_with_dropout():
    """At train with a Python tf >= 1.0 the hoisted form runs; a tensor tf
    of 1.0 keeps the general loop. Both read the same draws of one seed."""
    _, _, tspec, tparams = _specs(dropout_p=0.3)
    r = np.random.default_rng(1)
    batch = _batch(r)
    feats, sent = torch.from_numpy(batch["vid_feats"]), torch.from_numpy(batch["sent"])
    hoisted = ts2vt.apply(tparams, tspec, feats, sent, rng=7, train=True,
                          teacher_force_prob=1.0)
    general = ts2vt.apply(tparams, tspec, feats, sent, rng=7, train=True,
                          teacher_force_prob=torch.tensor(1.0))
    np.testing.assert_allclose(hoisted.numpy(), general.numpy(), rtol=1e-6, atol=1e-6)
    other_seed = ts2vt.apply(tparams, tspec, feats, sent, rng=8, train=True)
    assert not torch.equal(hoisted, other_seed)  # the dropout is live


@pytest.mark.parametrize("tf", [1.0, 0.0], ids=["hoisted-tf1", "general-tf0"])
def test_train_forward_matches_jax(f32, tf):
    """p=0: the hoisted teacher-forced form, and the general form with the
    argmax fed back (tf=0 makes every coin pick it)."""
    batch = _batch(np.random.default_rng(2))
    want = js2vt.apply(f32["jparams"], f32["jspec"], jnp.asarray(batch["vid_feats"]),
                       jnp.asarray(batch["sent"]), rng=jax.random.PRNGKey(0), train=True,
                       teacher_force_prob=tf)
    got = ts2vt.apply(f32["tparams"], f32["tspec"], torch.from_numpy(batch["vid_feats"]),
                      torch.from_numpy(batch["sent"]), rng=0, train=True,
                      teacher_force_prob=tf)
    assert got.shape == (B, DIMS["max_len"], 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_three_train_steps_match_jax(f32):
    """Three Adam steps with the clip active, p=0, static tf=1.0: losses and
    parameters against JAX's build_step_fns."""
    r = np.random.default_rng(3)
    jparams, tparams = _fresh(f32["jparams"]), _fresh(f32["tparams"])
    jstate = f32["jopt"].init(jparams)
    topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    tstate = topt.init(tparams)
    ttrain, _ = tstep.build_step_fns("s2vt", f32["tspec"], topt, static_tf=1.0,
                                     device="cpu")
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(r)
        jparams, jstate, jm, jpred = f32["jtrain"](jparams, jstate, _jbatch(batch),
                                                   jax.random.PRNGKey(i), 1.0)
        tparams, tstate, tm, tpred = ttrain(tparams, tstate,
                                            tstep.device_batch(batch, "cpu"), i, 0.5)
        j_losses.append(float(jm["loss"]))
        t_losses.append(tm["loss"].item())
        assert set(tm) == set(jm) == {"loss", "acc"}
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(tparams, jparams, PARAM_TOL)


def test_grad_accum_with_a_padding_row(f32):
    """grad_accum=2 on a batch whose last row is padding (valid=0): the
    valid-weighted combine is the full-batch gradient, so one step equals
    grad_accum=1's and JAX's."""
    valid = np.array([1, 1, 1, 1, 1, 0], np.float32)
    batch = _batch(np.random.default_rng(4), valid=valid)
    out = {}
    for accum in (1, 2):
        tparams = _fresh(f32["tparams"])
        topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
        ttrain, _ = tstep.build_step_fns("s2vt", f32["tspec"], topt, static_tf=1.0,
                                         grad_accum=accum, device="cpu")
        out[accum] = ttrain(tparams, topt.init(tparams), tstep.device_batch(batch, "cpu"),
                            5, 1.0)
    (p1, _, m1, pred1), (p2, _, m2, pred2) = out[1], out[2]
    for x, y in zip(jax.tree_util.tree_leaves(bridge.to_numpy(p1)),
                    jax.tree_util.tree_leaves(bridge.to_numpy(p2))):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
    for k in m1:
        assert abs(m1[k].item() - m2[k].item()) <= 1e-6
    assert torch.equal(pred1, pred2)
    jparams = _fresh(f32["jparams"])
    jparams, _, jm, _ = f32["jtrain"](jparams, f32["jopt"].init(jparams), _jbatch(batch),
                                      jax.random.PRNGKey(0), 1.0)
    assert abs(m2["loss"].item() - float(jm["loss"])) <= LOSS_TOL
    _assert_params_close(p2, jparams, PARAM_TOL)


def test_eval_step_matches_jax(f32):
    batch = _batch(np.random.default_rng(5), valid=np.array([1, 1, 0, 1, 1, 1],
                                                           np.float32))
    jm, jpred = f32["jeval"](f32["jparams"], _jbatch(batch))
    _, teval = tstep.build_step_fns("s2vt", f32["tspec"],
                                    toptim.build_optimizer("adam", LR, WD, MAX_NORM),
                                    device="cpu")
    tm, tpred = teval(f32["tparams"], tstep.device_batch(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in tm:
        assert abs(tm[k].item() - float(jm[k])) <= LOSS_TOL
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_gate_remat_and_remat_are_bitwise_equal():
    """bf16 with dropout: the gradient with gate remat on equals it off, bit
    for bit, and a train step with remat=True equals one without."""
    _, _, tspec, tparams = _specs("bfloat16", dropout_p=0.2)
    batch = tstep.device_batch(_batch(np.random.default_rng(6)), "cpu")
    leaves = list(jax.tree_util.tree_leaves(tparams))
    for x in leaves:
        x.requires_grad_(True)
    grads = {}
    for on in (True, False):
        with trnn.gate_remat_default(on):
            logits = ts2vt.apply(tparams, tspec, batch["vid_feats"], batch["sent"],
                                 rng=3, train=True)
        loss = tlosses.masked_cross_entropy(logits, batch["sent"], batch["sent_len"])
        grads[on] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    steps = {}
    for remat in (False, True):
        params = _fresh(tparams)
        opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
        train, _ = tstep.build_step_fns("s2vt", tspec, opt, remat=remat, device="cpu")
        steps[remat] = train(params, opt.init(params), batch, 3, 0.7)
    for a, b in zip(jax.tree_util.tree_leaves(steps[False][0]),
                    jax.tree_util.tree_leaves(steps[True][0])):
        assert torch.equal(a, b)
    assert torch.equal(steps[False][2]["loss"], steps[True][2]["loss"])


def test_gate_remat_scope_nests_and_restores():
    assert not trnn._GATE_REMAT.get()
    with trnn.gate_remat_default(True):
        assert trnn._GATE_REMAT.get()
        with trnn.gate_remat_default(False):
            assert not trnn._GATE_REMAT.get()
        assert trnn._GATE_REMAT.get()
    assert not trnn._GATE_REMAT.get()


BF16_DIMS = dict(vocab_size=60, embed_size=32, hidden=128, vid_feat=64, max_len=5,
                 num_frames=4)
BF16_B = 8
BF16_LOSS_TOL = 2e-3       # read: 4.8e-7
# per leaf, relative to max(1, max|g|): bf16 products summed in other orders
# through the recurrences, and weight gradients rounded to bf16 as the
# weights are; the largest difference read was 6.1e-5 (rnn2.w_ih)
BF16_GRAD_TOL = 1e-3


def test_bf16_step_matches_jax():
    """bf16 products on both sides, p=0, static tf=1.0: the loss and every
    leaf's gradient against jax.grad of the same composition."""
    jspec, jparams, tspec, tparams = _specs("bfloat16", BF16_DIMS, dropout_p=0.0)
    batch = _batch(np.random.default_rng(7), BF16_B, BF16_DIMS)
    jb = _jbatch(batch)

    def jloss(p):
        logits = js2vt.apply(p, jspec, jb["vid_feats"], jb["sent"], rng=None, train=True,
                             teacher_force_prob=1.0)
        return jlosses.masked_cross_entropy(logits, jb["sent"], jb["sent_len"],
                                            jb["valid"])

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    state = opt.init(tparams)
    train, _ = tstep.build_step_fns("s2vt", tspec, opt, static_tf=1.0, device="cpu")
    fns = train.__self__
    grads, metrics, *_ = fns.grads(tparams, state.leaves, tstep.device_batch(batch, "cpu"),
                                   0, 1.0)
    assert abs(metrics["loss"].item() - float(want_loss)) <= BF16_LOSS_TOL
    for path, g in zip(state.paths, grads):
        w = want
        for k in path:
            w = w[k]
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g.numpy() - w).max() <= BF16_GRAD_TOL * scale, path


def test_step_refusals(f32):
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    # S2VT-att trains since A9, SpatialNet since A11 and the Transformer since
    # A12; an unknown architecture takes the first's place, and the
    # Transformer's case holds a refusal of its steps that still exists
    with pytest.raises(NotImplementedError, match="Unknown"):
        tstep.build_step_fns("lstm-lm", f32["tspec"], opt, device="cpu")
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        tstep.build_step_fns("transformer", f32["tspec"].with_(arch="transformer"), opt,
                             grad_accum=0, device="cpu")
    params = _fresh(f32["tparams"])
    state = opt.init(params)
    batch = _batch(np.random.default_rng(8))
    train, _ = tstep.build_step_fns("s2vt", f32["tspec"], opt, grad_accum=4,
                                    device="cpu")
    with pytest.raises(ValueError, match="not divisible by grad_accum=4"):
        train(params, state, tstep.device_batch(batch, "cpu"), 0, 1.0)
    with pytest.raises(ValueError, match="must be a tensor on cpu"):
        train(params, state, batch, 0, 1.0)   # numpy, not moved
    with pytest.raises(ValueError, match="other parameter tensors"):
        train(_fresh(params), state, tstep.device_batch(batch, "cpu"), 0, 1.0)
