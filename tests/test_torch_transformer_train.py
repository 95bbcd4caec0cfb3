"""The port's Transformer training against the JAX package on the CPU, from
one JAX parameter tree: three steps of ``build_step_fns("transformer")``
against JAX's with every dropout at 0, every gradient leaf against
``jax.grad``, the eval step, and the bf16 residual stream with its norms
recomputed in the backward (and with the whole forward rematerialized)
against the same step without, bit for bit."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.models import transformer as jtr
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu_torch.models import transformer as ttr
from vcr_tpu_torch.nn import layers as tlayers
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_transformer import B, DIMS, models  # noqa: E402

LR, WD, MAX_NORM = 1e-3, 1e-4, 0.1   # the clip is active at every step
# the bounds of tests/test_torch_train_s2vt_att.py: float32 sums in other
# orders, 3 steps
LOSS_TOL, PARAM_TOL = 1e-5, 5e-6
GRAD_TOL = 1e-4      # float32 gradient leaf, relative to max(1, max|g|); read 1.0e-7


@pytest.fixture
def no_dropout(monkeypatch):
    """The internal dropouts at 0 in both packages (a module constant each,
    read when called), and ``dropout_p`` 0 in both specs: then nothing is
    drawn and the two steps can agree."""
    monkeypatch.setattr(jtr, "INTERNAL_DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "INTERNAL_DROPOUT", 0.0)
    jspec, jparams, tspec, tparams, _ = models()
    return jspec.with_(dropout_p=0.0), jparams, tspec.with_(dropout_p=0.0), tparams


def _batch(r, b=B):
    return {
        "vid_feats": r.standard_normal((b, DIMS["num_frames"], DIMS["vid_feat"])
                                       ).astype(np.float32),
        "sent": r.integers(0, DIMS["vocab_size"], (b, DIMS["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, DIMS["max_len"] + 1, (b,)).astype(np.int32),
        "valid": np.ones((b,), np.float32),
    }


def _fresh(params):
    return jax.tree_util.tree_map(lambda a: a.detach().clone() if isinstance(a, torch.Tensor)
                                  else jnp.array(a), params)


def test_three_train_steps_match_jax(no_dropout):
    """Three Adam steps with the clip active: losses, greedy predictions of
    the step's logits and every parameter against JAX's step."""
    jspec, jparams, tspec, tparams = no_dropout
    jopt = joptim.build_optimizer("adam", LR, WD, MAX_NORM)
    jtrain, _ = jstep.build_step_fns("transformer", jspec, jopt, static_tf=1.0)
    jparams, tparams = _fresh(jparams), _fresh(tparams)
    jstate = jopt.init(jparams)
    topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    tstate = topt.init(tparams)
    ttrain, _ = tstep.build_step_fns("transformer", tspec, topt, static_tf=1.0,
                                     device="cpu")
    r = np.random.default_rng(3)
    for i in range(3):
        batch = _batch(r)
        jparams, jstate, jm, jpred = jtrain(jparams, jstate,
                                            {k: jnp.asarray(v) for k, v in batch.items()},
                                            jax.random.PRNGKey(i), 1.0)
        tparams, tstate, tm, tpred = ttrain(tparams, tstate,
                                            tstep.device_batch(batch, "cpu"), i, 1.0)
        assert set(tm) == set(jm) == {"loss", "acc"}
        assert abs(tm["loss"].item() - float(jm["loss"])) <= LOSS_TOL
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    got = jax.tree_util.tree_leaves(tparams)
    for (path, want), g in zip(jax.tree_util.tree_flatten_with_path(jparams)[0], got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL, err_msg=jax.tree_util.keystr(path))


def test_gradients_match_jax(no_dropout):
    """The masked cross-entropy and every gradient leaf of the train forward
    against ``jax.grad`` of the JAX package's."""
    jspec, jparams, tspec, tparams = no_dropout
    batch = _batch(np.random.default_rng(4))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits = jtr.apply(p, jspec, jb["vid_feats"], jb["sent"], jb["sent_len"],
                           rng=jax.random.PRNGKey(0), train=True)
        return jlosses.masked_cross_entropy(logits, jb["sent"], jb["sent_len"],
                                            jb["valid"])

    want_loss, want = jax.value_and_grad(jloss)(jparams)
    params = _fresh(tparams)
    leaves = jax.tree_util.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    tb = tstep.device_batch(batch, "cpu")
    logits = ttr.apply(params, tspec, tb["vid_feats"], tb["sent"], tb["sent_len"], rng=0,
                       train=True)
    loss = tlosses.masked_cross_entropy(logits, tb["sent"], tb["sent_len"], tb["valid"])
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            torch.autograd.grad(loss, leaves, allow_unused=True,
                                                materialize_grads=True)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= GRAD_TOL, jax.tree_util.keystr(path)


def test_eval_step_matches_jax():
    """The eval step: the parity greedy decode's logits into the masked
    losses, and its tokens."""
    jspec, jparams, tspec, tparams, _ = models()
    batch = _batch(np.random.default_rng(5))
    batch["valid"][2] = 0.0
    _, jeval = jstep.build_step_fns("transformer", jspec,
                                    joptim.build_optimizer("adam", LR, WD, MAX_NORM))
    jm, jpred = jeval(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _, teval = tstep.build_step_fns("transformer", tspec,
                                    toptim.build_optimizer("adam", LR, WD, MAX_NORM),
                                    device="cpu")
    tm, tpred = teval(tparams, tstep.device_batch(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in tm:
        assert abs(tm[k].item() - float(jm[k])) <= LOSS_TOL
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_bf16_stream_norm_remat_and_remat_are_bitwise_equal(monkeypatch):
    """bf16 with every dropout on: the train stream is bf16; a step whose
    norms are recomputed in the backward (the default) equals one that keeps
    them, and a step with remat=True equals one without, bit for bit."""
    _, _, tspec, tparams, _ = models("bfloat16")
    batch = tstep.device_batch(_batch(np.random.default_rng(6)), "cpu")
    x = batch["vid_feats"]
    assert ttr.encode(tparams, tspec, x, ttr.create_masks_inp(x), train=True,
                      ).dtype == torch.bfloat16
    assert ttr.encode(tparams, tspec, x, ttr.create_masks_inp(x)).dtype == torch.float32

    def step(remat):
        params = _fresh(tparams)
        opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
        train, _ = tstep.build_step_fns("transformer", tspec, opt, remat=remat,
                                        device="cpu")
        grads = train.__self__.grads(params, opt.init(params).leaves, batch, 3, 1.0)[0]
        params = train(params, opt.init(params), batch, 3, 1.0)[0]
        return grads + jax.tree_util.tree_leaves(params)

    checkpointed, plain_remat = step(False), step(True)
    with monkeypatch.context() as mp:
        mp.setattr(ttr, "_norm", lambda params, x, train: tlayers.torch_norm(params, x))
        kept = step(False)
    for a, b, c in zip(checkpointed, kept, plain_remat):
        assert torch.equal(a, b) and torch.equal(a, c)
