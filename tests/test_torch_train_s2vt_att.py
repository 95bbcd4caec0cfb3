"""The port's S2VT-att training, and RationaleNet over S2VT-att, against the
JAX package on the CPU (Pallas kernels in interpret mode), from one JAX
parameter tree: three steps of ``build_step_fns("s2vt-att")`` against JAX's,
the eval step, gate remat and remat bit for bit, and RationaleNet over
S2VT-att under one injected Gumbel noise, at eval and at train."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.models import rationale as jrationale
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
            num_frames=5)
B = 6
LR, WD, MAX_NORM = 1e-3, 1e-4, 0.1   # the clip is active at every step
# the bounds of tests/test_torch_train_s2vt.py (those of
# tests/test_train_equivalence.py): float32 sums in other orders, 3 steps
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5      # float32 gradient leaf, relative to max(1, max|g|)
LAM_B, LAM_C = 0.3, 0.2


def _specs(arch="s2vt-att", **kw):
    """(JAX spec, JAX params, port spec, port params), one parameter tree."""
    extra = dict(base_arch="s2vt-att") if arch == "rationale" else {}
    jspec, jparams = graft._make_spec_and_params(
        **DIMS, arch=arch, compute_dtype="float32", vocab_pad_to=8, use_pallas=True,
        **extra)
    tspec, _ = entry.make_spec_and_params(**DIMS, arch=arch, compute_dtype="float32",
                                          vocab_pad_to=8, device="cpu", **extra)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec.with_(**kw), jparams, tspec.with_(**kw), bridge.from_jax_params(
        jparams, "cpu")


def _batch(r):
    return {
        "vid_feats": r.standard_normal((B, DIMS["num_frames"], DIMS["vid_feat"])
                                       ).astype(np.float32),
        "sent": r.integers(0, DIMS["vocab_size"], (B, DIMS["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, DIMS["max_len"] + 1, (B,)).astype(np.int32),
        "valid": np.ones((B,), np.float32),
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _fresh(params):
    return jax.tree_util.tree_map(lambda a: a.detach().clone() if isinstance(a, torch.Tensor)
                                  else jnp.array(a), params)


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
    jspec, jparams, tspec, tparams = _specs(dropout_p=0.0)
    jopt = joptim.build_optimizer("adam", LR, WD, MAX_NORM)
    jtrain, jeval = jstep.build_step_fns("s2vt-att", jspec, jopt, static_tf=1.0)
    return dict(jspec=jspec, jparams=jparams, tspec=tspec, tparams=tparams, jopt=jopt,
                jtrain=jtrain, jeval=jeval)


def test_three_train_steps_match_jax(f32):
    """Three Adam steps with the clip active, p=0: losses, greedy
    predictions and parameters against JAX's build_step_fns("s2vt-att")."""
    r = np.random.default_rng(3)
    jparams, tparams = _fresh(f32["jparams"]), _fresh(f32["tparams"])
    jstate = f32["jopt"].init(jparams)
    topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    tstate = topt.init(tparams)
    ttrain, _ = tstep.build_step_fns("s2vt-att", f32["tspec"], topt, static_tf=1.0,
                                     device="cpu")
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(r)
        jparams, jstate, jm, jpred = f32["jtrain"](jparams, jstate, _jbatch(batch),
                                                   jax.random.PRNGKey(i), 1.0)
        tparams, tstate, tm, tpred = ttrain(tparams, tstate,
                                            tstep.device_batch(batch, "cpu"), i, 1.0)
        j_losses.append(float(jm["loss"]))
        t_losses.append(tm["loss"].item())
        assert set(tm) == set(jm) == {"loss", "acc"}
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(tparams, jparams, PARAM_TOL)


def test_eval_step_matches_jax(f32):
    batch = _batch(np.random.default_rng(5))
    batch["valid"][2] = 0.0
    jm, jpred = f32["jeval"](f32["jparams"], _jbatch(batch))
    _, teval = tstep.build_step_fns("s2vt-att", f32["tspec"],
                                    toptim.build_optimizer("adam", LR, WD, MAX_NORM),
                                    device="cpu")
    tm, tpred = teval(f32["tparams"], tstep.device_batch(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in tm:
        assert abs(tm[k].item() - float(jm[k])) <= LOSS_TOL
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_gate_remat_and_remat_are_bitwise_equal():
    """bf16 with dropout: a step with remat=True (the forward, B1 and the
    scan, run again in the backward) equals one without, bit for bit; the
    step runs gate remat, which changes no bit either (its gradient equals
    the one outside the step's scope)."""
    _, _, tspec, tparams = _specs(dropout_p=0.2)
    tspec = tspec.with_(compute_dtype="bfloat16")
    batch = tstep.device_batch(_batch(np.random.default_rng(6)), "cpu")
    steps = {}
    for remat in (False, True):
        params = _fresh(tparams)
        opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
        train, _ = tstep.build_step_fns("s2vt-att", tspec, opt, remat=remat, device="cpu")
        fns = train.__self__
        grads = fns.grads(params, opt.init(params).leaves, batch, 3, 1.0)[0]
        steps[remat] = (grads, train(params, opt.init(params), batch, 3, 1.0))
    for a, b in zip(steps[False][0], steps[True][0]):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(steps[False][1][0]),
                    jax.tree_util.tree_leaves(steps[True][1][0])):
        assert torch.equal(a, b)
    # outside the step, no gate remat: the same gradient
    params = _fresh(tparams)
    leaves = jax.tree_util.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    _, apply_fn = tbase.build_model("s2vt-att")
    logits = apply_fn(params, tspec, batch["vid_feats"], batch["sent"], rng=3, train=True)
    loss = tlosses.masked_cross_entropy(logits, batch["sent"], batch["sent_len"],
                                        batch["valid"])
    for a, b in zip(torch.autograd.grad(loss, leaves), steps[False][0]):
        assert torch.equal(a, b)


# ------------------------------------------------ RationaleNet over S2VT-att

@pytest.fixture(scope="module")
def rat():
    jspec, jparams, tspec, tparams = _specs("rationale", dropout_p=0.0)
    r = np.random.default_rng(11)
    feats = r.standard_normal((B, DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32)
    noise = r.gumbel(size=(B, DIMS["num_frames"], 2)).astype(np.float32)
    return jspec, jparams, tspec, tparams, feats, noise


def test_rationale_eval_matches_jax(rat):
    """Hard selection under one noise: selections equal, logits and tokens
    of the wrapped S2VT-att equal JAX's."""
    jspec, jparams, tspec, tparams, feats, noise = rat
    want, want_probs = jrationale.apply(jparams, jspec, jnp.asarray(feats),
                                        rng=jax.random.PRNGKey(0), train=False,
                                        gumbel_noise=jnp.asarray(noise))
    got, probs = trationale.apply(tparams, tspec, torch.from_numpy(feats),
                                  gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(probs.numpy(), np.asarray(want_probs))
    assert 0.0 < probs[..., 1].mean().item() < 1.0    # some frames are dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    tokens, _ = trationale.apply(tparams, tspec, torch.from_numpy(feats), emit="tokens",
                                 gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want).argmax(-1))


def test_rationale_train_matches_jax(rat):
    """Soft selection under one noise, p=0: the three-term loss and every
    leaf's gradient (B2's and B1's Functions, AttentionScan) against
    jax.grad of the JAX package's composition."""
    jspec, jparams, tspec, tparams, feats, noise = rat
    r = np.random.default_rng(12)
    sent = r.integers(0, DIMS["vocab_size"], (B, DIMS["max_len"])).astype(np.int32)
    sent_len = r.integers(1, DIMS["max_len"] + 1, (B,)).astype(np.int32)
    valid = np.ones((B,), np.float32)

    def jloss(p):
        logits, probs = jrationale.apply(p, jspec, jnp.asarray(feats), jnp.asarray(sent),
                                         rng=jax.random.PRNGKey(0), train=True,
                                         gumbel_noise=jnp.asarray(noise))
        v = jnp.asarray(valid)
        return (jlosses.masked_cross_entropy(logits, jnp.asarray(sent),
                                             jnp.asarray(sent_len), v)
                + LAM_B * jlosses.brevity_loss(probs, v)
                + LAM_C * jlosses.continuity_loss(probs, v))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = _fresh(tparams)
    leaves = jax.tree_util.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    logits, probs = trationale.apply(params, tspec, torch.from_numpy(feats),
                                     torch.from_numpy(sent), train=True,
                                     gumbel_noise=torch.from_numpy(noise))
    assert not torch.equal(probs, probs.round())   # soft at train
    v = torch.from_numpy(valid)
    loss = (tlosses.masked_cross_entropy(logits, torch.from_numpy(sent),
                                         torch.from_numpy(sent_len), v)
            + LAM_B * tlosses.brevity_loss(probs, v) + LAM_C * tlosses.continuity_loss(
                probs, v))
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            torch.autograd.grad(loss, leaves)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= GRAD_TOL, jax.tree_util.keystr(path)


def test_rationale_steps_and_captioner_run(rat):
    """build_step_fns("rationale") over S2VT-att: a train step moves the
    parameters and reports JAX's metric keys; the greedy captioner serves."""
    _, _, tspec, tparams, feats, _ = rat
    params = _fresh(tparams)
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    train, teval = tstep.build_step_fns("rationale", tspec, opt, lambda_brev=LAM_B,
                                        lambda_cont=LAM_C, device="cpu")
    batch = tstep.device_batch(_batch(np.random.default_rng(13)), "cpu")
    before = params["caption_net"]["decoder"]["attention"]["query_layer"]["w"].clone()
    _, _, metrics, pred = train(params, opt.init(params), batch, 0, 1.0)
    assert set(metrics) == {"loss", "loss_ce", "loss_brev", "loss_cont", "len", "acc"}
    assert not torch.equal(before,
                           params["caption_net"]["decoder"]["attention"]["query_layer"]["w"])
    assert pred.shape == (B, DIMS["max_len"])
    tokens = tserving.build_captioner(params, tspec, device="cpu")(feats)
    assert tokens.shape == (B, DIMS["max_len"]) and tokens.dtype == torch.int32
