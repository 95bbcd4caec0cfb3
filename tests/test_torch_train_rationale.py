"""The port's RationaleNet training against the JAX package on the CPU
(Pallas BiLSTM and GRU in interpret mode), from one JAX parameter tree and
one numpy Gumbel noise per step: the three-term loss, its gradient through
B2's and B1's sequences and the soft Gumbel-Softmax, and Adam."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.models import rationale as jrationale
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

# the widths of tests/test_torch_s2vt.py, 4 frames and 5 tokens
DIMS = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=5,
            num_frames=4)
B = 4
LR, WD, MAX_NORM = 1e-3, 1e-4, 1.0
LAM_B, LAM_C = 0.3, 0.2
# the bounds of tests/test_train_equivalence.py's RationaleNet lockstep
LOSS_TOL, PARAM_TOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def models():
    kw = dict(DIMS, arch="rationale", base_arch="s2vt", compute_dtype="float32",
              vocab_pad_to=8)
    jspec, jparams = graft._make_spec_and_params(**kw, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**kw, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return (jspec.with_(dropout_p=0.0), jparams, tspec.with_(dropout_p=0.0),
            bridge.from_jax_params(jparams, "cpu"))


def _batch(r):
    return {
        "vid_feats": r.standard_normal((B, DIMS["num_frames"], DIMS["vid_feat"])
                                       ).astype(np.float32),
        "sent": r.integers(0, DIMS["vocab_size"], (B, DIMS["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, DIMS["max_len"] + 1, (B,)).astype(np.int32),
        "valid": np.ones((B,), np.float32),
    }


def test_three_steps_under_injected_noise_match_jax(models):
    """ce + 0.3 brevity + 0.2 continuity, soft Gumbel-Softmax on shared
    noise, p=0, tf=1.0: three Adam steps of the port against the JAX
    package's rationale.apply + losses + build_optimizer."""
    jspec, jparams, tspec, tparams = models
    tparams = jax.tree_util.tree_map(lambda a: a.clone(), tparams)
    jopt = joptim.build_optimizer("adam", LR, WD, MAX_NORM)

    def jloss(p, b, noise):
        logits, probs = jrationale.apply(p, jspec, b["vid_feats"], b["sent"],
                                         b["sent_len"], rng=jax.random.PRNGKey(0),
                                         train=True, teacher_force_prob=1.0,
                                         gumbel_noise=noise)
        return (jlosses.masked_cross_entropy(logits, b["sent"], b["sent_len"], b["valid"])
                + LAM_B * jlosses.brevity_loss(probs, b["valid"])
                + LAM_C * jlosses.continuity_loss(probs, b["valid"]))

    @jax.jit
    def jstep_fn(p, o, b, noise):
        loss, grads = jax.value_and_grad(jloss)(p, b, noise)
        updates, o = jopt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    tstate = topt.init(tparams)
    jstate = jopt.init(jparams)
    r = np.random.default_rng(9)
    j_losses, t_losses = [], []
    for _ in range(3):
        batch = _batch(r)
        noise = (-np.log(-np.log(r.uniform(1e-6, 1.0, (B, DIMS["num_frames"], 2))))
                 ).astype(np.float32)
        jparams, jstate, jl = jstep_fn(jparams, jstate,
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(noise))
        j_losses.append(float(jl))
        tb = tstep.device_batch(batch, "cpu")
        with torch.enable_grad():
            logits, probs = trationale.apply(tparams, tspec, tb["vid_feats"], tb["sent"],
                                             rng=0, train=True, teacher_force_prob=1.0,
                                             gumbel_noise=torch.from_numpy(noise))
            assert not torch.equal(probs, probs.round())  # soft at train
            loss = (tlosses.masked_cross_entropy(logits, tb["sent"], tb["sent_len"],
                                                 tb["valid"])
                    + LAM_B * tlosses.brevity_loss(probs, tb["valid"])
                    + LAM_C * tlosses.continuity_loss(probs, tb["valid"]))
            grads = torch.autograd.grad(loss, tstate.leaves)
        topt.step(tstate, grads)
        t_losses.append(loss.item())
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    got = bridge.to_numpy(tparams)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_step_metric_keys_match_jax(models):
    """build_step_fns("rationale"): a train step and an eval step report
    JAX's metric keys (the same _forward serves both there)."""
    jspec, jparams, tspec, tparams = models
    tparams = jax.tree_util.tree_map(lambda a: a.clone(), tparams)
    batch = _batch(np.random.default_rng(10))
    _, jeval = jstep.build_step_fns("rationale", jspec,
                                    joptim.build_optimizer("adam", LR, WD, MAX_NORM))
    jm, _ = jeval(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    train, teval = tstep.build_step_fns("rationale", tspec, opt, lambda_brev=LAM_B,
                                        lambda_cont=LAM_C, device="cpu")
    tb = tstep.device_batch(batch, "cpu")
    _, _, tm, pred = train(tparams, opt.init(tparams), tb, 0, 1.0)
    em, _ = teval(tparams, tb)
    assert set(tm) == set(em) == set(jm) == {"loss", "loss_ce", "loss_brev", "loss_cont",
                                             "len", "acc"}
    assert pred.shape == (B, DIMS["max_len"]) and pred.dtype == torch.int32
    assert abs(tm["loss"].item() - (tm["loss_ce"] + tm["loss_brev"]
                                    + tm["loss_cont"]).item()) <= 1e-6
    assert tm["loss_brev"].item() == pytest.approx(LAM_B * tm["len"].item(), abs=1e-6)


def test_hoisted_equals_general(models):
    """With dropout on the generator and the caption net, a Python tf of 1.0
    (hoisted decode) and a tensor tf of 1.0 (general loop) read the same
    draws of one seed."""
    _, _, tspec, tparams = models
    spec = tspec.with_(dropout_p=0.3)
    batch = tstep.device_batch(_batch(np.random.default_rng(11)), "cpu")
    out = [trationale.apply(tparams, spec, batch["vid_feats"], batch["sent"], rng=4,
                            train=True, teacher_force_prob=tf)
           for tf in (1.0, torch.tensor(1.0))]
    for hoisted, general in zip(*out):
        np.testing.assert_allclose(hoisted.numpy(), general.numpy(), rtol=1e-6, atol=1e-6)


def test_train_refusals(models):
    _, _, tspec, tparams = models
    feats = torch.zeros((B, DIMS["num_frames"], DIMS["vid_feat"]))
    with pytest.raises(ValueError, match="teacher tokens"):
        trationale.apply(tparams, tspec, feats, train=True)
    # over S2VT-att it trains since A9; a base that is no video captioner raises
    with pytest.raises(NotImplementedError, match="unknown video captioning arch"):
        trationale.apply(tparams, tspec.with_(base_arch="transformer"), feats,
                         torch.zeros((B, DIMS["max_len"]), dtype=torch.int32), train=True)
