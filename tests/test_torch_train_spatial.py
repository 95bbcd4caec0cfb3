"""The port's SpatialNet training against the JAX package on the CPU (Pallas
GRU in interpret mode), from one JAX parameter tree, over both base
captioners: three steps of ``build_step_fns("spatial")`` against JAX's
(losses, parameters and the BatchNorm running stats after each step),
``grad_accum=2`` (the stats follow the last microbatch), ``remat=True`` bit
for bit, the frozen stats, and bf16 gradients through both convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.models import spatial as tspatial
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=8, max_len=5,
            num_frames=4)
GRID, B = 3, 4
LR, WD, MAX_NORM = 1e-3, 1e-4, 0.1   # the clip is active at every step
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6      # the other captioners' 3-step bounds
BN_TOL = 1e-5                         # running stats after each step


def _specs(base_arch, **kw):
    """(JAX spec, JAX params, port spec, port params), one parameter tree."""
    common = dict(arch="spatial", base_arch=base_arch, grid_size=GRID,
                  compute_dtype="float32", vocab_pad_to=8)
    jspec, jparams = graft._make_spec_and_params(**DIMS, use_pallas=True, **common)
    tspec, _ = entry.make_spec_and_params(**DIMS, device="cpu", **common)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec.with_(**kw), jparams, tspec.with_(**kw), bridge.from_jax_params(
        jparams, "cpu")


def _batch(r, b=B):
    return {
        "vid_feats": r.standard_normal((b, DIMS["num_frames"], DIMS["vid_feat"], GRID,
                                        GRID)).astype(np.float32),
        "sent": r.integers(0, DIMS["vocab_size"], (b, DIMS["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, DIMS["max_len"] + 1, (b,)).astype(np.int32),
        "valid": np.ones((b,), np.float32),
    }


def _fresh(params):
    return jax.tree_util.tree_map(lambda a: a.detach().clone() if isinstance(a, torch.Tensor)
                                  else jnp.array(a), params)


def _assert_params_close(tparams, jparams, atol, bn_atol=BN_TOL):
    got = bridge.to_numpy(tparams)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        tol = bn_atol if path[-1].key in ("mean", "var") else atol
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("base_arch", ["s2vt", "s2vt-att"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(base_arch, grad_accum):
    """Three Adam steps with the clip active, p=0, the last batch with a
    padding row: losses, predictions, parameters and BN running stats after
    each step against JAX's build_step_fns("spatial"); with grad_accum=2 the
    stats are the last microbatch's."""
    jspec, jparams, tspec, tparams = _specs(base_arch, dropout_p=0.0)
    jopt = joptim.build_optimizer("adam", LR, WD, MAX_NORM)
    jtrain, _ = jstep.build_step_fns("spatial", jspec, jopt, static_tf=1.0,
                                     grad_accum=grad_accum)
    jparams, tparams = _fresh(jparams), _fresh(tparams)
    jstate = jopt.init(jparams)
    topt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    tstate = topt.init(tparams)
    assert not any(p[-1] in ("mean", "var") for p in tstate.paths)   # frozen
    ttrain, _ = tstep.build_step_fns("spatial", tspec, topt, static_tf=1.0,
                                     grad_accum=grad_accum, device="cpu")
    r = np.random.default_rng(3)
    for i in range(3):
        batch = _batch(r)
        if i == 2:
            batch["valid"][-1] = 0.0   # BN still sees the padding row, as in JAX
        before = _fresh(tparams)
        jparams, jstate, jm, jpred = jtrain(jparams, jstate,
                                            {k: jnp.asarray(v) for k, v in batch.items()},
                                            jax.random.PRNGKey(i), 1.0)
        tb = tstep.device_batch(batch, "cpu")
        tparams, tstate, tm, tpred = ttrain(tparams, tstate, tb, i, 1.0)
        assert set(tm) == set(jm) == {"loss", "acc"}
        assert abs(tm["loss"].item() - float(jm["loss"])) <= LOSS_TOL
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        _assert_params_close(tparams, jparams, PARAM_TOL)
        assert not torch.equal(before["bn1"]["mean"], tparams["bn1"]["mean"])
    # the stats are those of the last microbatch's forward from the step's
    # starting parameters, bit for bit
    m = B // grad_accum
    stats = []
    with torch.no_grad():
        for rows in (slice(0, m), slice(B - m, B)):
            stats.append(tspatial.apply(before, tspec, tb["vid_feats"][rows],
                                        tb["sent"][rows], rng=0, train=True)[2])
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            assert torch.equal(tparams[bn][k], stats[1][bn][k])
    assert grad_accum == 1 or not torch.equal(stats[0]["bn1"]["mean"],
                                              stats[1]["bn1"]["mean"])


@pytest.mark.parametrize("base_arch", ["s2vt", "s2vt-att"])
def test_remat_is_bitwise_equal(base_arch):
    """bf16 with dropout: a step with remat=True (the forward, B1 and the
    trunk, run again in the backward) equals one without, bit for bit, the
    BN running stats included, and leaves them moved once."""
    _, _, tspec, tparams = _specs(base_arch, dropout_p=0.2, compute_dtype="bfloat16")
    batch = tstep.device_batch(_batch(np.random.default_rng(6)), "cpu")
    out = {}
    for remat in (False, True):
        params = _fresh(tparams)
        opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
        train, _ = tstep.build_step_fns("spatial", tspec, opt, remat=remat, device="cpu")
        grads = train.__self__.grads(params, opt.init(params).leaves, batch, 3, 1.0)[0]
        out[remat] = (grads, train(params, opt.init(params), batch, 3, 1.0)[0])
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(out[False][1]),
                    jax.tree_util.tree_leaves(out[True][1])):
        assert torch.equal(a, b)
    # one momentum step from the initial stats (0 and 1)
    with torch.no_grad():
        _, _, bn = tspatial.apply(_fresh(tparams), tspec, batch["vid_feats"],
                                  batch["sent"], rng=3, train=True)
    for k in ("mean", "var"):
        assert torch.equal(out[True][1]["bn2"][k], bn["bn2"][k])


def test_bf16_gradients_through_both_convs():
    """As tests/test_bf16_spatial_train.py holds the JAX package's: the bf16
    train forward differentiates through both convs, finite and non-zero."""
    _, _, tspec, tparams = _specs("s2vt", dropout_p=0.0, compute_dtype="bfloat16")
    batch = tstep.device_batch(_batch(np.random.default_rng(9), 2), "cpu")
    params = _fresh(tparams)
    leaves = [params["conv1"]["w"], params["conv2"]["w"], params["bn1"]["scale"]]
    for x in leaves:
        x.requires_grad_(True)
    logits, _, _ = tspatial.apply(params, tspec, batch["vid_feats"], batch["sent"], rng=1,
                                  train=True)
    loss = tlosses.masked_cross_entropy(logits, batch["sent"], batch["sent_len"])
    assert torch.isfinite(loss)
    for g in torch.autograd.grad(loss, leaves):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
