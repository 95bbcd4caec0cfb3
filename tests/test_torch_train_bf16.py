"""The bf16 train step of every family but S2VT against ``jax.value_and_grad``
of the JAX package's on the CPU, at the bounds of
``test_torch_train_s2vt.py::test_bf16_step_matches_jax``: one step each,
p=0, static tf=1.0, at the widths of each family's float32 train tests.

* S2VT-att, SpatialNet over S2VT and over S2VT-att, through
  ``build_step_fns``'s gradients;
* RationaleNet over S2VT under one injected Gumbel noise, through its
  forward and losses (the steps draw their own noise);
* the Transformer, with JAX's side in a subprocess started with
  ``XLA_FLAGS=--xla_allow_excess_precision=false``. XLA reads the flag when
  its backend starts, so it cannot be set in a process that has already
  imported JAX. With the flag at its default (on), XLA's fusions skip some
  roundings of the bf16 train stream: on this test's batch the worst leaf
  then reads 6.9e-3 (``decoder.layers.ff.linear_1.w``), past the bound, and
  the loss 1.4e-3 (2.7e-3 and 6.6e-4 on another batch).

Readings (loss gap, worst leaf): S2VT-att 0, 9.5e-7 (encoder.rnn.w_ih);
SpatialNet over S2VT 9.3e-5, 5.0e-4 (caption_net.rnn2.w_ih); over S2VT-att
9.5e-7, 2.5e-4 (caption_net.decoder.rnn.w_ih); RationaleNet 0, 4.8e-7; the
Transformer without excess precision 0, 4.5e-8.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu.models import base as jbase
from vcr_tpu.models import rationale as jrationale
from vcr_tpu.train import losses as jlosses
from vcr_tpu.train import step as jstep
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.models import transformer as ttr
from vcr_tpu_torch.train import losses as tlosses
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_LOSS_TOL = 2e-3   # test_torch_train_s2vt.py's bf16 bounds
BF16_GRAD_TOL = 1e-3   # per leaf, relative to max(1, max|g|)
LR, WD, MAX_NORM = 1e-3, 1e-4, 0.1
LAM_B, LAM_C = 0.3, 0.2

# each family's float32 train test's widths and batch
FAMILIES = {
    "s2vt-att": (dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
                      num_frames=5), {}, 6),
    "spatial-s2vt": (dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=8, max_len=5,
                          num_frames=4),
                     dict(arch="spatial", base_arch="s2vt", grid_size=3), 4),
    "spatial-s2vt-att": (dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=8,
                              max_len=5, num_frames=4),
                         dict(arch="spatial", base_arch="s2vt-att", grid_size=3), 4),
    "rationale": (dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=5,
                       num_frames=4), dict(arch="rationale", base_arch="s2vt"), 4),
}


def _models(dims, kw):
    kw = dict(kw)
    kw.setdefault("arch", "s2vt-att")
    jspec, jparams = graft._make_spec_and_params(**dims, compute_dtype="bfloat16",
                                                 vocab_pad_to=8, use_pallas=True, **kw)
    tspec, _ = entry.make_spec_and_params(**dims, compute_dtype="bfloat16",
                                          vocab_pad_to=8, device="cpu", **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return (jspec.with_(dropout_p=0.0), jparams, tspec.with_(dropout_p=0.0),
            bridge.from_jax_params(jparams, "cpu"))


def _batch(r, dims, b, grid=None):
    frame = (dims["vid_feat"],) if grid is None else (dims["vid_feat"], grid, grid)
    return {
        "vid_feats": r.standard_normal((b, dims["num_frames"], *frame)).astype(np.float32),
        "sent": r.integers(0, dims["vocab_size"], (b, dims["max_len"])).astype(np.int32),
        "sent_len": r.integers(1, dims["max_len"] + 1, (b,)).astype(np.int32),
        "valid": np.ones((b,), np.float32),
    }


def _assert_grads(paths, grads, want_loss, loss, want):
    assert abs(loss - float(want_loss)) <= BF16_LOSS_TOL
    for path, g in zip(paths, grads):
        w = want
        for k in path:
            w = w[k]
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max() / max(1.0, float(np.abs(w).max()))
        assert err <= BF16_GRAD_TOL, (path, err)


@pytest.mark.parametrize("family", ["s2vt-att", "spatial-s2vt", "spatial-s2vt-att"])
def test_bf16_step_matches_jax(family):
    dims, kw, b = FAMILIES[family]
    jspec, jparams, tspec, tparams = _models(dims, kw)
    batch = _batch(np.random.default_rng(7), dims, b, kw.get("grid_size"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jspec.arch
    _, apply_fn = jbase.build_model(model)

    def fwd(p, vf, s, sl, rng, tf):
        return apply_fn(p, jspec, vf, s, sl, rng=rng, train=True, teacher_force_prob=1.0)

    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jstep._forward(
        model, fwd, p, jb, jax.random.PRNGKey(0), 1.0, 1.0, 1.0)[0]))(jparams)
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    state = opt.init(tparams)
    train, _ = tstep.build_step_fns(model, tspec, opt, static_tf=1.0, device="cpu")
    grads, metrics, *_ = train.__self__.grads(tparams, state.leaves,
                                              tstep.device_batch(batch, "cpu"), 0, 1.0)
    _assert_grads(state.paths, grads, want_loss, metrics["loss"].item(), want)


def test_bf16_rationale_step_under_injected_noise_matches_jax():
    dims, kw, b = FAMILIES["rationale"]
    jspec, jparams, tspec, tparams = _models(dims, kw)
    r = np.random.default_rng(9)
    batch = _batch(r, dims, b)
    noise = (-np.log(-np.log(r.uniform(1e-6, 1.0, (b, dims["num_frames"], 2))))
             ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits, probs = jrationale.apply(p, jspec, jb["vid_feats"], jb["sent"],
                                         jb["sent_len"], rng=jax.random.PRNGKey(0),
                                         train=True, teacher_force_prob=1.0,
                                         gumbel_noise=jnp.asarray(noise))
        return (jlosses.masked_cross_entropy(logits, jb["sent"], jb["sent_len"],
                                             jb["valid"])
                + LAM_B * jlosses.brevity_loss(probs, jb["valid"])
                + LAM_C * jlosses.continuity_loss(probs, jb["valid"]))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    state = toptim.build_optimizer("adam", LR, WD, MAX_NORM).init(tparams)
    tb = tstep.device_batch(batch, "cpu")
    with torch.enable_grad():
        logits, probs = trationale.apply(tparams, tspec, tb["vid_feats"], tb["sent"], rng=0,
                                         train=True, teacher_force_prob=1.0,
                                         gumbel_noise=torch.from_numpy(noise))
        loss = (tlosses.masked_cross_entropy(logits, tb["sent"], tb["sent_len"],
                                             tb["valid"])
                + LAM_B * tlosses.brevity_loss(probs, tb["valid"])
                + LAM_C * tlosses.continuity_loss(probs, tb["valid"]))
        grads = torch.autograd.grad(loss, state.leaves)
    _assert_grads(state.paths, grads, want_loss, loss.item(), want)


# the widths of test_torch_transformer*.py
TF_DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=32, max_len=7,
               num_frames=5)
TF_B = 4

JAX_SIDE = """
import json, sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp, numpy as np
import __graft_entry__ as graft
from vcr_tpu.models import transformer as jtr
from vcr_tpu.train import losses as jlosses
jtr.INTERNAL_DROPOUT = 0.0
dims, b, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jspec, jparams = graft._make_spec_and_params(**dims, arch="transformer",
                                             compute_dtype="bfloat16", vocab_pad_to=8,
                                             tf_layers=2, tf_heads=2)
jspec = jspec.with_(dropout_p=0.0)
r = np.random.default_rng(4)
batch = {{
    "vid_feats": r.standard_normal((b, dims["num_frames"], dims["vid_feat"])
                                   ).astype(np.float32),
    "sent": r.integers(0, dims["vocab_size"], (b, dims["max_len"])).astype(np.int32),
    "sent_len": r.integers(1, dims["max_len"] + 1, (b,)).astype(np.int32),
    "valid": np.ones((b,), np.float32)}}
jb = {{k: jnp.asarray(v) for k, v in batch.items()}}

def jloss(p):
    logits = jtr.apply(p, jspec, jb["vid_feats"], jb["sent"], jb["sent_len"],
                       rng=jax.random.PRNGKey(0), train=True)
    return jlosses.masked_cross_entropy(logits, jb["sent"], jb["sent_len"], jb["valid"])

loss, grads = jax.jit(jax.value_and_grad(jloss))(jparams)
flat = {{}}
for prefix, tree in (("p", jparams), ("g", grads)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(out, loss=np.asarray(loss), **{{"b/" + k: v for k, v in batch.items()}}, **flat)
"""


def _unflatten(npz, prefix):
    tree = {}
    for name in npz.files:
        if not name.startswith(prefix + "/"):
            continue
        node, keys = tree, name.split("/")[1:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = npz[name]
    return tree


def test_bf16_transformer_step_matches_jax_without_excess_precision(tmp_path, monkeypatch):
    script = tmp_path / "jax_side.py"
    script.write_text(JAX_SIDE.format(repo=REPO))
    out = tmp_path / "jax_side.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, str(script), json.dumps(TF_DIMS), str(TF_B), str(out)],
                   check=True, env=env, cwd=REPO, timeout=300)
    npz = np.load(out)
    monkeypatch.setattr(ttr, "INTERNAL_DROPOUT", 0.0)
    tspec, _ = entry.make_spec_and_params(**TF_DIMS, arch="transformer",
                                          compute_dtype="bfloat16", vocab_pad_to=8,
                                          tf_layers=2, tf_heads=2, device="cpu")
    tspec = tspec.with_(dropout_p=0.0)
    tparams = bridge.from_jax_params(_unflatten(npz, "p"), "cpu")
    batch = {k: npz["b/" + k] for k in ("vid_feats", "sent", "sent_len", "valid")}
    opt = toptim.build_optimizer("adam", LR, WD, MAX_NORM)
    state = opt.init(tparams)
    train, _ = tstep.build_step_fns("transformer", tspec, opt, static_tf=1.0,
                                    device="cpu")
    grads, metrics, *_ = train.__self__.grads(tparams, state.leaves,
                                              tstep.device_batch(batch, "cpu"), 0, 1.0)
    _assert_grads(state.paths, grads, npz["loss"], metrics["loss"].item(),
                  _unflatten(npz, "g"))
