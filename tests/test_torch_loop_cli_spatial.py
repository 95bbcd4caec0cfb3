"""The port's SpatialNet command line and reference checkpoints against the
JAX package on the CPU, over both base captioners: ``--mode train_spatial``
for two epochs on a tiny corpus of YOLO grid features (``bbox_feats/``) in
both packages from one set of JAX-initialised weights, with beam-3
validation, then eval and decode; the converter and exporter leaf for leaf
against ``vcr_tpu.convert`` with exact round trips; ``--mode
export_reference`` against the JAX package's ``.net`` (BatchNorm counters
included); and ``--mode verify_parity`` on a ``.net`` the JAX package
exported, equal to the JAX package's, and on the port's own export, equal to
``--mode decode``."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import test_convert as tc
import test_convert_spatial_rationale as tsr
from vcr_tpu import config as jconfig
from vcr_tpu import convert as jconvert
from vcr_tpu import tools as jtools
from vcr_tpu import vocab as jvocab
from vcr_tpu.models import base as jbase
from vcr_tpu.train import checkpoint as jckpt
from vcr_tpu.train import loop as jloop
from vcr_tpu.train import optim as joptim
from vcr_tpu.utils import logging as jlogging
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch import config as tconfig
from vcr_tpu_torch import convert as tconvert
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.utils import logging as tlogging

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_convert import _assert_trees_equal  # noqa: E402
from test_torch_loop_cli import (LOSS_TOL, _argv, _assert_eval_equal,  # noqa: E402
                                 _flags, _jax_init_params, _Recorder)
from util_corpus import build_corpus  # noqa: E402

BASES = ["s2vt", "s2vt-att"]
GRID = 4
VOCAB, EMBED, HIDDEN, FEAT = 19, 16, 8, 12


def _io(flags):
    return {k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")}


@pytest.fixture(scope="module", params=BASES)
def trained(request, tmp_path_factory):
    """Both packages run --mode train_spatial for 2 epochs over ``arch`` on
    one yolo corpus from the same initial weights (dropout 0, static teacher
    forcing), validating with beam search of width 3."""
    tmp = str(tmp_path_factory.mktemp("loop_spatial"))
    build_corpus(os.path.join(tmp, "data"), feat_type="yolo", grid=GRID)
    flags = _flags(tmp, mode="train_spatial", arch=request.param)
    jcfg = jconfig.Config(**dict(flags, save_path=os.path.join(tmp, "jax_models")))
    init = _jax_init_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        jrec = _Recorder(mp, jloop, jlogging.TrainLogger)
        jloop.train(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        trec = _Recorder(mp, tloop, tlogging.TrainLogger)
        mp.setattr(tloop, "init_params",
                   lambda cfg, spec, vocab, device: bridge.from_jax_params(init, device))
        cli.main(_argv(flags))
    return dict(tmp=tmp, flags=flags, jcfg=jcfg, jrec=jrec, trec=trec)


def test_train_spatial_matches_jax(trained):
    """Per-step losses within LOSS_TOL, per-epoch validation metrics equal,
    and the checkpoint's BN running stats moved and within 1e-5 of JAX's."""
    jrec, trec = trained["jrec"], trained["trec"]
    assert len(trec.evals) == len(jrec.evals) == 2
    assert len(trec.steps) == len(jrec.steps) == 4
    for got, want in zip(trec.steps, jrec.steps):
        for k in ("loss", "acc"):
            assert abs(got[k] - want[k]) <= LOSS_TOL, (k, got[k], want[k])
    for got, want in zip(trec.evals, jrec.evals):
        _assert_eval_equal(got, want)
    tparams, _, meta = tckpt.load_checkpoint(
        os.path.join(trained["flags"]["save_path"], "model_best"), "cpu")
    jparams = jckpt.load_checkpoint(jckpt.best_path(trained["jcfg"].save_path))[0]
    assert meta["config"]["mode"] == "train_spatial"
    assert not torch.equal(tparams["bn2"]["var"], torch.ones_like(tparams["bn2"]["var"]))
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(tparams[bn][k].numpy(), np.asarray(jparams[bn][k]),
                                       rtol=0, atol=1e-5)


def test_eval_and_decode_match_jax(trained):
    flags, jcfg = trained["flags"], trained["jcfg"]
    io = _io(flags)
    got = cli.main(_argv(dict(io, mode="eval")))
    want = jloop.evaluate_checkpoint(jconfig.Config(**dict(io, mode="eval",
                                                           save_path=jcfg.save_path)))
    _assert_eval_equal(got, want)
    for beam in (1, 3):
        tokens = cli.main(_argv(dict(io, mode="decode", beam_size=beam)))
        with open(os.path.join(flags["save_path"], "captions.json")) as f:
            assert json.load(f) == tokens
        jtokens = jtools.decode_corpus(
            jconfig.Config(**dict(io, mode="decode", save_path=jcfg.save_path)),
            beam_size=beam)
        assert tokens == jtokens and len(tokens) == 3


def test_export_and_verify_parity_equal_decode(trained):
    """--mode export_reference of the trained checkpoint (BN counters = its
    n_iter), then --mode verify_parity of that .net with a wrong --arch:
    the family and its base are detected, and the captions equal --mode
    decode's greedy ones."""
    flags = trained["flags"]
    io = _io(flags)
    net = cli.main(_argv(dict(io, mode="export_reference")))
    sd = tconvert.read_reference_checkpoint(net)["state_dict"]
    assert tconvert.detect_arch(sd) == "spatial"
    assert sd["conv.1.num_batches_tracked"].item() == 4           # 2 epochs x 2 steps
    decoded = cli.main(_argv(dict(io, mode="decode")))
    model = {k: flags[k] for k in ("num_frames", "vid_feat_size", "max_len",
                                   "hidden_size", "bsize", "compute_dtype", "seed")}
    wrong = "s2vt" if flags["arch"] == "s2vt-att" else "s2vt-att"
    parity = cli.main(_argv(dict(io, **model, mode="verify_parity", arch=wrong,
                                 pretrained_base=net,
                                 save_path=os.path.join(trained["tmp"], "parity"))))
    assert parity == decoded and len(parity) == 3


# ------------------------------------------------ the converter

class _TorchSpatial(nn.Module):
    """state_dict-compatible skeleton of the reference SpatialNet over
    either captioner (``tsr.TorchSpatial`` is over S2VT only)."""

    def __init__(self, base_arch):
        super().__init__()
        cap = tc.TorchS2VTAtt if base_arch == "s2vt-att" else tc.TorchS2VT
        self.caption_net = cap(VOCAB, EMBED, HIDDEN, FEAT)
        self.conv = nn.Sequential(
            nn.Conv2d(FEAT, HIDDEN, 3, 1, 1), nn.BatchNorm2d(HIDDEN), nn.ReLU(),
            nn.Conv2d(HIDDEN, HIDDEN, 3, 1, 1), nn.BatchNorm2d(HIDDEN), nn.ReLU())
        self.attention = tsr.TorchSpatialAttention(HIDDEN)


def _reference_sd(base_arch):
    """A reference SpatialNet state_dict with random running stats."""
    with torch.random.fork_rng():
        torch.manual_seed(BASES.index(base_arch))
        sd = _TorchSpatial(base_arch).state_dict()
        for i in (1, 4):
            sd[f"conv.{i}.running_mean"].normal_()
            sd[f"conv.{i}.running_var"].uniform_(0.5, 2.0)
            sd[f"conv.{i}.num_batches_tracked"].fill_(9)
    kw = dict(arch="spatial", vocab_size=VOCAB, embed_size=EMBED, hidden_size=HIDDEN,
              vid_feat_size=FEAT, max_len=5, num_frames=4, dropout_p=0.0,
              sos_id=VOCAB - 4, compute_dtype="float32", base_arch=base_arch,
              vocab_pad_to=8, grid_size=GRID)
    return sd, jbase.ModelSpec(**kw), tbase.ModelSpec(**kw)


def _assert_exports_equal(got, want):
    """A port export equals the JAX package's: float32 tensors, and the
    BatchNorm counters int64."""
    assert sorted(got) == sorted(want)
    for k in want:
        dtype = torch.int64 if k.endswith("num_batches_tracked") else torch.float32
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("base_arch", BASES)
def test_convert_and_export_match_jax(base_arch):
    """convert_state_dict and export_state_dict equal the JAX package's leaf
    for leaf; export . convert gives the state_dict back (its counters 0,
    as the JAX package's), convert . export the params."""
    sd, jspec, tspec = _reference_sd(base_arch)
    assert tconvert.detect_arch(sd) == jconvert.detect_arch(sd) == "spatial"
    assert tconvert.detect_base_arch(sd) == jconvert.detect_base_arch(sd) == base_arch
    params = tconvert.convert_state_dict(sd, tspec, "spatial")
    jparams = jconvert.convert_state_dict(sd, jspec, "spatial")
    _assert_trees_equal(params, jparams)
    exported = tconvert.export_state_dict(params, tspec, "spatial")
    _assert_exports_equal(exported, jconvert.export_state_dict(jparams, jspec, "spatial"))
    for k, v in sd.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
        assert torch.equal(exported[k], want), k
    _assert_trees_equal(tconvert.convert_state_dict(exported, tspec, "spatial"), jparams)
    # OIHW on both sides: the conv weights move untransposed
    assert torch.equal(params["conv2"]["w"], sd["conv.3.weight"])


def _jax_spatial_checkpoint(tmp, data, arch):
    """A JAX package train_spatial checkpoint of seeded random weights (BN
    stats off their init values) and its Config."""
    jcfg = jconfig.Config(mode="train_spatial", data_dir=data, corpus="msvd_vgg", bsize=2,
                          glove_emb_file="glove_tiny.txt", num_frames=4, vid_feat_size=12,
                          arch=arch, max_len=6, hidden_size=16, compute_dtype="float32",
                          save_path=os.path.join(tmp, f"jax_{arch}"), log_dir="", seed=5)
    vocab = jvocab.Vocab(os.path.join(data, "msvd_vgg", "glove", "glove_tiny.txt"),
                         seed=jcfg.seed)
    spec = jbase.spec_from_config(jcfg, vocab).with_(arch="spatial")
    params = jbase.build_model("spatial")[0](jax.random.PRNGKey(3), spec, vocab.vectors)
    params = jax.tree_util.tree_map(np.asarray, params)
    r = np.random.default_rng(4)
    for bn in ("bn1", "bn2"):
        params[bn] = dict(params[bn], mean=r.normal(0, 0.1, 16).astype(np.float32),
                          var=r.uniform(0.5, 2.0, 16).astype(np.float32))
    opt = joptim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    meta = {"epoch": 2, "n_iter": 7, "config": jcfg.to_dict(), "val_meteor_score": 0.25,
            "best_val_meteor_score": 0.5}
    jckpt.save_checkpoint(jckpt.best_path(jcfg.save_path), params, opt.init(params), meta)
    return jcfg, params


@pytest.mark.parametrize("base_arch", BASES)
def test_reference_files_match_jax(base_arch, tmp_path):
    """On one set of weights: the JAX package's .net reads back into them;
    the port's --mode export_reference writes the JAX package's .net (the
    BN counters at the checkpoint's n_iter); and --mode verify_parity on the
    JAX package's .net, with a wrong --arch, gives its captions."""
    data = str(tmp_path / "data")
    build_corpus(data, feat_type="yolo", grid=GRID)
    jcfg, jparams = _jax_spatial_checkpoint(str(tmp_path), data, base_arch)
    jnet = jtools.export_reference_checkpoint(jcfg)
    cfg = tconfig.Config(**dict(jcfg.to_dict(), arch="s2vt"))
    spec = tbase.spec_from_config(cfg, tloop.load_vocab(cfg))
    params, meta = tconvert.load_reference_checkpoint(jnet, spec, "s2vt")
    assert (meta["detected_arch"], meta["detected_base_arch"]) == ("spatial", base_arch)
    _assert_trees_equal(params, jparams)

    save = str(tmp_path / "port")
    tparams = bridge.from_jax_params(jparams, "cpu")
    tckpt.save_checkpoint(tckpt.best_path(save), tparams,
                          toptim.build_optimizer("adam", 1e-3, 0.0, 1.0).init(tparams),
                          {"epoch": 2, "n_iter": 7, "config": jcfg.to_dict(),
                           "val_meteor_score": 0.25, "best_val_meteor_score": 0.5})
    io = dict(data_dir=data, corpus="msvd_vgg", glove_emb_file="glove_tiny.txt")
    net = cli.main(_argv(dict(io, mode="export_reference", save_path=save)))
    got, want = tconvert.read_reference_checkpoint(net), torch.load(jnet,
                                                                     weights_only=False)
    _assert_exports_equal(got["state_dict"], want["state_dict"])
    assert got["state_dict"]["conv.4.num_batches_tracked"].item() == 7
    assert vars(got["opts"]) == vars(want["opts"])

    model = dict(io, num_frames=4, vid_feat_size=12, max_len=6, hidden_size=16, bsize=2,
                 compute_dtype="float32", seed=5,
                 arch="s2vt" if base_arch == "s2vt-att" else "s2vt-att")
    jwant = jtools.verify_parity(jconfig.Config(mode="verify_parity", **model), jnet)
    parity = cli.main(_argv(dict(model, mode="verify_parity", pretrained_base=jnet,
                                 save_path=str(tmp_path / "parity"))))
    assert parity == jwant and len(parity) == 3
