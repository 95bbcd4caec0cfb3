"""The port's reference-checkpoint converter (``vcr_tpu_torch.convert``) and
its two tools against ``vcr_tpu.convert`` and ``vcr_tpu.tools`` on the CPU:
state_dicts of the reference's layout (the skeletons of
``tests/test_convert.py``) converted and exported leaf for leaf as the JAX
package does, both round trips, family detection, the reading of a ``.net``
file that the JAX package exported from its own checkpoint, and
``verify_parity``'s captions on one corpus."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import test_convert as tc
from test_torch_decode import _jax_gumbel
from vcr_tpu import config as jconfig
from vcr_tpu import convert as jconvert
from vcr_tpu import tools as jtools
from vcr_tpu import vocab as jvocab
from vcr_tpu.models import base as jbase
from vcr_tpu.train import checkpoint as jckpt
from vcr_tpu.train import optim as joptim
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch import config as tconfig
from vcr_tpu_torch import convert as tconvert
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.train import optim as toptim

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

VOCAB, EMBED, HIDDEN, FEAT = 19, 16, 8, 12
FAMILIES = ["s2vt", "s2vt-att", "rationale-s2vt", "rationale-s2vt-att"]


class _TorchRationale(nn.Module):
    """state_dict-compatible skeleton of the reference RationaleNet over
    either captioner."""

    def __init__(self, base_arch):
        super().__init__()
        cap = tc.TorchS2VTAtt if base_arch == "s2vt-att" else tc.TorchS2VT
        self.caption_net = cap(VOCAB, EMBED, HIDDEN, FEAT)
        self.gen = nn.Module()
        self.gen.rnn = nn.LSTM(FEAT, HIDDEN, bidirectional=True)
        self.gen.linear = nn.Linear(2 * HIDDEN, 2)


def _family(name):
    """-> (arch, base_arch, reference state_dict, JAX spec, port spec)."""
    arch, _, base = name.partition("-s2vt")
    base_arch = "s2vt" + base if arch == "rationale" else "s2vt"
    arch = arch if arch == "rationale" else name
    with torch.random.fork_rng():
        torch.manual_seed(FAMILIES.index(name))
        if arch == "rationale":
            module = _TorchRationale(base_arch)
        else:
            module = (tc.TorchS2VTAtt if arch == "s2vt-att" else tc.TorchS2VT)(
                VOCAB, EMBED, HIDDEN, FEAT)
    kw = dict(arch=arch, vocab_size=VOCAB, embed_size=EMBED, hidden_size=HIDDEN,
              vid_feat_size=FEAT, max_len=5, num_frames=4, dropout_p=0.0, sos_id=VOCAB - 4,
              compute_dtype="float32", base_arch=base_arch, vocab_pad_to=8)
    return (arch, base_arch, module.state_dict(), jbase.ModelSpec(**kw),
            tbase.ModelSpec(**kw))


def _assert_trees_equal(got, want):
    """A port tree (tensors) equals a JAX tree leaf for leaf, bit for bit."""
    flat_got, tree_got = jax.tree_util.tree_flatten(bridge.to_numpy(got))
    flat_want, tree_want = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, want))
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_convert_and_export_match_jax(name):
    """convert_state_dict and export_state_dict equal the JAX package's leaf
    for leaf, and each undoes the other exactly."""
    arch, base_arch, sd, jspec, tspec = _family(name)
    assert tconvert.detect_arch(sd) == jconvert.detect_arch(sd) == arch
    assert (tconvert.detect_base_arch(sd) == jconvert.detect_base_arch(sd)
            == (base_arch if arch == "rationale" else None))
    params = tconvert.convert_state_dict(sd, tspec, arch)
    jparams = jconvert.convert_state_dict(sd, jspec, arch)
    _assert_trees_equal(params, jparams)
    exported = tconvert.export_state_dict(params, tspec, arch)
    _assert_state_dicts_equal(exported, jconvert.export_state_dict(jparams, jspec, arch))
    _assert_state_dicts_equal(exported, sd)                       # export . convert
    _assert_trees_equal(tconvert.convert_state_dict(exported, tspec, arch), jparams)
    # the conversion is a copy: a live model's later update does not reach it
    key = next(iter(sd))
    before = params if arch != "rationale" else params["caption_net"]
    sd[key].add_(1.0)
    assert not any(torch.equal(x, sd[key]) for x in
                   jax.tree_util.tree_leaves(before) if x.shape == sd[key].shape)


def test_detect_and_refuse_what_is_not_ported():
    # SpatialNet converts since A11 (tests/test_torch_loop_cli_spatial.py):
    # only its detection stays here
    spatial = {"conv.0.weight": 0, "caption_net.rnn1.weight_ih_l0": 0}
    assert tconvert.detect_arch(spatial) == jconvert.detect_arch(spatial) == "spatial"
    assert tconvert.detect_base_arch(spatial) == jconvert.detect_base_arch(spatial)
    # the Transformer converts since A12 (tests/test_torch_transformer_cli.py):
    # its detection stays here, and its refusal gives way to the one both
    # directions keep, an unknown family
    transformer = {"encoder.layers.0.attn.q_linear.weight": 0}
    assert tconvert.detect_arch(transformer) == jconvert.detect_arch(transformer) \
        == "transformer"
    assert tconvert.detect_base_arch(transformer) == jconvert.detect_base_arch(transformer)
    with pytest.raises(NotImplementedError, match="Unknown"):
        tconvert.convert_state_dict({}, _family("s2vt")[4], "lstm-lm")
    with pytest.raises(NotImplementedError, match="Unknown"):
        tconvert.export_state_dict({}, _family("s2vt")[4], "lstm-lm")


# ------------------------------------------------ .net files and the tools

def _jax_checkpoint(tmp, data, arch, mode):
    """A JAX package checkpoint (Orbax tree + meta) of seeded random weights
    for ``arch`` trained by ``mode``, and its Config."""
    jcfg = jconfig.Config(mode=mode, data_dir=data, corpus="msvd_vgg", bsize=2,
                          glove_emb_file="glove_tiny.txt", num_frames=4, vid_feat_size=12,
                          arch=arch, max_len=6, hidden_size=16, compute_dtype="float32",
                          save_path=os.path.join(tmp, f"jax_{mode}_{arch}"), log_dir="",
                          seed=5)
    vocab = jvocab.Vocab(os.path.join(data, "msvd_vgg", "glove", "glove_tiny.txt"),
                         seed=jcfg.seed)
    spec = jbase.spec_from_config(jcfg, vocab)
    model = "rationale" if mode == "train_rationale" else arch
    params = jbase.build_model(model)[0](jax.random.PRNGKey(3), spec.with_(arch=model),
                                         vocab.vectors)
    opt = joptim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    meta = {"epoch": 2, "n_iter": 7, "config": jcfg.to_dict(), "val_meteor_score": 0.25,
            "best_val_meteor_score": 0.5}
    jckpt.save_checkpoint(jckpt.best_path(jcfg.save_path), params, opt.init(params), meta)
    return jcfg, params


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """For S2VT-att and RationaleNet over it: a JAX checkpoint, its .net
    export by vcr_tpu.tools, and the corpus both decode."""
    tmp = str(tmp_path_factory.mktemp("convert"))
    data = os.path.join(tmp, "data")
    build_corpus(data)
    out = {}
    for mode in ("train", "train_rationale"):
        jcfg, jparams = _jax_checkpoint(tmp, data, "s2vt-att", mode)
        net = jtools.export_reference_checkpoint(jcfg)
        out[mode] = (jcfg, jparams, net)
    return tmp, data, out


@pytest.mark.parametrize("mode", ["train", "train_rationale"])
def test_load_reference_checkpoint_reads_a_jax_export(exported, mode):
    """The .net the JAX package exported from its checkpoint reads back
    (weights_only, opts as a Namespace) into the JAX checkpoint's weights."""
    _, _, out = exported
    jcfg, jparams, net = out[mode]
    arch = "rationale" if mode == "train_rationale" else "s2vt-att"
    # the spec of the checkpoint's config, with a wrong base: it is detected
    cfg = tconfig.Config(**dict(jcfg.to_dict(), arch="s2vt"))
    spec = tbase.spec_from_config(cfg, tloop.load_vocab(cfg))
    params, meta = tconvert.load_reference_checkpoint(net, spec, "s2vt-att")
    assert meta["detected_arch"] == arch
    assert meta["detected_base_arch"] == ("s2vt-att" if arch == "rationale" else None)
    assert (meta["epoch"], meta["n_iter"], meta["best_val_meteor_score"]) == (2, 7, 0.5)
    assert meta["opts"].arch == "s2vt-att" and meta["opts"].mode == mode
    _assert_trees_equal(params, jparams)


def test_export_reference_matches_jax(exported, tmp_path):
    """The port's --mode export_reference of its own checkpoint writes the
    .net the JAX package writes of the same weights."""
    _, data, out = exported
    jcfg, jparams, jnet = out["train"]
    tcfg = tconfig.Config(**jcfg.to_dict())
    save = str(tmp_path / "port")
    params = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tckpt.save_checkpoint(tckpt.best_path(save), params,
                          toptim.build_optimizer("adam", 1e-3, 0.0, 1.0).init(params),
                          {"epoch": 2, "n_iter": 7, "config": tcfg.to_dict(),
                           "val_meteor_score": 0.25, "best_val_meteor_score": 0.5})
    net = cli.main(["--mode", "export_reference", "--data_dir", data, "--corpus",
                    "msvd_vgg", "--glove_emb_file", "glove_tiny.txt", "--save_path", save,
                    "--device", "cpu"])
    assert net == os.path.join(save, "model_export.net")
    got, want = tconvert.read_reference_checkpoint(net), torch.load(jnet,
                                                                     weights_only=False)
    _assert_state_dicts_equal(got["state_dict"], want["state_dict"])
    assert {k: v for k, v in got.items() if k not in ("state_dict", "opts")} == {
        k: v for k, v in want.items() if k not in ("state_dict", "opts")}
    assert vars(got["opts"]) == vars(want["opts"])


@pytest.mark.parametrize("mode", ["train", "train_rationale"])
def test_verify_parity_matches_jax(exported, monkeypatch, mode):
    """--mode verify_parity on the JAX package's .net: the port's captions
    equal the JAX package's verify_parity. RationaleNet's greedy forward
    draws its selection noise from PRNGKey(0) there; here it is given that
    noise."""
    tmp, data, out = exported
    jcfg, _, net = out[mode]
    io = dict(data_dir=data, corpus="msvd_vgg", glove_emb_file="glove_tiny.txt",
              num_frames=4, vid_feat_size=12, max_len=6, hidden_size=16, bsize=2,
              compute_dtype="float32", seed=5,
              # RationaleNet's base is detected from the keys: give it a wrong one
              arch="s2vt-att" if mode == "train" else "s2vt")
    want = jtools.verify_parity(jconfig.Config(mode="verify_parity", **io), net)
    k_gen, _ = jax.random.split(jax.random.PRNGKey(0))
    monkeypatch.setattr(trationale, "sample_gumbel", lambda shape, gen, device:
                        torch.from_numpy(_jax_gumbel(k_gen, shape)))
    save = os.path.join(tmp, f"parity_{mode}")
    argv = ["--mode", "verify_parity", "--pretrained_base", net, "--save_path", save,
            "--device", "cpu"]
    for k, v in io.items():
        argv += [f"--{k}", str(v)]
    got = cli.main(argv)
    assert got == want and len(got) == 3
    assert os.path.exists(os.path.join(save, "parity.json"))
    with pytest.raises(SystemExit, match="needs --pretrained_base"):
        cli.main(["--mode", "verify_parity", "--device", "cpu"])
