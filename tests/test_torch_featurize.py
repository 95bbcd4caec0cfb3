"""Raw frames to captions in the port against the JAX package on the CPU:
``serving.build_captioner`` with a fused featurizer (VGG16 fc7 into S2VT,
ResNet into S2VT-att, the Darknet cut into SpatialNet over S2VT), greedy
and at beam 3, in float32 and bf16; the featurized artifact of
``export_serving`` against the live call and against JAX's leaves; the
refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import export_serving as jexport
from vcr_tpu import serving as jserving
from vcr_tpu.models import base as jbase
from vcr_tpu.models import darknet as jdn
from vcr_tpu.models import resnet as jresnet
from vcr_tpu.models import vgg as jvgg
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import export_serving as texport
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import darknet as tdn
from vcr_tpu_torch.models import resnet as tresnet

from test_torch_darknet import RESIDUAL_CFG, _random_bn

DIMS = dict(vocab_size=40, embed_size=8, hidden=16, max_len=6, num_frames=3)
B = 2
FEAT_TOL = 1e-5          # float32 features relative to the largest |feature|
LOGIT_TOL = 1e-4         # float32 logits of the captioner on those features
TOKEN_AGREEMENT = 0.98   # bf16 tokens, the port's bound; read 100%
# featurizer -> (captioner arch, its feature width, frame size)
PATHS = {"vgg16": ("s2vt", 64, 32), "resnet": ("s2vt-att", 512, 32),
         "yolo": ("spatial", 16, 16)}


def _vgg_params():
    """VGG16's 13 convs (numpy-drawn, one tree for both) with fc6/fc7 of
    (512, 64) and (64, 64): at 32x32 fc6 reads 512 values."""
    rng = np.random.default_rng(0)
    p, in_ch = {"convs": []}, 3
    for v in (c for c in jvgg._CFG if c != "M"):
        p["convs"].append({"w": ((2.0 / (in_ch * 9)) ** 0.5 * rng.standard_normal(
            (v, in_ch, 3, 3))).astype(np.float32), "b": np.full((v,), 0.01, np.float32)})
        in_ch = v
    p["fc6"] = {"w": (0.05 * rng.standard_normal((512, 64))).astype(np.float32),
                "b": np.full((64,), 0.1, np.float32)}
    p["fc7"] = {"w": (0.05 * rng.standard_normal((64, 64))).astype(np.float32),
                "b": np.zeros((64,), np.float32)}
    return p


@pytest.fixture(scope="module")
def backbones(tmp_path_factory):
    """featurizer -> (JAX feat_params, the port's): the Darknet a residual
    block and a head (its cut (16, 8, 8) at 16x16), as objects."""
    cfg = tmp_path_factory.mktemp("yolo") / "net.cfg"
    cfg.write_text(RESIDUAL_CFG)
    # the JAX Darknet of the cfg, given the port's init (its own would draw
    # each layer through a compiled jax.random call)
    jnet = jdn.Darknet.__new__(jdn.Darknet)
    jnet.blocks = jdn.parse_cfg(str(cfg))
    jnet.net_info, jnet.filter_chain = jnet.blocks[0], jdn.build_filter_chain(jnet.blocks)
    jnet.header = np.zeros(5, dtype=np.int32)
    jnet.params = _random_bn(bridge.to_numpy(
        tdn.init_params(torch.Generator().manual_seed(4), jnet.blocks)),
        np.random.default_rng(4))
    resnet = bridge.to_numpy(tresnet.init_params(torch.Generator().manual_seed(2),
                                                 "resnet18"))
    vgg = _vgg_params()
    return {"vgg16": (vgg, bridge.from_jax_params(vgg, "cpu")),
            "resnet": (resnet, bridge.from_jax_params(resnet, "cpu")),
            "yolo": (jnet, bridge.from_jax_darknet(jnet, "cpu"))}


def _models(featurizer, dtype):
    arch, feat, _ = PATHS[featurizer]
    kw = dict(DIMS, vid_feat=feat, arch=arch, compute_dtype=dtype, vocab_pad_to=8)
    if arch == "spatial":
        kw.update(base_arch="s2vt", grid_size=8)
    jspec, jparams = graft._make_spec_and_params(**kw)
    tspec, _ = entry.make_spec_and_params(**kw, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu")


def _frames(featurizer, seed=0):
    size = PATHS[featurizer][2]
    return np.random.default_rng(seed).standard_normal(
        (B, DIMS["num_frames"], 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("featurizer", sorted(PATHS))
def test_featurized_features_and_logits_match_jax(backbones, featurizer):
    """float32: the features of all B*N frames as one batch, shaped (B, N,
    ...), and the captioner's logits on them."""
    jfp, tfp = backbones[featurizer]
    jspec, jparams, tspec, tparams = _models(featurizer, "float32")
    frames = _frames(featurizer)
    flat = jnp.asarray(frames.reshape(-1, *frames.shape[2:]))
    if featurizer == "vgg16":
        want = jax.jit(jvgg.extract_fc7, static_argnums=2)(jfp, flat, jnp.float32)
    elif featurizer == "resnet":
        want = jax.jit(jresnet.extract_features, static_argnums=2)(jfp, flat, jnp.float32)
    else:
        want = jax.jit(lambda p, x: jfp.get_feats(x, jnp.float32, params=p))(
            jfp.params, flat)
    want = np.array(want).reshape(B, DIMS["num_frames"], *want.shape[1:])
    featurize = tserving.make_featurize(tspec, featurizer,
                                        tfp if featurizer == "yolo" else None)
    got = featurize(tfp.params if featurizer == "yolo" else tfp, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= FEAT_TOL * np.abs(want).max()
    _, apply_fn = tbase.build_model(tspec.arch)
    _, japply = jbase.build_model(jspec.arch)
    jout = japply(jparams, jspec, jnp.asarray(want), train=False)
    tout = apply_fn(tparams, tspec, torch.from_numpy(want))
    if featurizer == "yolo":
        jout, tout = jout[0], tout[0]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("featurizer, beam", [("vgg16", 1), ("vgg16", 3), ("resnet", 1),
                                              ("resnet", 3), ("yolo", 1), ("yolo", 3)])
def test_featurized_captioner_matches_jax(backbones, featurizer, beam):
    """float32 tokens identical, greedy and at beam 3."""
    jfp, tfp = backbones[featurizer]
    jspec, jparams, tspec, tparams = _models(featurizer, "float32")
    frames = _frames(featurizer, seed=1)
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer, jfp,
                                               beam_size=beam)(jnp.asarray(frames)))
    got = tserving.build_captioner(tparams, tspec, featurizer, tfp, beam_size=beam,
                                   device="cpu")(frames)
    assert got.shape == (B, DIMS["max_len"]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("featurizer", sorted(PATHS))
def test_featurized_captioner_bf16_agrees_with_jax(backbones, featurizer):
    jfp, tfp = backbones[featurizer]
    jspec, jparams, tspec, tparams = _models(featurizer, "bfloat16")
    frames = _frames(featurizer, seed=2)
    want = np.asarray(jserving.build_captioner(jparams, jspec, featurizer, jfp)(
        jnp.asarray(frames)))
    got = tserving.build_captioner(tparams, tspec, featurizer, tfp, device="cpu")(frames)
    assert (got.numpy() == want).mean() >= TOKEN_AGREEMENT


@pytest.mark.parametrize("featurizer", sorted(PATHS))
def test_featurized_artifact_equals_the_live_call(backbones, featurizer, tmp_path):
    """An artifact with the backbone in its program (raw frames in, tokens
    out), exported and loaded on the CPU: the live call's tokens, at the
    example batch and another; its input is (N, 3, S, S) and its leaves are
    (captioner, featurizer)'s, a Darknet's weightless layers holding none."""
    _, tfp = backbones[featurizer]
    _, _, tspec, tparams = _models(featurizer, "bfloat16")
    size = PATHS[featurizer][2]
    out = texport.export_captioner(tparams, tspec, str(tmp_path / "a"), featurizer, tfp,
                                   image_size=size, device="cpu")
    art = texport.load_artifact(out, device="cpu")
    assert art.meta["input_item_shape"] == [DIMS["num_frames"], 3, size, size]
    assert art.meta["featurizer"] == featurizer and art.meta["image_size"] == size
    weights = tfp.params if featurizer == "yolo" else tfp
    assert art.meta["num_weight_leaves"] == len(texport.flatten_tree(
        (tparams, weights))[0])
    live = tserving.build_captioner(tparams, tspec, featurizer, tfp, device="cpu")
    for b in (B, 3):
        frames = np.random.default_rng(b).standard_normal(
            (b, DIMS["num_frames"], 3, size, size)).astype(np.float32)
        assert torch.equal(art(frames), live(frames))


def test_featurized_artifact_leaves_match_jax(backbones, tmp_path):
    """weights.npz of a fused VGG16 artifact holds the JAX package's leaves
    for the same weights, key for key; a Darknet tree flattens as
    jax.tree_util flattens it (None layers hold no leaf)."""
    jfp, tfp = backbones["vgg16"]
    jspec, jparams, tspec, tparams = _models("vgg16", "float32")
    texport.export_captioner(tparams, tspec, str(tmp_path / "port"), "vgg16", tfp,
                             image_size=32, device="cpu")
    jexport.export_captioner(jparams, jspec, str(tmp_path / "jax"), "vgg16", jfp,
                             image_size=32)
    with np.load(tmp_path / "port" / "weights.npz") as a, \
            np.load(tmp_path / "jax" / "weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    jnet, tnet = backbones["yolo"]
    tleaves = texport.flatten_tree((tparams, tnet.params))[0]
    jleaves = jax.tree_util.tree_leaves((jparams, jnet.params))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    skeleton = texport.tree_skeleton(tnet.params)
    rebuilt = texport.fill_tree(skeleton, texport.flatten_tree(tnet.params)[0])
    assert [p is None for p in rebuilt] == [p is None for p in tnet.params]


def test_featurizer_refusals(backbones):
    """A backbone without its weights, weights without a backbone, a
    Darknet's weights without the Darknet, an unknown featurizer: each
    raises before anything runs, in serving and in the export; so does a
    dp artifact whose fixed batch dp does not divide."""
    _, tfp = backbones["vgg16"]
    _, _, tspec, tparams = _models("vgg16", "float32")
    with pytest.raises(ValueError, match="needs feat_params"):
        tserving.build_captioner(tparams, tspec, "vgg16", device="cpu")
    with pytest.raises(ValueError, match="featurizer='none'"):
        tserving.build_captioner(tparams, tspec, "none", tfp, device="cpu")
    with pytest.raises(TypeError, match="Darknet"):
        tserving.build_captioner(tparams, tspec, "yolo", {"w": 0}, device="cpu")
    with pytest.raises(ValueError, match="unknown featurizer"):
        tserving.build_captioner(tparams, tspec, "alexnet", tfp, device="cpu")
    with pytest.raises(ValueError, match="needs feat_params"):
        texport.export_captioner(tparams, tspec, "/nonexistent", "resnet", device="cpu")
    with pytest.raises(ValueError, match="not divisible by dp"):
        texport.export_captioner(tparams, tspec, "/nonexistent", "vgg16", tfp, dp=2,
                                 batch_size=3, device="cpu")
    assert not os.path.exists("/nonexistent")
