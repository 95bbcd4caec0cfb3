"""The port's prep and export modes against the JAX package's modules on
the same inputs: ``--mode extract_captions`` (the three corpora),
``extract_glove``, ``extract_video_feats`` (the ResNet route on synthetic
clips and the MSVD-VGG repackager), ``extract_bbox_feats`` and
``eval_attention``, each through ``vcr_tpu_torch.cli``; the frame
preprocessing; the rationale overlay; and the refusals, cv2 missing
among them."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.config import Config as JConfig
from vcr_tpu.data.prep import bbox_feats as jbbox
from vcr_tpu.data.prep import frames as jframes
from vcr_tpu.data.prep import glove as jglove
from vcr_tpu.data.prep import video_feats as jvideo
from vcr_tpu.evals import attention_export as jatt
from vcr_tpu.models import base as jbase
from vcr_tpu.models import darknet as jdn
from vcr_tpu.train import checkpoint as jckpt
from vcr_tpu.vocab import Vocab as JVocab
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch.data.prep import frames as tframes
from vcr_tpu_torch.evals import attention_export as tatt
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import optim

from test_cli_prep import (test_extract_captions_msrvtt, test_extract_captions_msvd,
                           test_extract_captions_msvd_vgg)
from test_torch_backbones import torchvision_resnet_state_dict
from test_torch_darknet import RESIDUAL_CFG, _random_bn
from util_corpus import build_corpus

cv2 = pytest.importorskip("cv2")

FEAT_TOL = 2e-2   # bf16 features (the prep modes run their backbone in bf16),
                  # relative to the largest |feature|: the backbone tests'
                  # bf16 envelope; read 5.3e-3 (ResNet-18), 1.6e-3 (Darknet)
ALPHA_TOL = 1e-5  # float32 attention maps (softmax outputs)


def _port(mode, data_dir, *extra):
    return cli.main(["--mode", mode, "--data_dir", str(data_dir), "--device", "cpu",
                     *extra])


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("corpus, jax_test", [
    ("msvd_vgg", test_extract_captions_msvd_vgg), ("msvd", test_extract_captions_msvd),
    ("msrvtt", test_extract_captions_msrvtt)])
def test_extract_captions_matches_jax(tmp_path, corpus, jax_test):
    """The JAX package's own prep test writes its corpus and runs JAX's
    extractor; the port's --mode extract_captions on a copy of the same
    inputs writes the same JSON files (the same shuffle, seed 0)."""
    jax_test(tmp_path / "j")
    port = tmp_path / "p"
    shutil.copytree(tmp_path / "j", port)
    for f in (port / "data" / corpus).glob("*_captions.json"):
        f.unlink()
    _port("extract_captions", port / "data", "--corpus", corpus, "--seed", "0")
    jdir, pdir = tmp_path / "j" / "data" / corpus, port / "data" / corpus
    names = sorted(f.name for f in jdir.glob("*_captions.json"))
    assert names == sorted(f.name for f in pdir.glob("*_captions.json")) and names
    for name in names:
        got, want = (json.loads((d / name).read_text()) for d in (pdir, jdir))
        assert got == want


def test_extract_glove_matches_jax(tmp_path):
    for side in ("j", "p"):
        data = tmp_path / side
        (data / "glove").mkdir(parents=True)
        (data / "msvd_vgg").mkdir()
        (data / "glove" / "glove_a.txt").write_text(
            "man 0.1 0.2\nguitar 0.3 0.4\nzebra 0.5 0.6\nplays 0.7 0.8\n")
        (data / "glove" / "glove_b.txt").write_text("dog 1 2\nman 3 4\n")
        (data / "msvd_vgg" / "train_captions.json").write_text(json.dumps(
            [{"video_key": "v1", "captions": [{"desc": "a Man plays GUITAR."}]},
             {"video_key": "v2", "captions": [{"desc": ["the", "Dog"]}]}]))
    jglove.extract_glove(JConfig(data_dir=str(tmp_path / "j"), corpus="msvd_vgg"))
    _port("extract_glove", tmp_path / "p", "--corpus", "msvd_vgg")
    for name in ("glove_a.txt", "glove_b.txt"):
        got = (tmp_path / "p" / "msvd_vgg" / "glove" / name).read_text()
        assert got == (tmp_path / "j" / "msvd_vgg" / "glove" / name).read_text()
    assert "zebra" not in got and "dog 1 2" in got


def test_msvd_vgg_repackager_matches_jax(tmp_path):
    rows = [",".join([f"vid1_frame_{f}"] + [str(float(f))] * 4096) for f in (10, 2, 1, 30)]
    rows.append(",".join(["vid2_frame_1"] + ["7.5"] * 4096))
    for side in ("j", "p"):
        cdir = tmp_path / side / "msvd_vgg"
        cdir.mkdir(parents=True)
        (cdir / "yt_allframes_vgg_fc7_test.csv").write_text("\n".join(rows) + "\n")
    jvideo.extract_video_feats_msvd_vgg(JConfig(data_dir=str(tmp_path / "j"),
                                                corpus="msvd_vgg", num_frames=3))
    _port("extract_video_feats", tmp_path / "p", "--corpus", "msvd_vgg",
          "--num_frames", "3")
    jfeats, pfeats = (tmp_path / side / "msvd_vgg" / "feats" for side in ("j", "p"))
    assert _tree_files(jfeats) == _tree_files(pfeats) == ["vid1.npy", "vid2.npy"]
    for name in ("vid1.npy", "vid2.npy"):
        np.testing.assert_array_equal(np.load(pfeats / name), np.load(jfeats / name))
    np.testing.assert_array_equal(np.load(pfeats / "vid1.npy")[:, 0], [1.0, 2.0, 10.0])
    (tmp_path / "p" / "msvd_vgg" / "yt_allframes_vgg_fc7_bad.csv").write_text(
        "vid9_frame_1,1.0,2.0\n")
    with pytest.raises(ValueError, match="3 columns"):
        _port("extract_video_feats", tmp_path / "p", "--corpus", "msvd_vgg")


def _write_clip(path, n, w=80, h=60, seed=0):
    """A synthetic clip: n MJPG frames of noise over a ramp."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 5, (w, h))
    for i in range(n):
        frame = np.clip(rng.integers(0, 64, (h, w, 3)) + 20 * i, 0, 255).astype(np.uint8)
        writer.write(frame)
    writer.release()


def _two_corpora(tmp_path, corpus="msvd"):
    """The same clips under a JAX and a port data dir."""
    ext = ".avi"
    for side in ("j", "p"):
        clips = tmp_path / side / corpus / "clips"
        clips.mkdir(parents=True)
        _write_clip(clips / f"vidA{ext}", 9, seed=1)
        _write_clip(clips / f"vidB{ext}", 3, w=48, h=64, seed=2)
    return tmp_path / "j", tmp_path / "p"


def test_frame_preprocessing_matches_jax(tmp_path):
    _write_clip(tmp_path / "c.avi", 5, seed=3)
    raw_t = tframes.decode_frames(str(tmp_path / "c.avi"))
    raw_j = jframes.decode_frames(str(tmp_path / "c.avi"))
    assert len(raw_t) == len(raw_j) == 5
    for a, b in zip(raw_t, raw_j):
        np.testing.assert_array_equal(a, b)
    for n, k in ((9, 4), (3, 4), (30, 30), (31, 30)):
        np.testing.assert_array_equal(tframes.subsample_indices(n, k),
                                      jframes.subsample_indices(n, k))
    tall = np.random.default_rng(4).integers(0, 255, (70, 40, 3)).astype(np.uint8)
    for img in (raw_t[2], tall, tall[:, :, 0]):
        np.testing.assert_array_equal(tframes.preprocess_frame_cnn(img, 32),
                                      jframes.preprocess_frame_cnn(img, 32))
    for img in (raw_t[1], tall):
        x, canvas = tframes.prep_image_yolo(img, 64)
        jx, jcanvas = jframes.prep_image_yolo(img, 64)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(canvas, jcanvas)


def test_extract_video_feats_resnet_route_matches_jax(tmp_path):
    """--mode extract_video_feats on msvd clips with a torchvision resnet18
    state_dict read by torch.load in both: the same files, the same
    (frames, 512) shapes (a clip shorter than num_frames keeps its own
    count), bf16 features within the envelope."""
    jdir, pdir = _two_corpora(tmp_path)
    sd_path = tmp_path / "resnet18.pth"
    torch.save(torchvision_resnet_state_dict("resnet18", torch.Generator().manual_seed(5)),
               sd_path)
    kw = dict(corpus="msvd", num_frames=4, img_size=64, vision_arch="resnet18", seed=0,
              pretrained_base=str(sd_path))
    jvideo.extract_video_feats(JConfig(data_dir=str(jdir), **kw))
    _port("extract_video_feats", pdir, *[x for k, v in kw.items()
                                          for x in (f"--{k}", str(v))])
    jfeats, pfeats = jdir / "msvd" / "feats", pdir / "msvd" / "feats"
    assert _tree_files(jfeats) == _tree_files(pfeats) == ["vidA.npy", "vidB.npy"]
    for name, n in (("vidA.npy", 4), ("vidB.npy", 3)):
        got, want = np.load(pfeats / name), np.load(jfeats / name)
        assert got.shape == want.shape == (n, 512) and got.dtype == np.float32
        assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()


def test_extract_bbox_feats_matches_jax(tmp_path):
    """--mode extract_bbox_feats with a cfg and a yolov3.weights the JAX
    package wrote: the same (frames, 16, 16, 16) float32 cuts at 64x64."""
    jdir, pdir = _two_corpora(tmp_path)
    for d in (jdir, pdir):
        (d / "yolo").mkdir()
        (d / "yolo" / "yolov3.cfg").write_text(RESIDUAL_CFG)
    net = jdn.Darknet(str(jdir / "yolo" / "yolov3.cfg"), key=jax.random.PRNGKey(6))
    net.params = _random_bn(jax.tree_util.tree_map(np.asarray, net.params),
                            np.random.default_rng(6))
    net.save_weights(str(jdir / "yolo" / "yolov3.weights"))
    shutil.copy(jdir / "yolo" / "yolov3.weights", pdir / "yolo" / "yolov3.weights")
    kw = dict(corpus="msvd", num_frames=4, img_size=64)
    jbbox.extract_bbox_feats(JConfig(data_dir=str(jdir), **kw))
    _port("extract_bbox_feats", pdir,
          *[x for k, v in kw.items() for x in (f"--{k}", str(v))])
    jfeats, pfeats = jdir / "msvd" / "bbox_feats", pdir / "msvd" / "bbox_feats"
    assert _tree_files(jfeats) == _tree_files(pfeats) == ["vidA.npy", "vidB.npy"]
    for name, n in (("vidA.npy", 4), ("vidB.npy", 3)):
        got, want = np.load(pfeats / name), np.load(jfeats / name)
        assert got.shape == want.shape == (n, 16, 32, 32) and got.dtype == np.float32
        assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()
    with pytest.raises(ValueError, match="multiple of 32"):
        _port("extract_bbox_feats", pdir, "--corpus", "msvd", "--img_size", "48")
    assert _tree_files(pfeats) == ["vidA.npy", "vidB.npy"]  # nothing was touched


def _spatial_checkpoints(tmp_path):
    """One SpatialNet (JAX's init over a tiny MSVD corpus of 4x4 grid
    features) saved as a JAX checkpoint and as the port's, both embedding
    the same config; the clip train_vid0 with its features."""
    data = tmp_path / "data"
    build_corpus(str(data), corpus="msvd", feat_type="yolo", grid=4)
    conf = dict(mode="train_spatial", data_dir=str(data), corpus="msvd",
                glove_emb_file="glove_tiny.txt", num_frames=4, vid_feat_size=12,
                arch="s2vt", max_len=6, hidden_size=8, img_size=32, seed=123,
                compute_dtype="float32", log_dir="")
    jcfg = JConfig(**conf)
    vocab = JVocab(os.path.join(data, "msvd", "glove", "glove_tiny.txt"), seed=123)
    spec = jbase.spec_from_config(jcfg, vocab).with_(arch="spatial")
    params = jax.tree_util.tree_map(np.asarray, jbase.build_model("spatial")[0](
        jax.random.PRNGKey(7), spec, vocab.vectors))
    jckpt.save_checkpoint(str(tmp_path / "jax_net"), params, {}, {"config": jcfg.to_dict()})
    tparams = bridge.from_jax_params(params, "cpu")
    tckpt.save_checkpoint(str(tmp_path / "port_net"), tparams,
                          optim.build_optimizer("adam", 1e-3, 0.0, 1.0).init(tparams),
                          {"config": jcfg.to_dict()})
    clips = data / "msvd" / "clips"
    clips.mkdir()
    _write_clip(clips / "train_vid0.avi", 6, w=64, h=48, seed=8)
    return data, jcfg


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.astype(np.int32))
    cap.release()
    return frames


def test_eval_attention_matches_jax(tmp_path):
    """--mode eval_attention on one clip and with --export_all: the same
    attention maps, and an mp4 of the same frame count and size whose
    frames match JAX's."""
    data, jcfg = _spatial_checkpoints(tmp_path)
    bbox = data / "msvd" / "bbox_feats"
    feats = jatt._load_feats_padded(str(bbox / "train_vid0.npy"), 4)
    np.testing.assert_array_equal(tatt._load_feats_padded(str(bbox / "train_vid0.npy"), 4),
                                  feats)
    jparams, jspec, _, _ = jatt.load_spatial_net(str(tmp_path / "jax_net"), str(data))
    tparams, tspec, _, _ = tatt.load_spatial_net(str(tmp_path / "port_net"), str(data))
    np.testing.assert_allclose(tatt.compute_seq_alphas(tparams, tspec, feats),
                               jatt.compute_seq_alphas(jparams, jspec, feats),
                               atol=ALPHA_TOL, rtol=0)
    jout = jatt.run_export(jcfg.replace(mode="eval_attention", vid_file="train_vid0.avi",
                                        spatial_net_file=str(tmp_path / "jax_net")))
    jvideo_frames = _read_video(jout[0])
    shutil.rmtree(data / "msvd" / "out_clips")
    pout = _port("eval_attention", data, "--corpus", "msvd", "--vid_file",
                 "train_vid0.avi", "--spatial_net_file", str(tmp_path / "port_net"))
    assert [os.path.basename(p) for p in pout] == ["train_vid0.mp4"]
    pvideo_frames = _read_video(pout[0])
    assert len(pvideo_frames) == len(jvideo_frames) == 4
    for a, b in zip(pvideo_frames, jvideo_frames):
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).mean() <= 1.0
    outs = _port("eval_attention", data, "--corpus", "msvd", "--export_all", "true",
                 "--spatial_net_file", str(tmp_path / "port_net"))
    assert [os.path.basename(p) for p in outs] == ["train_vid0.mp4"]


def test_rationale_overlay_matches_jax(tmp_path, monkeypatch):
    """export_rationale_video under the JAX package's Gumbel noise for
    PRNGKey(seed): the same selection, the same frames darkened."""
    data, jcfg = _spatial_checkpoints(tmp_path)
    feats_dir = tmp_path / "feats"
    feats_dir.mkdir()
    np.save(feats_dir / "train_vid0.npy", np.random.default_rng(9).standard_normal(
        (4, 12)).astype(np.float32))
    jcfg = jcfg.replace(mode="train_rationale", tau=1.0)
    vocab = JVocab(os.path.join(data, "msvd", "glove", "glove_tiny.txt"), seed=123)
    jspec = jbase.spec_from_config(jcfg, vocab).with_(arch="rationale")
    jparams = jax.tree_util.tree_map(np.asarray, jbase.build_model("rationale")[0](
        jax.random.PRNGKey(3), jspec, vocab.vectors))
    from vcr_tpu_torch.config import Config as TConfig
    from vcr_tpu_torch.models import base as tbase
    from vcr_tpu_torch.vocab import Vocab as TVocab

    tcfg = TConfig.from_dict(jcfg.to_dict())
    tspec = tbase.spec_from_config(tcfg, TVocab(os.path.join(
        data, "msvd", "glove", "glove_tiny.txt"), seed=123)).with_(arch="rationale")
    # rationale.apply splits its key (generator, captioner), the generator
    # its own (dropout, Gumbel)
    k_gen, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    _, k_gumbel = jax.random.split(k_gen)
    u = jax.random.uniform(k_gumbel, (1, 4, 2), minval=1e-20, maxval=1.0)
    noise = torch.from_numpy(np.array(-jnp.log(-jnp.log(u) + 1e-20)))
    monkeypatch.setattr(trationale, "sample_gumbel", lambda shape, gen, device: noise)
    clips = str(data / "msvd" / "clips")
    for side in ("j", "p"):
        os.makedirs(tmp_path / side)
    jout = jatt.export_rationale_video(jparams, jspec, jcfg, clips, str(feats_dir),
                                       "train_vid0.avi", str(tmp_path / "j"))
    tout = tatt.export_rationale_video(bridge.from_jax_params(jparams, "cpu"), tspec,
                                       tcfg, clips, str(feats_dir), "train_vid0.avi",
                                       str(tmp_path / "p"))
    assert os.path.basename(tout) == "train_vid0_rationale.mp4"
    a, b = _read_video(tout), _read_video(jout)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_prep_refusals(tmp_path, monkeypatch):
    """An unknown vision architecture raises before the features directory
    is touched; without cv2, decoding, resizing and writing a video raise
    ImportError naming it (nothing falls back)."""
    _, pdir = _two_corpora(tmp_path)
    (pdir / "msvd" / "feats").mkdir()
    (pdir / "msvd" / "feats" / "keep.npy").write_bytes(b"x")
    with pytest.raises(NotImplementedError, match="vision architecture"):
        _port("extract_video_feats", pdir, "--corpus", "msvd", "--vision_arch", "alexnet")
    assert (pdir / "msvd" / "feats" / "keep.npy").exists()
    monkeypatch.setattr(tframes, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tframes.decode_frames(str(pdir / "msvd" / "clips" / "vidA.avi"))
    with pytest.raises(ImportError, match="cv2"):
        tframes.prep_image_yolo(np.zeros((8, 8, 3), np.uint8), 32)
    with pytest.raises(ImportError, match="cv2"):
        tatt.export_video(None, None, None, "", "", "x.avi", str(tmp_path))
