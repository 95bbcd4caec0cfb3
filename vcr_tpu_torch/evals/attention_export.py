"""Attention and rationale overlay videos, the counterpart of
``vcr_tpu/evals/attention_export.py``.

``run_export`` rebuilds a trained SpatialNet from its checkpoint (the
embedded config gives every hyperparameter), runs it on a clip's
precomputed bbox features, nearest-upsamples each frame's K x K attention
map to ``img_size``, min-max normalizes it into [0.5, 1], darkens the
letterboxed frame by it and writes an mp4 at 2 fps.
``export_rationale_video`` darkens the frames RationaleNet's generator did
not select. Writing a video needs cv2: without it they raise ImportError.
"""

from __future__ import annotations

import os
import shutil
from typing import List

import numpy as np
import torch

from vcr_tpu_torch.config import Config
from vcr_tpu_torch.data.prep import frames as F
from vcr_tpu_torch.data.prep.video_feats import clip_ext
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, spatial
from vcr_tpu_torch.train import checkpoint as ckpt
from vcr_tpu_torch.vocab import Vocab

MP4V = 0x7634706D  # fourcc "mp4v"


def _load_feats_padded(path: str, num_frames: int) -> np.ndarray:
    """(1, num_frames, ...) float32: the input pipeline's zero-pad or
    truncate rule, so the maps match what the model saw."""
    feats = np.load(path)[None]
    if feats.shape[1] < num_frames:
        pad = np.zeros((1, num_frames - feats.shape[1], *feats.shape[2:]), feats.dtype)
        feats = np.concatenate([feats, pad], axis=1)
    return feats[:, :num_frames].astype(np.float32)


def load_spatial_net(spatial_net_file: str, data_dir: str, device="cpu"):
    """A SpatialNet checkpoint of this package -> (params on ``device``,
    spec, its config, vocab); the vocab is read under ``data_dir``."""
    params, _, meta = ckpt.load_checkpoint(spatial_net_file, device)
    cfg = Config.from_dict(meta["config"])
    vocab = Vocab(os.path.join(data_dir, cfg.corpus, "glove", cfg.glove_emb_file),
                  seed=cfg.seed)
    spec = model_base.spec_from_config(cfg, vocab).with_(arch="spatial")
    return params, spec, cfg, vocab


def compute_seq_alphas(params, spec, vid_feats: np.ndarray, device="cpu") -> np.ndarray:
    """(1, N, F, K, K) features -> (N, K, K) attention maps (eval mode)."""
    with torch.inference_mode():
        _, seq_alphas, _ = spatial.apply(params, spec,
                                         torch.as_tensor(vid_feats, device=device))
    return seq_alphas.float().cpu().numpy()[0]


def _writer(path: str, size: int):
    return F.require_cv2("writing a video").VideoWriter(path, MP4V, 2, (size, size))


def _clip_frames(clips_dir: str, vid_file: str, num_frames: int) -> list:
    raw = F.decode_frames(os.path.join(clips_dir, vid_file))
    return [raw[i] for i in F.subsample_indices(len(raw), num_frames)]


def export_video(params, spec, cfg, clips_dir: str, bbox_feats_dir: str,
                 vid_file: str, out_dir: str, device="cpu") -> str:
    """One clip -> its attention-overlay mp4; returns the path."""
    F.require_cv2("writing a video")
    frame_list = _clip_frames(clips_dir, vid_file, cfg.num_frames)
    base = os.path.splitext(os.path.basename(vid_file))[0]
    vid_feats = _load_feats_padded(os.path.join(bbox_feats_dir, base + ".npy"),
                                   cfg.num_frames)
    seq_alphas = compute_seq_alphas(params, spec, vid_feats, device)
    n = cfg.img_size // seq_alphas.shape[1]
    seq_alphas = seq_alphas.repeat(n, axis=1).repeat(n, axis=2)

    out_path = os.path.join(out_dir, base + ".mp4")
    writer = _writer(out_path, cfg.img_size)
    for i, frame in enumerate(frame_list):
        _, canvas = F.prep_image_yolo(frame, cfg.img_size)
        att = seq_alphas[i]
        att = (att - att.min()) / max(att.max() - att.min(), 1e-12)
        att = att / 2.0 + 0.5  # into [0.5, 1]
        writer.write(np.uint8(canvas * att[:, :, None]))
    writer.release()
    return out_path


def export_rationale_video(params, spec, cfg, clips_dir: str, feats_dir: str,
                           vid_file: str, out_dir: str, device="cpu") -> str:
    """The temporal rationale of one clip: the frames RationaleNet's
    generator did not select (hard selection, eval mode, its noise seeded
    with ``cfg.seed``) darkened to a quarter; returns the mp4's path."""
    F.require_cv2("writing a video")
    frame_list = _clip_frames(clips_dir, vid_file, cfg.num_frames)
    base = os.path.splitext(os.path.basename(vid_file))[0]
    vid_feats = _load_feats_padded(os.path.join(feats_dir, base + ".npy"),
                                   cfg.num_frames)
    with torch.inference_mode():
        _, probs = rationale.apply(params, spec, torch.as_tensor(vid_feats, device=device),
                                   rng=cfg.seed)
    selected = probs.float().cpu().numpy()[0, :, 1]  # hard 0/1 at eval

    out_path = os.path.join(out_dir, base + "_rationale.mp4")
    writer = _writer(out_path, cfg.img_size)
    for i, frame in enumerate(frame_list):
        _, canvas = F.prep_image_yolo(frame, cfg.img_size)
        weight = 1.0 if (i < len(selected) and selected[i] > 0.5) else 0.25
        writer.write(np.uint8(canvas * weight))
    writer.release()
    return out_path


def run_export(cfg: Config, device=None) -> List[str]:
    """``--mode eval_attention``: the overlay of ``cfg.vid_file``, or with
    ``--export_all`` of every clip of the corpus, into
    ``<data_dir>/<corpus>/out_clips/``; SpatialNet runs on ``device`` (the
    card unless given)."""
    from vcr_tpu_torch.device import resolve_device

    device = resolve_device(device)
    params, spec, saved_cfg, _ = load_spatial_net(cfg.spatial_net_file, cfg.data_dir,
                                                  device)
    corpus_dir = os.path.join(cfg.data_dir, cfg.corpus)
    clips_dir = os.path.join(corpus_dir, "clips/")
    bbox_dir = os.path.join(corpus_dir, "bbox_feats/")
    videos = ([cfg.vid_file] if not cfg.export_all else
              sorted(f for f in os.listdir(clips_dir) if f.endswith(clip_ext(cfg.corpus))))
    out_dir = os.path.join(corpus_dir, "out_clips/")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    return [export_video(params, spec, saved_cfg, clips_dir, bbox_dir, video, out_dir,
                         device) for video in videos]
