"""Offline CNN features: clips -> ``feats/<vid>.npy``, the counterpart of
``vcr_tpu/data/prep/video_feats.py``:

* the ResNet route (msvd, msrvtt): cv2 decode, linspace subsample, resize,
  crop and normalize, then one batched ResNet-18/34 call per clip in bf16
  on the device, the clip padded to ``num_frames`` frames and only its real
  frames saved;
* the MSVD-VGG repackager: the downloaded ``yt_allframes_vgg_fc7_*`` CSVs
  (4096-d fc7 rows keyed ``vidN_frame_M``, 4097 columns) sorted by frame,
  subsampled and saved per video.
"""

from __future__ import annotations

import csv
import glob
import os
import re
import shutil

import numpy as np
import torch

from vcr_tpu_torch.data.prep import frames as F

CLIP_EXT = {"msvd": ".avi", "msrvtt": ".mp4"}


def clip_ext(corpus: str) -> str:
    """The clips' file extension of a corpus that has clips."""
    if corpus not in CLIP_EXT:
        raise NotImplementedError(f"unknown corpus {corpus!r}: clips are read for "
                                  f"{sorted(CLIP_EXT)}")
    return CLIP_EXT[corpus]


def fresh_dir(path: str) -> str:
    """``path`` emptied (made where missing)."""
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def pad_frames(batch: np.ndarray, num_frames: int) -> np.ndarray:
    """A clip's (n, ...) frames zero-padded to ``num_frames`` rows, so every
    clip's backbone call has one shape."""
    n = batch.shape[0]
    if n >= num_frames:
        return batch
    return np.concatenate([batch, np.zeros((num_frames - n, *batch.shape[1:]),
                                           batch.dtype)])


def extract_video_feats(cfg, resnet_params=None, device=None) -> None:
    """ResNet features of every msvd/msrvtt clip on ``device`` (the card
    unless given). ``resnet_params``: a ``models.resnet`` tree; else a
    torchvision state_dict at ``cfg.pretrained_base`` (read by
    ``torch.load``), else random weights from ``cfg.seed``, with a
    warning."""
    from vcr_tpu_torch.device import params_to, resolve_device
    from vcr_tpu_torch.models import resnet

    if cfg.vision_arch not in ("resnet18", "resnet34"):
        raise NotImplementedError(f"unknown vision architecture {cfg.vision_arch!r}")
    ext = clip_ext(cfg.corpus)
    device = resolve_device(device)
    corpus_dir = os.path.join(cfg.data_dir, cfg.corpus)
    clips_dir = os.path.join(corpus_dir, "clips/")
    clips = [f for f in os.listdir(clips_dir) if f.endswith(ext)]
    feats_dir = fresh_dir(os.path.join(corpus_dir, "feats/"))

    if resnet_params is None:
        sd_path = cfg.pretrained_base
        if sd_path and os.path.exists(sd_path):
            sd = torch.load(sd_path, map_location="cpu")
            resnet_params = resnet.load_torch_state_dict(sd, cfg.vision_arch)
        else:
            print("WARNING: no pretrained ResNet weights supplied — "
                  "extracting with random init")
            resnet_params = resnet.init_params(torch.Generator().manual_seed(cfg.seed),
                                               cfg.vision_arch)
    params = params_to(resnet_params, device)

    for video in clips:
        raw = F.decode_frames(os.path.join(clips_dir, video))
        idxs = F.subsample_indices(len(raw), cfg.num_frames)
        batch = np.stack([F.preprocess_frame_cnn(raw[i], cfg.img_size) for i in idxs])
        with torch.inference_mode():
            feats = resnet.extract_features(
                params, torch.from_numpy(pad_frames(batch, cfg.num_frames)).to(device),
                torch.bfloat16)
        np.save(os.path.join(feats_dir, os.path.splitext(video)[0] + ".npy"),
                feats[:len(idxs)].cpu().numpy())


_VID_RE = re.compile(r"(vid\d+)_frame_(\d+)")


def extract_video_feats_msvd_vgg(cfg) -> None:
    """Repackage the downloaded VGG fc7 CSVs into per-video .npy files.
    A row of another width than 4097 columns raises ValueError."""
    corpus_dir = os.path.join(cfg.data_dir, cfg.corpus)
    files = glob.glob(os.path.join(corpus_dir, "yt_allframes_vgg_fc7_*"))
    feats_dir = fresh_dir(os.path.join(corpus_dir, "feats/"))

    for path in files:
        per_video = {}
        with open(path) as fp:
            for row in csv.reader(fp, delimiter=","):
                if len(row) != 4097:
                    raise ValueError(f"{path}: a row of {len(row)} columns; the fc7 "
                                     "CSVs hold a key and 4096 values")
                m = _VID_RE.match(row[0])
                vid, frame_num = m.group(1), int(m.group(2))
                feat = np.asarray([float(x) for x in row[1:]], dtype=np.float32)
                per_video.setdefault(vid, []).append((frame_num, feat))

        for vid, rows in per_video.items():
            rows.sort(key=lambda t: t[0])
            arr = np.stack([f[1] for f in rows])
            idxs = F.subsample_indices(len(arr), cfg.num_frames)
            np.save(os.path.join(feats_dir, vid + ".npy"), arr[idxs])
