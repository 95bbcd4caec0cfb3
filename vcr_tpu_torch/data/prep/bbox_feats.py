"""Offline YOLO grid features: clips -> ``bbox_feats/<vid>.npy``, the
counterpart of ``vcr_tpu/data/prep/bbox_feats.py``: cv2 decode, linspace
subsample, letterbox to ``img_size`` (a multiple of 32 above 32), then one
batched Darknet call per clip in bf16 on the device (the 13x13x1024 cut at
416), the clip padded to ``num_frames`` frames and only its real frames
saved, (n, F, K, K) float32 per clip."""

from __future__ import annotations

import os

import numpy as np
import torch

from vcr_tpu_torch.data.prep import frames as F
from vcr_tpu_torch.data.prep.video_feats import clip_ext, fresh_dir, pad_frames


def extract_bbox_feats(cfg, device=None) -> None:
    """Darknet features of every msvd/msrvtt clip on ``device`` (the card
    unless given), from ``<data_dir>/yolo/yolov3.cfg`` and, where it exists,
    ``yolov3.weights``; else random weights (seed 0), with a warning."""
    from vcr_tpu_torch.device import params_to, resolve_device
    from vcr_tpu_torch.models.darknet import Darknet

    if cfg.img_size % 32 != 0 or cfg.img_size <= 32:
        raise ValueError(f"--img_size {cfg.img_size}: YOLOv3 takes a multiple of 32 "
                         "above 32")
    ext = clip_ext(cfg.corpus)
    device = resolve_device(device)
    corpus_dir = os.path.join(cfg.data_dir, cfg.corpus)
    clips_dir = os.path.join(corpus_dir, "clips/")
    clips = [f for f in os.listdir(clips_dir) if f.endswith(ext)]
    feats_dir = fresh_dir(os.path.join(corpus_dir, "bbox_feats/"))

    print("Loading network.....")
    net = Darknet(os.path.join(cfg.data_dir, "yolo/", "yolov3.cfg"))
    weights = os.path.join(cfg.data_dir, "yolo/", "yolov3.weights")
    if os.path.exists(weights):
        net.load_weights(weights)
    else:
        print("WARNING: yolov3.weights not found — extracting with random init")
    net.net_info["height"] = cfg.img_size
    print("Network successfully loaded")
    params = params_to(net.params, device)

    for video in clips:
        raw = F.decode_frames(os.path.join(clips_dir, video))
        idxs = F.subsample_indices(len(raw), cfg.num_frames)
        batch = np.stack([F.prep_image_yolo(raw[i], cfg.img_size)[0] for i in idxs])
        with torch.inference_mode():
            feats = net.get_feats(
                torch.from_numpy(pad_frames(batch, cfg.num_frames)).to(device),
                torch.bfloat16, params=params)
        np.save(os.path.join(feats_dir, os.path.splitext(video)[0] + ".npy"),
                feats[:len(idxs)].cpu().numpy())
