"""Frame decoding and preprocessing on the host (cv2), the counterpart of
``vcr_tpu/data/prep/frames.py``:

* the CNN route: shorter-side resize and centre crop to ``img_size``,
  ImageNet normalization;
* the YOLO route: letterbox to ``img_size`` on 128-grey padding, BGR to
  RGB, divided by 255;
* linspace frame subsampling to ``num_frames``, endpoint excluded.

cv2 is imported where it is installed. Without it, decoding a clip or
resizing a frame raises ``ImportError`` naming cv2; nothing falls back.
"""

from __future__ import annotations

from typing import List

import numpy as np

try:
    import cv2
except ImportError:  # the module still imports; each cv2 call raises
    cv2 = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def require_cv2(what: str):
    """cv2, or ImportError naming it and ``what`` needed it."""
    if cv2 is None:
        raise ImportError(f"{what} needs cv2 (opencv-python), which is not installed")
    return cv2


def decode_frames(video_file: str) -> List[np.ndarray]:
    """All frames of a clip as BGR uint8 arrays."""
    cap = require_cv2("decoding a video").VideoCapture(video_file)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    return frames


def subsample_indices(n_frames: int, num_frames: int) -> np.ndarray:
    """linspace subsample (endpoint excluded); every frame if there are
    no more than ``num_frames``."""
    if n_frames > num_frames:
        return np.linspace(0, n_frames, num=num_frames, endpoint=False).astype(int)
    return np.arange(n_frames)


def preprocess_frame_cnn(frame_bgr: np.ndarray, img_size: int) -> np.ndarray:
    """BGR uint8 -> (3, S, S) float32, ImageNet-normalized: shorter-side
    resize, centre crop, RGB, /255, normalize."""
    cv = require_cv2("resizing a frame")
    img = frame_bgr
    if img.ndim == 2:
        img = np.tile(img[:, :, None], 3)
    h, w = img.shape[:2]
    if h < w:
        new_w = int(w * img_size / h)
        img = cv.resize(img, (new_w, img_size))
        off = (new_w - img_size) // 2
        img = img[:, off:off + img_size]
    else:
        new_h = int(h * img_size / w)
        img = cv.resize(img, (img_size, new_h))
        off = (new_h - img_size) // 2
        img = img[off:off + img_size, :]
    img = cv.resize(img, (img_size, img_size))
    rgb = cv.cvtColor(img.astype(np.uint8), cv.COLOR_BGR2RGB)
    x = rgb.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(x, (2, 0, 1))


def letterbox_image(img: np.ndarray, inp_dim) -> np.ndarray:
    """Resize keeping the aspect ratio (bicubic), centred on a 128-grey
    canvas of ``inp_dim`` (w, h)."""
    cv = require_cv2("letterboxing a frame")
    img_h, img_w = img.shape[0], img.shape[1]
    w, h = inp_dim
    scale = min(w / img_w, h / img_h)
    new_w, new_h = int(img_w * scale), int(img_h * scale)
    resized = cv.resize(img, (new_w, new_h), interpolation=cv.INTER_CUBIC)
    canvas = np.full((h, w, 3), 128)
    canvas[(h - new_h) // 2:(h - new_h) // 2 + new_h,
           (w - new_w) // 2:(w - new_w) // 2 + new_w, :] = resized
    return canvas


def prep_image_yolo(frame_bgr: np.ndarray, img_size: int):
    """BGR uint8 -> ((3, S, S) float32 RGB in [0, 1], the letterboxed BGR
    canvas)."""
    canvas = letterbox_image(frame_bgr, (img_size, img_size))
    x = canvas[:, :, ::-1].transpose(2, 0, 1).astype(np.float32) / 255.0
    return x, canvas
