"""Darknet / YOLOv3: the cfg reader, the binary ``.weights`` reader and
writer, the detection forward and the feature cut, NCHW.

The counterpart of ``vcr_tpu/models/darknet.py``:

* ``parse_cfg``: the cfg dialect -> a list of block dicts, the first the
  ``[net]`` block;
* ``build_filter_chain``: each layer's output channels through
  convolutional / route / shortcut / upsample / maxpool / reorg / yolo;
* ``load_weights`` / ``save_weights``: a 5-int32 header, then float32s walked
  in layer order: per conv block with BatchNorm [bias, scale, mean, var,
  then the conv weights in OIHW order], without it [conv bias, weights];
* ``Darknet.forward``: the detections of the first yolo head only, where the
  reference returns; ``forward_all_heads`` all three;
* ``Darknet.get_feats``: the bbox-feature cut, ``outputs[first_yolo - 2]``,
  the 13x13x1024 map at a 416 input.

Each conv's float32 result (``nn.layers.conv2d_f32``) goes through
BatchNorm (eval mode) or its bias and the leaky ReLU in float32, and the
maps stay float32 between layers (a shortcut adds float32 maps); the next
conv rounds its input to the compute dtype. Inference only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vcr_tpu_torch.nn import layers


# ---------------------------------------------------------------- cfg

def parse_cfg(cfgfile: str) -> List[Dict]:
    """cfg file -> list of block dicts (the first is the [net] block)."""
    with open(cfgfile) as f:
        return parse_cfg_text(f.read())


def parse_cfg_text(text: str) -> List[Dict]:
    """cfg text -> list of block dicts: ``[type]`` opens a block, ``key =
    value`` lines fill it, blank lines and ``#`` comments are skipped."""
    blocks: List[Dict] = []
    block: Dict = {}
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if block:
                blocks.append(block)
                block = {}
            block["type"] = line[1:-1].strip()
        else:
            key, value = line.split("=", 1)
            block[key.strip()] = value.strip()
    if block:
        blocks.append(block)
    return blocks


def _conv_meta(block: Dict) -> Tuple[int, int, int, int, bool]:
    filters = int(block["filters"])
    ksize = int(block["size"])
    stride = int(block["stride"])
    pad = (ksize - 1) // 2 if int(block["pad"]) else 0
    has_bn = int(block.get("batch_normalize", 0)) == 1
    return filters, ksize, stride, pad, has_bn


def _route_layers(block: Dict, index: int) -> List[int]:
    """A route's layers relative to layer ``index`` (a positive one is
    absolute in the cfg)."""
    return [int(a) - index if int(a) > 0 else int(a)
            for a in str(block["layers"]).split(",")]


def build_filter_chain(blocks: List[Dict]) -> List[int]:
    """Output channels per layer (blocks[1:])."""
    out: List[int] = []
    prev = 3
    for index, b in enumerate(blocks[1:]):
        t = b["type"]
        if t == "convolutional":
            prev = int(b["filters"])
        elif t == "route":
            prev = sum(out[index + r] for r in _route_layers(b, index)[:2])
        elif t == "reorg":
            prev = prev * int(b.get("stride", 2)) ** 2
        elif t not in ("shortcut", "upsample", "maxpool", "yolo"):
            raise ValueError(f"unknown block type {t!r}")
        out.append(prev)
    return out


# ---------------------------------------------------------------- params

def init_params(gen: torch.Generator, blocks: List[Dict]) -> List[Optional[Dict]]:
    """One entry per layer: a conv layer {'w' (O, I, k, k), 'b'} or {'w',
    'bn': {scale, bias, mean, var}}, He-normal from ``gen`` (a CPU
    generator), BatchNorm at its initial state; any other layer None."""
    chain = build_filter_chain(blocks)
    params: List[Optional[Dict]] = []
    prev = 3
    for index, b in enumerate(blocks[1:]):
        if b["type"] == "convolutional":
            filters, ksize, _, _, has_bn = _conv_meta(b)
            std = (2.0 / (prev * ksize * ksize)) ** 0.5
            p: Dict = {"w": std * torch.randn((filters, prev, ksize, ksize), generator=gen)}
            if has_bn:
                p["bn"] = layers.batchnorm_init(filters)
            else:
                p["b"] = torch.zeros((filters,))
            params.append(p)
        else:
            params.append(None)
        prev = chain[index]
    return params


# ---------------------------------------------------------------- weights IO

def load_weights(params: List[Optional[Dict]], blocks: List[Dict],
                 weightfile: str) -> Tuple[List[Optional[Dict]], np.ndarray]:
    """A binary darknet ``.weights`` file -> (params shaped as ``params``,
    on their device, the 5-int32 header [major, minor, subversion,
    images_seen, _]). Raises where the file holds more or fewer floats than
    the cfg's convs take."""
    with open(weightfile, "rb") as fp:
        header = np.fromfile(fp, dtype=np.int32, count=5)
        weights = np.fromfile(fp, dtype=np.float32)
    ptr = 0

    def take(like: torch.Tensor) -> torch.Tensor:
        nonlocal ptr
        n = like.numel()
        if ptr + n > len(weights):
            raise ValueError(f"weight file {weightfile} ends after {len(weights)} floats; "
                             "the cfg needs more")
        out = torch.from_numpy(weights[ptr:ptr + n].reshape(like.shape).copy())
        ptr += n
        return out.to(like.device)

    new_params = list(params)
    for i, b in enumerate(blocks[1:]):
        if b["type"] != "convolutional":
            continue
        p = dict(params[i])
        if "bn" in p:
            p["bn"] = {k: take(p["bn"][k]) for k in ("bias", "scale", "mean", "var")}
        else:
            p["b"] = take(p["b"])
        p["w"] = take(p["w"])
        new_params[i] = p
    if ptr != len(weights):
        raise ValueError(f"weight file mismatch: the cfg takes {ptr} of "
                         f"{len(weights)} floats")
    return new_params, header


def save_weights(params: List[Optional[Dict]], blocks: List[Dict],
                 savedfile: str, header: Optional[np.ndarray] = None) -> None:
    """Inverse of :func:`load_weights`."""
    if header is None:
        header = np.zeros(5, dtype=np.int32)

    def write(fp, t):
        t.detach().cpu().numpy().astype(np.float32).tofile(fp)

    with open(savedfile, "wb") as fp:
        np.asarray(header, dtype=np.int32).tofile(fp)
        for i, b in enumerate(blocks[1:]):
            if b["type"] != "convolutional":
                continue
            p = params[i]
            if "bn" in p:
                for k in ("bias", "scale", "mean", "var"):
                    write(fp, p["bn"][k])
            else:
                write(fp, p["b"])
            write(fp, p["w"])


# ---------------------------------------------------------------- forward

def _conv_block(p: Dict, block: Dict, x: torch.Tensor, cdtype) -> torch.Tensor:
    _, _, stride, pad, has_bn = _conv_meta(block)
    y = layers.conv2d_f32(x, p["w"], stride, pad, cdtype)
    if has_bn:
        y = layers.batchnorm(p["bn"], y, train=False)[0]
    else:
        y = y + p["b"][None, :, None, None]
    if block["activation"] == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    return y


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Space-to-depth: (B, C, H, W) -> (B, C*s*s, H/s, W/s), the s*s
    spatial phases the leading channel factor (the reference's ReOrg)."""
    b, c, h, w = x.shape
    s = stride
    if h % s or w % s:
        raise ValueError(f"reorg: {h}x{w} does not divide by stride {s}")
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 1, 2, 4, 3, 5)
    x = x.reshape(b, c, (h // s) * (w // s), s * s).permute(0, 1, 3, 2)
    x = x.reshape(b, c, s * s, h // s, w // s).permute(0, 2, 1, 3, 4)
    return x.reshape(b, c * s * s, h // s, w // s)


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if stride != 1:
        return F.max_pool2d(x, size, stride)
    return layers.max_pool2d_edge(x, size)


def predict_transform(prediction: torch.Tensor, inp_dim: int,
                      anchors: List[Tuple[int, int]], num_classes: int) -> torch.Tensor:
    """Decode one yolo head: (B, A*(5+C), G, G) -> (B, G*G*A, 5+C), sigmoid
    xy, objectness and classes, grid offsets, exp(wh) times the anchors,
    boxes scaled back by the stride."""
    b, grid = prediction.shape[0], prediction.shape[2]
    stride = inp_dim // grid
    na, attrs = len(anchors), 5 + num_classes
    dev = prediction.device
    scaled = torch.tensor([(a[0] / stride, a[1] / stride) for a in anchors],
                          dtype=torch.float32, device=dev)
    pred = prediction.reshape(b, na * attrs, grid * grid).transpose(1, 2)
    pred = pred.reshape(b, grid * grid * na, attrs)
    gx, gy = np.meshgrid(np.arange(grid), np.arange(grid))
    offsets = np.repeat(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1), na, axis=0)
    xy = torch.sigmoid(pred[:, :, 0:2]) + torch.from_numpy(
        offsets.astype(np.float32)).to(dev)[None]
    wh = torch.exp(pred[:, :, 2:4]) * scaled.repeat(grid * grid, 1)[None]
    boxes = torch.cat([xy, wh], dim=2) * stride
    return torch.cat([boxes, torch.sigmoid(pred[:, :, 4:5]),
                      torch.sigmoid(pred[:, :, 5:])], dim=2)


class Darknet:
    """A cfg-driven YOLOv3 graph: the blocks, their weights (``params``, one
    entry per layer) and the ``.weights`` header. Its cfg structure is
    static: it shapes the trace, and the weights are an argument of it."""

    def __init__(self, cfgfile: str, gen: Optional[torch.Generator] = None):
        blocks = parse_cfg(cfgfile)
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self._set(blocks, init_params(gen, blocks), np.zeros(5, dtype=np.int32))

    @classmethod
    def from_blocks(cls, blocks: List[Dict], params: List[Optional[Dict]],
                    header: np.ndarray) -> "Darknet":
        """A Darknet of parsed blocks and their weights."""
        net = cls.__new__(cls)
        net._set(blocks, params, header)
        return net

    def _set(self, blocks, params, header) -> None:
        self.blocks = blocks
        self.net_info = blocks[0]
        self.filter_chain = build_filter_chain(blocks)
        self.params = params
        self.header = header

    def load_weights(self, weightfile: str) -> None:
        self.params, self.header = load_weights(self.params, self.blocks, weightfile)

    def save_weights(self, savedfile: str) -> None:
        save_weights(self.params, self.blocks, savedfile, self.header)

    def _trace(self, params, x, cdtype, stop_at_first_yolo: bool):
        """-> (detections, outputs by layer, index of the first yolo layer)."""
        outputs: Dict[int, torch.Tensor] = {}
        detections = []
        first_yolo = None
        for i, b in enumerate(self.blocks[1:]):
            t = b["type"]
            if t == "convolutional":
                x = _conv_block(params[i], b, x, cdtype)
            elif t == "upsample":
                x = _upsample2(x)
            elif t == "maxpool":
                x = _maxpool(x, int(b["size"]), int(b["stride"]))
            elif t == "route":
                x = torch.cat([outputs[i + r] for r in _route_layers(b, i)[:2]], dim=1)
            elif t == "reorg":
                x = reorg(x, int(b.get("stride", 2)))
            elif t == "shortcut":
                x = outputs[i - 1] + outputs[i + int(b["from"])]
            elif t == "yolo":
                if first_yolo is None:
                    first_yolo = i
                mask = [int(m) for m in b["mask"].split(",")]
                aflat = [int(a) for a in b["anchors"].split(",")]
                anchors = [(aflat[2 * j], aflat[2 * j + 1]) for j in mask]
                detections.append(predict_transform(x, int(self.net_info["height"]),
                                                    anchors, int(b["classes"])))
                x = outputs[i - 1]  # the reference hands on the head's input
                if stop_at_first_yolo:
                    outputs[i] = x
                    break
            outputs[i] = x
        return detections, outputs, first_yolo

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        """The first yolo head's detections (the reference returns there)."""
        return self._trace(self.params, x, compute_dtype, True)[0][0]

    def forward_all_heads(self, x: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
        """All heads' detections, (B, sum over heads of G*G*3, 5+C)."""
        return torch.cat(self._trace(self.params, x, compute_dtype, False)[0], dim=1)

    def get_feats(self, x: torch.Tensor, compute_dtype=torch.bfloat16,
                  params=None) -> torch.Tensor:
        """The bbox-feature cut: ``outputs[first_yolo - 2]``, the map two
        layers before the first detection head. ``params`` (default: this
        net's) are the weights the trace runs with."""
        _, outputs, first_yolo = self._trace(self.params if params is None else params,
                                             x, compute_dtype, True)
        if first_yolo is None:
            raise ValueError("the cfg has no yolo block: the feature cut is undefined")
        return outputs[first_yolo - 2]


# ---------------------------------------------------------------- YOLOv3's plan

YOLO_ANCHORS = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326"


def yolov3_first_head_cfg(size: int = 416, classes: int = 80) -> str:
    """The cfg text of YOLOv3 up to its first detection head, from the
    published layer plan (Redmon & Farhadi 2018, "YOLOv3: An Incremental
    Improvement", Table 1 and the yolov3.cfg it ships): Darknet-53 (a 3x3
    conv of 32 filters, then five stages of a stride-2 3x3 conv doubling the
    filters to 64/128/256/512/1024 and 1/2/8/8/4 residual blocks of a 1x1
    conv halving them and a 3x3 conv restoring them, each closed by a
    shortcut), then the first head: 1x1-512 / 3x3-1024 three times, a 1x1
    linear conv of 3*(5+classes) filters and the first ``[yolo]`` (mask
    6,7,8: the three largest anchors). Every conv but the last has
    BatchNorm and a leaky ReLU. At ``size`` 416 the feature cut is the
    13x13x1024 output of the last 3x3-1024 conv."""
    def conv(filters, size_, stride=1, bn=True, act="leaky"):
        lines = ["[convolutional]"] + (["batch_normalize=1"] if bn else [])
        return lines + [f"filters={filters}", f"size={size_}", f"stride={stride}",
                        "pad=1", f"activation={act}", ""]

    text = ["[net]", "batch=1", "subdivisions=1", f"width={size}", f"height={size}",
            "channels=3", ""]
    text += conv(32, 3)
    filters = 32
    for n_blocks in (1, 2, 8, 8, 4):
        filters *= 2
        text += conv(filters, 3, stride=2)
        for _ in range(n_blocks):
            text += conv(filters // 2, 1) + conv(filters, 3)
            text += ["[shortcut]", "from=-3", "activation=linear", ""]
    for _ in range(3):
        text += conv(512, 1) + conv(1024, 3)
    text += conv(3 * (5 + classes), 1, bn=False, act="linear")
    text += ["[yolo]", "mask=6,7,8", f"anchors={YOLO_ANCHORS}", f"classes={classes}",
             "num=9", "jitter=.3", "ignore_thresh=.7", "truth_thresh=1", "random=1", ""]
    return "\n".join(text)
