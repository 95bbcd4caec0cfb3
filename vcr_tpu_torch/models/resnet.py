"""ResNet-18/34 to the pooled 512-d features, NCHW.

The counterpart of ``vcr_tpu/models/resnet.py``: torchvision's resnet18/34
with its ``fc`` removed, whose global-average-pooled 512-d output the MSVD
and MSR-VTT captioners read. BatchNorm runs in eval mode from the stored
statistics (``nn.layers.batchnorm``). torchvision is not needed:
``load_torch_state_dict`` takes its key names. Inference only.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from vcr_tpu_torch.nn import layers

# basic blocks per stage
_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
_STAGE_CH = (64, 128, 256, 512)
FEATURE_SIZE = 512


def _conv_init(gen, out_ch, in_ch, k):
    std = (2.0 / (in_ch * k * k)) ** 0.5  # He-normal, torchvision's kaiming init
    return std * torch.randn((out_ch, in_ch, k, k), generator=gen)


def _bn_init(ch):
    return layers.batchnorm_init(ch)


def _stride(stage: int, block: int) -> int:
    return 2 if (stage > 0 and block == 0) else 1


def init_params(gen: torch.Generator, arch: str = "resnet34") -> Dict:
    """Random weights from ``gen`` (a CPU generator): He-normal convs and
    BatchNorm at its initial state (scale 1, bias 0, mean 0, var 1)."""
    blocks = _BLOCKS[arch]
    params: Dict = {"conv1": _conv_init(gen, 64, 3, 7), "bn1": _bn_init(64),
                    "layers": []}
    in_ch = 64
    for stage, (n_blocks, ch) in enumerate(zip(blocks, _STAGE_CH)):
        stage_params: List[Dict] = []
        for b in range(n_blocks):
            blk = {"conv1": _conv_init(gen, ch, in_ch, 3), "bn1": _bn_init(ch),
                   "conv2": _conv_init(gen, ch, ch, 3), "bn2": _bn_init(ch)}
            if _stride(stage, b) != 1 or in_ch != ch:
                blk["downsample"] = {"conv": _conv_init(gen, ch, in_ch, 1),
                                     "bn": _bn_init(ch)}
            stage_params.append(blk)
            in_ch = ch
        params["layers"].append(stage_params)
    return params


def _bn(p, x):
    return layers.batchnorm(p, x, train=False)[0]


def _basic_block(p, x, stride, cdtype=torch.float32):
    """One basic block. ``x`` arrives in ``cdtype``; each conv's float32
    result goes through BatchNorm in float32 and is rounded to ``cdtype``
    before the next conv, as in the JAX package. Padding is torch's,
    symmetric (XLA's "SAME" would pad a stride-2 conv on one side only)."""
    out = torch.relu(_bn(p["bn1"], layers.conv2d_f32(x, p["conv1"], stride, 1, cdtype)))
    out = _bn(p["bn2"], layers.conv2d_f32(out.to(cdtype), p["conv2"], 1, 1, cdtype))
    if "downsample" in p:
        x = _bn(p["downsample"]["bn"],
                layers.conv2d_f32(x, p["downsample"]["conv"], stride, 0, cdtype))
    return torch.relu(out + x).to(cdtype)


def extract_features(params: Dict, images: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (B, 3, H, W) ImageNet-normalized -> (B, 512) float32 pooled
    features (the model with its fc removed). The pool is the mean of the
    last block's output in the compute dtype, summed in float32 and rounded
    to the compute dtype, as ``jnp.mean`` computes it."""
    x = images.to(compute_dtype)
    x = torch.relu(_bn(params["bn1"], layers.conv2d_f32(x, params["conv1"], 2, 3,
                                                         compute_dtype)))
    x = F.max_pool2d(x, 3, 2, 1).to(compute_dtype)  # -inf padding, as JAX's
    for stage, stage_params in enumerate(params["layers"]):
        for b, blk in enumerate(stage_params):
            x = _basic_block(blk, x, _stride(stage, b), compute_dtype)
    return x.float().mean(dim=(2, 3)).to(compute_dtype).float()


def _array(v) -> torch.Tensor:
    """A state_dict value (a tensor or an array) as a float32 CPU tensor."""
    return torch.tensor(np.asarray(v, dtype=np.float32))


def load_torch_state_dict(state_dict: Dict, arch: str = "resnet34") -> Dict:
    """A torchvision resnet18/34 state_dict (tensors or arrays) -> the
    parameter tree; a block has ``downsample`` where the state_dict has
    ``downsample.0.weight``."""
    def g(name):
        return _array(state_dict[name])

    def bn(prefix):
        return {"scale": g(prefix + ".weight"), "bias": g(prefix + ".bias"),
                "mean": g(prefix + ".running_mean"), "var": g(prefix + ".running_var")}

    params: Dict = {"conv1": g("conv1.weight"), "bn1": bn("bn1"), "layers": []}
    for stage, n_blocks in enumerate(_BLOCKS[arch]):
        stage_params = []
        for b in range(n_blocks):
            pre = f"layer{stage + 1}.{b}"
            blk = {"conv1": g(pre + ".conv1.weight"), "bn1": bn(pre + ".bn1"),
                   "conv2": g(pre + ".conv2.weight"), "bn2": bn(pre + ".bn2")}
            if pre + ".downsample.0.weight" in state_dict:
                blk["downsample"] = {"conv": g(pre + ".downsample.0.weight"),
                                     "bn": bn(pre + ".downsample.1")}
            stage_params.append(blk)
        params["layers"].append(stage_params)
    return params
