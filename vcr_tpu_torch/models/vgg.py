"""VGG16 to fc7: the MSVD-VGG featurizer, NCHW.

The counterpart of ``vcr_tpu/models/vgg.py``: torchvision's VGG16 'D' plan
(13 3x3 convs with ReLU, 5 2x2 max pools), then fc6 -> ReLU -> fc7, which
gives the 4096-d fc7 activations the flagship captioner reads. torchvision
is not needed: the convs are ``nn.layers.conv2d_f32`` and the products
``nn.layers.vdot``, and ``load_torch_state_dict`` takes torchvision's key
names. Inference only.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from vcr_tpu_torch.nn import layers

# torchvision vgg16 'D' configuration: conv channel plan, 'M' = 2x2 max pool
_CFG: List = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
FC7_SIZE = 4096


def init_params(gen: torch.Generator) -> Dict:
    """Random weights from ``gen`` (a CPU generator): He-normal convs, zero
    biases, fc6 and fc7 normal with std 0.01, stored (in, out)."""
    params: Dict = {"convs": []}
    in_ch = 3
    for v in _CFG:
        if v == "M":
            continue
        std = (2.0 / (in_ch * 9)) ** 0.5
        params["convs"].append({"w": std * torch.randn((v, in_ch, 3, 3), generator=gen),
                                "b": torch.zeros((v,))})
        in_ch = v
    params["fc6"] = {"w": 0.01 * torch.randn((512 * 7 * 7, FC7_SIZE), generator=gen),
                     "b": torch.zeros((FC7_SIZE,))}
    params["fc7"] = {"w": 0.01 * torch.randn((FC7_SIZE, FC7_SIZE), generator=gen),
                     "b": torch.zeros((FC7_SIZE,))}
    return params


def extract_fc7(params: Dict, images: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (B, 3, 224, 224) ImageNet-normalized -> (B, 4096) float32 fc7
    (ReLU after fc6, none after fc7: the downloaded MSVD-VGG features'
    convention). Each conv's float32 result takes its bias and ReLU, then is
    rounded to the compute dtype, as in the JAX package."""
    x = images.to(compute_dtype)
    ci = 0
    for v in _CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        p = params["convs"][ci]
        ci += 1
        y = layers.conv2d_f32(x, p["w"], 1, 1, compute_dtype)
        x = torch.relu(y + p["b"][None, :, None, None]).to(compute_dtype)
    x = x.reshape(x.shape[0], -1)  # (B, 512*7*7), NCHW order
    x = torch.relu(layers.dense(params["fc6"], x, compute_dtype))
    return layers.dense(params["fc7"], x, compute_dtype)


def _array(v) -> torch.Tensor:
    """A state_dict value (a tensor or an array) as a float32 CPU tensor."""
    return torch.tensor(np.asarray(v, dtype=np.float32))


def load_torch_state_dict(sd: Dict) -> Dict:
    """A torchvision vgg16 state_dict (tensors or arrays) -> the parameter
    tree: ``features.{i}`` are the convs in ``_CFG`` order, ``classifier.0``
    is fc6 and ``classifier.3`` fc7 (transposed to (in, out))."""
    params: Dict = {"convs": []}
    layer_idx = 0
    for v in _CFG:
        if v == "M":
            layer_idx += 1
            continue
        params["convs"].append({"w": _array(sd[f"features.{layer_idx}.weight"]),
                                "b": _array(sd[f"features.{layer_idx}.bias"])})
        layer_idx += 2  # conv + relu
    for name, key in (("fc6", "classifier.0"), ("fc7", "classifier.3")):
        params[name] = {"w": _array(sd[key + ".weight"]).t().contiguous(),
                        "b": _array(sd[key + ".bias"])}
    return params
