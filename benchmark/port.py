"""Where the harness meets the program under test, ``vcr_tpu_torch``: its model
spec built from a configuration file, and the reference project's weights
read through the program's public loader (``vcr_tpu_torch.convert``)."""

from __future__ import annotations

from typing import Dict

import torch


def model_spec(m: dict):
    """The program's ``ModelSpec`` of configuration ``m``."""
    from vcr_tpu_torch.models import base

    extra = {k: m[k] for k in ("tau", "base_arch") if k in m}
    return base.ModelSpec(
        arch=m["arch"], vocab_size=m["vocab_size"], embed_size=m["embed_size"],
        hidden_size=m["hidden_size"], vid_feat_size=m["vid_feat_size"],
        max_len=m["max_len"], num_frames=m["num_frames"], dropout_p=m["dropout_p"],
        sos_id=m["sos_id"], compute_dtype=m["compute_dtype"],
        vocab_pad_to=m["vocab_pad_to"], **extra)


def load_params(sd: Dict[str, torch.Tensor], m: dict, device):
    """The program's parameters on ``device`` from a reference state_dict."""
    from vcr_tpu_torch import convert
    from vcr_tpu_torch.device import params_to

    return params_to(convert.convert_state_dict(sd, model_spec(m), m["arch"]), device)


def export_tree(tree, m: dict) -> Dict[str, torch.Tensor]:
    """A tree shaped as the program's parameters (its parameters, or its
    optimizer's moments) in the reference's keys and layout, as float32 CPU
    tensors, the vocabulary padding cut off."""
    from vcr_tpu_torch import convert

    return convert.export_state_dict(tree, model_spec(m), m["arch"])
