"""Device resolution shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A card asked for where there is none raises,
    never falls back to the CPU. Pass ``device="cpu"`` to run the plain
    versions on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device


def params_to(params, device):
    """A nest of dicts, lists and tuples of tensors, moved to ``device`` (no
    copy where it is already there); ``None`` stays ``None``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    if params is None:
        return None
    return params.to(device)
