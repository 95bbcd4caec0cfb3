"""Shared model machinery: the static ModelSpec and the arch registry."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class ModelSpec:
    """Static model configuration, the fields of the JAX package's spec.

    There is no kernel switch: CUDA tensors take the hand-written kernels and
    CPU tensors take their plain versions.
    """

    arch: str
    vocab_size: int
    embed_size: int
    hidden_size: int
    vid_feat_size: int
    max_len: int
    num_frames: int
    dropout_p: float
    sos_id: int
    compute_dtype: str = "bfloat16"
    # RationaleNet / SpatialNet
    tau: float = 1.0
    base_arch: str = "s2vt"
    # Transformer
    tf_layers: int = 6
    tf_heads: int = 8
    # SpatialNet grid
    grid_size: int = 13
    # Pad the vocab axis of the embedding table and the output projection up
    # to a multiple of this. Padded logit columns are masked to -1e9, so they
    # never win argmax. 1 = no padding.
    vocab_pad_to: int = 1

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def with_(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)


def spec_from_config(cfg, vocab) -> ModelSpec:
    """A ModelSpec from a Config and a Vocab. RationaleNet and SpatialNet
    wrap ``cfg.arch``, their base captioner."""
    return ModelSpec(
        arch=cfg.arch,
        vocab_size=vocab.vocab_size,
        embed_size=vocab.embed_size,
        hidden_size=cfg.hidden_size,
        vid_feat_size=cfg.vid_feat_size,
        max_len=cfg.max_len,
        num_frames=cfg.num_frames,
        dropout_p=cfg.dropout_p,
        sos_id=vocab.sos_id,
        compute_dtype=cfg.compute_dtype,
        tau=cfg.tau,
        base_arch=cfg.arch if cfg.arch in ("s2vt", "s2vt-att") else "s2vt",
        tf_layers=cfg.tf_layers,
        tf_heads=cfg.tf_heads,
        vocab_pad_to=cfg.vocab_pad_to,
    )


# the ported families, registered by their modules: name -> (init, apply)
_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}

# Families of the JAX package not ported yet, with their ROADMAP items.
_NOT_PORTED = {
    "s2vt-att": "ROADMAP A9 (S2VT-att)",
    "spatial": "ROADMAP A11 (SpatialNet)",
    "transformer": "ROADMAP A12 (Transformer)",
}


def register(name: str, init_fn: Callable, apply_fn: Callable) -> None:
    _REGISTRY[name] = (init_fn, apply_fn)


def build_model(name: str) -> Tuple[Callable, Callable]:
    """-> (init_params, apply). Ported so far: ``s2vt`` and ``rationale``
    over S2VT, each with its eval and train branches (``apply(...,
    train=True)``, driven by ``train.step``); the others raise naming their
    ROADMAP item."""
    import vcr_tpu_torch.models.rationale  # noqa: F401  (registers itself)
    import vcr_tpu_torch.models.s2vt  # noqa: F401  (registers itself)

    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: {_NOT_PORTED[name]}")
    raise NotImplementedError(f"Unknown model architecture {name!r}")
