"""Serving: features -> caption tokens, as one callable.

PyTorch counterpart of ``vcr_tpu/serving.py``. Ported so far: greedy
captioning on precomputed features (``featurizer="none"``) by S2VT, and by
RationaleNet over S2VT (hard-Gumbel frame selection, then its S2VT). Every
other featurizer, family and decode mode raises ``NotImplementedError``
naming its ROADMAP item, so no option is ever silently ignored.
"""

from __future__ import annotations

from typing import Callable

import torch

from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, s2vt


def resolve_eos_id(spec: model_base.ModelSpec, eos_id: int | None = None,
                   vocab=None) -> int:
    """The serving-decode end token: a passed ``vocab`` (anything with
    ``sos_id`` and ``eos_id``) supplies it and is cross-checked against
    ``spec.sos_id``; an explicit ``eos_id`` wins only if it agrees; neither
    defaults to ``spec.sos_id + 1`` (the <sos> <eos> <pad> <unk> layout)."""
    if vocab is not None:
        if vocab.sos_id != spec.sos_id:
            raise ValueError(
                f"vocab.sos_id={vocab.sos_id} != spec.sos_id={spec.sos_id}: "
                "this vocab does not match the model spec")
        if eos_id is not None and eos_id != vocab.eos_id:
            raise ValueError(
                f"explicit eos_id={eos_id} contradicts vocab.eos_id={vocab.eos_id}")
        eos_id = vocab.eos_id
    if eos_id is None:
        eos_id = spec.sos_id + 1
    return eos_id


def build_captioner(params, spec: model_base.ModelSpec,
                    featurizer: str = "none",
                    beam_size: int = 1,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    rng: int = 0,
                    device=None) -> Callable:
    """-> fn(feats (B, N, V), array or tensor) -> tokens (B, L) int32 tensor
    on ``device``.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    versions on the CPU. The parameters are moved there once, here.
    RationaleNet draws its Gumbel noise in each call from a generator seeded
    with ``rng``, so the returned fn is deterministic per input; build it
    with another ``rng`` to re-roll.
    """
    device = resolve_device(device)
    caption = make_caption_fn(spec, featurizer, beam_size, sample_temperature,
                              sample_top_k, sample_top_p, rng)
    params = params_to(params, device)

    def run(feats) -> torch.Tensor:
        with torch.inference_mode():
            return caption(params, torch.as_tensor(feats, device=device))

    return run


def make_caption_fn(spec: model_base.ModelSpec,
                    featurizer: str = "none",
                    beam_size: int = 1,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    rng: int = 0) -> Callable:
    """The serving function ``caption(params, feats) -> tokens``."""
    if featurizer != "none":
        raise NotImplementedError(
            f"featurizer {featurizer!r} is not ported yet: ROADMAP A17 "
            "(featurizers); pass precomputed features with featurizer='none'")
    if beam_size > 1 or sample_temperature > 0 or sample_top_k or sample_top_p:
        raise NotImplementedError(
            "beam search and sampling are not ported yet: ROADMAP A6")
    if spec.arch == "rationale":
        rationale.base_module(spec)  # raises for a base not ported

        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            return rationale.apply(params, spec, feats, emit="tokens", rng=rng)[0]

        return caption
    if spec.arch != "s2vt":
        model_base.build_model(spec.arch)  # raises, naming the ROADMAP item

    def caption(params, feats: torch.Tensor) -> torch.Tensor:
        return s2vt.apply(params, spec, feats, train=False, emit="tokens")

    return caption
