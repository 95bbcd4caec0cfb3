"""Serving: features -> caption tokens, as one callable.

PyTorch counterpart of ``vcr_tpu/serving.py``. Ported so far: captioning on
precomputed features (``featurizer="none"``) by S2VT, by S2VT-att, by
RationaleNet over either (hard-Gumbel frame selection, then its captioner)
and by SpatialNet over either (on (B, N, F, K, K) grid features), greedy, by
beam search or by sampling (``decode``). Every other featurizer (YOLOv3's
among them), family and decode-weight mode raises ``NotImplementedError``
naming its ROADMAP item, so no option is ever silently ignored.
"""

from __future__ import annotations

from typing import Callable

import torch

from vcr_tpu_torch import decode
from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, spatial


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
                    eos_id: int | None = None,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    vocab=None,
                    kv_cache: str | None = None,
                    decode_weights: str | None = None,
                    rng: int = 0,
                    device=None) -> Callable:
    """-> fn(feats (B, N, V), or SpatialNet's (B, N, F, K, K); array or
    tensor) -> tokens (B, L) int32 tensor on ``device``.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    versions on the CPU. The parameters are moved there once, here.

    ``beam_size > 1`` returns each item's best beam (``decode.decode_tokens``);
    ``sample_temperature > 0`` samples instead, optionally top-k and/or top-p
    restricted (``decode.sample_tokens``). The two together raise
    ValueError, and so do the sampling filters without sampling. ``eos_id``
    comes from ``vocab`` or is given (:func:`resolve_eos_id`). ``kv_cache``
    (a Transformer's) and ``decode_weights`` other than bf16 raise naming
    ROADMAP A13.

    Every random draw of a call (RationaleNet's Gumbel noise, the sampling
    noise) comes from a generator seeded with ``rng``, so the returned fn is
    deterministic per input; build it with another ``rng`` to re-roll.
    """
    device = resolve_device(device)
    caption = make_caption_fn(spec, featurizer, beam_size,
                              resolve_eos_id(spec, eos_id, vocab), sample_temperature,
                              sample_top_k, sample_top_p, rng, kv_cache=kv_cache,
                              decode_weights=decode_weights)
    params = params_to(params, device)

    def run(feats) -> torch.Tensor:
        with torch.inference_mode():
            return caption(params, torch.as_tensor(feats, device=device))

    return run


def make_caption_fn(spec: model_base.ModelSpec,
                    featurizer: str = "none",
                    beam_size: int = 1,
                    eos_id: int | None = None,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    rng: int = 0,
                    kv_cache: str | None = None,
                    decode_weights: str | None = None) -> Callable:
    """The serving function ``caption(params, feats) -> tokens``; ``eos_id``
    already resolved (None: ``spec.sos_id + 1``)."""
    if featurizer != "none":
        raise NotImplementedError(
            f"featurizer {featurizer!r} is not ported yet: ROADMAP A17 "
            "(featurizers); pass precomputed features with featurizer='none'")
    if kv_cache not in (None, "bf16"):
        raise NotImplementedError(
            f"kv_cache={kv_cache!r} is not ported yet: ROADMAP A13 "
            "(quantized serving modes)")
    decode.check_decode_weights(decode_weights)
    decode.check_decode_mode(beam_size, sample_temperature, sample_top_k, sample_top_p)
    if eos_id is None:
        eos_id = spec.sos_id + 1
    _, apply_fn = model_base.build_model(spec.arch)  # raises, naming the ROADMAP item
    if spec.arch in ("rationale", "spatial"):
        model_base.base_module(spec)  # raises for an unknown base

    if sample_temperature > 0:
        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            return decode.sample_tokens(params, spec, feats, eos_id, rng,
                                        sample_temperature, sample_top_k, sample_top_p)
    elif beam_size > 1:
        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            tokens, _ = decode.decode_tokens(params, spec, feats, eos_id, beam_size,
                                             rng=rng)
            return tokens[:, 0]                       # best beam per item
    elif spec.arch == "rationale":
        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            return rationale.apply(params, spec, feats, emit="tokens", rng=rng)[0]
    elif spec.arch == "spatial":
        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            return spatial.apply(params, spec, feats, emit="tokens")[0]
    else:
        def caption(params, feats: torch.Tensor) -> torch.Tensor:
            return apply_fn(params, spec, feats, train=False, emit="tokens")

    return caption
