"""Serving: raw frames or features -> caption tokens, as one callable.

PyTorch counterpart of ``vcr_tpu/serving.py``: captioning by S2VT, by
S2VT-att, by the Transformer (its KV-cached serving decodes), by
RationaleNet over S2VT or S2VT-att (hard-Gumbel frame selection, then its
captioner) and by SpatialNet over either (on (B, N, F, K, K) grid
features), greedy, by beam search or by sampling (``decode``), and in the
quantized serving modes: int8 or int4 K/V caches (the Transformer's) and
int8 decode weights. The input is precomputed features
(``featurizer="none"``) or raw normalized frames (B, N, 3, S, S) that a
fused backbone featurizes first: VGG16's fc7 (``"vgg16"``), ResNet's pooled
features (``"resnet"``) or Darknet's grid cut (``"yolo"``, for SpatialNet).
A mode a decode has no form for raises ``ValueError``, so no option is
ever silently ignored.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from vcr_tpu_torch import decode
from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, resnet, spatial, vgg
from vcr_tpu_torch.models import transformer as tr
from vcr_tpu_torch.utils.profiling import span

FEATURIZERS = ("none", "vgg16", "resnet", "yolo")


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
                    feat_params=None,
                    rng: int | None = None,
                    beam_size: int = 1,
                    eos_id: int | None = None,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    vocab=None,
                    kv_cache: str | None = None,
                    decode_weights: str | None = None,
                    device=None) -> Callable:
    """-> fn(feats (B, N, V), or SpatialNet's (B, N, F, K, K), or frames (B,
    N, 3, S, S) under a fused featurizer; array or tensor) -> tokens (B, L)
    int32 tensor on ``device``.

    The arguments come in the JAX package's order, so a positional call
    means the same in both, then ``device``, which defaults to the card;
    pass ``device="cpu"`` for the plain versions on the CPU. The parameters
    are moved there once, here.

    ``featurizer``: ``"none"`` (the input is features; the default here,
    where the JAX package defaults to ``"vgg16"``: every server, pool and
    command line of this package feeds features), ``"vgg16"`` (fc7, 4096-d;
    ``feat_params`` its ``models.vgg`` weights), ``"resnet"`` (pooled
    512-d; ``models.resnet`` weights) or ``"yolo"`` (Darknet's grid cut, for
    SpatialNet; ``feat_params`` a ``models.darknet.Darknet``, whose cfg
    shapes the call and whose weights are moved to ``device``). The frames
    of all B videos go through the backbone as one batch of B*N. A
    featurizer without ``feat_params``, or ``feat_params`` without one,
    raises ValueError.

    Greedy: S2VT, S2VT-att, RationaleNet and SpatialNet their greedy decode,
    the Transformer its KV-cached ``decode_greedy_fast`` on features cast to
    the compute dtype. ``beam_size > 1`` returns each item's best beam
    (``decode.decode_tokens``; the Transformer's KV-cached
    ``transformer_beam_decode_fast`` with gathered caches);
    ``sample_temperature > 0`` samples instead, optionally top-k and/or top-p
    restricted (``decode.sample_tokens``). The two together raise
    ValueError, and so do the sampling filters without sampling. ``eos_id``
    comes from ``vocab`` or is given (:func:`resolve_eos_id`).

    Quantized modes (bounded-error: tokens differ from bf16's): the
    Transformer's greedy, beam and sampling take ``kv_cache="int8"|"int4"``
    and ``decode_weights="int8"``. The GRU families take
    ``decode_weights="int8"`` on the beam and sampling paths (the JAX
    package drops it there); their greedy decode has no int8-weight form
    and raises ValueError (the slot pool serves it), and a quantized
    ``kv_cache`` raises ValueError (they have no attention cache).

    Every random draw of a call (RationaleNet's Gumbel noise, the sampling
    noise) comes from a generator seeded with ``rng`` (an int; None: 0), so
    the returned fn is deterministic per input; build it with another
    ``rng`` to re-roll.
    """
    darknet, feat_params = split_feat_params(featurizer, feat_params)
    device = resolve_device(device)
    caption = make_caption_fn(spec, featurizer, beam_size,
                              resolve_eos_id(spec, eos_id, vocab), sample_temperature,
                              sample_top_k, sample_top_p, 0 if rng is None else rng,
                              kv_cache=kv_cache, decode_weights=decode_weights,
                              darknet=darknet)
    params = params_to(params, device)
    feat_params = params_to(feat_params, device)
    if model_base.check_serving_modes(kv_cache, decode_weights)[1] == "int8":
        # quantized once here; the steppers find the codes
        params = decode.augment_decode_weights(params, spec)

    fused = {} if featurizer == "none" else {"feat_params": feat_params}

    def run(feats) -> torch.Tensor:
        with torch.inference_mode():
            return caption(params, torch.as_tensor(feats, device=device), **fused)

    return run


def split_feat_params(featurizer: str, feat_params):
    """-> (the Darknet object or None, the featurizer's weight tree or
    None), checked against ``featurizer``: a backbone needs its weights
    (for ``"yolo"`` a ``Darknet``), ``"none"`` takes none."""
    if featurizer not in FEATURIZERS:
        raise ValueError(f"unknown featurizer {featurizer!r}; one of {FEATURIZERS}")
    if featurizer == "none":
        if feat_params is not None:
            raise ValueError("feat_params given with featurizer='none': name the "
                             "backbone they are the weights of")
        return None, None
    if feat_params is None:
        raise ValueError(f"featurizer {featurizer!r} needs feat_params (its weights; "
                         "for 'yolo' a models.darknet.Darknet)")
    if featurizer == "yolo":
        if not hasattr(feat_params, "blocks"):
            raise TypeError("featurizer 'yolo' takes a models.darknet.Darknet as "
                            f"feat_params, not {type(feat_params).__name__}")
        return feat_params, feat_params.params
    return None, feat_params


def make_featurize(spec: model_base.ModelSpec, featurizer: str, darknet=None):
    """``featurize(feat_params, frames (B, N, 3, S, S)) -> features``:
    (B, N, 4096) VGG16 fc7, (B, N, 512) ResNet pooled, or (B, N, F, K, K)
    Darknet's cut ``outputs[first_yolo - 2]``, all float32, the B*N frames
    run as one batch in the compute dtype; None for ``"none"``."""
    if featurizer == "none":
        return None
    if featurizer == "yolo":
        if darknet is None:
            raise ValueError("featurizer 'yolo' needs the Darknet (its cfg shapes the "
                             "trace)")

        def extract(fp, flat):
            return darknet.get_feats(flat, spec.cdtype, params=fp)
    elif featurizer in ("vgg16", "resnet"):
        backbone = vgg.extract_fc7 if featurizer == "vgg16" else resnet.extract_features

        def extract(fp, flat):
            return backbone(fp, flat, spec.cdtype)
    else:
        raise ValueError(f"unknown featurizer {featurizer!r}; one of {FEATURIZERS}")

    def featurize(fp, frames: torch.Tensor) -> torch.Tensor:
        b, n = frames.shape[:2]
        feats = extract(fp, frames.reshape(b * n, *frames.shape[2:]))
        return feats.reshape(b, n, *feats.shape[1:])

    return featurize


def make_caption_fn(spec: model_base.ModelSpec,
                    featurizer: str = "none",
                    beam_size: int = 1,
                    eos_id: int | None = None,
                    sample_temperature: float = 0.0,
                    sample_top_k: int = 0,
                    sample_top_p: float = 0.0,
                    rng: int = 0,
                    kv_cache: str | None = None,
                    decode_weights: str | None = None,
                    darknet=None) -> Callable:
    """The serving function ``caption(params, feats, noise=None,
    feat_params=None) -> tokens``; ``eos_id`` already resolved (None:
    ``spec.sos_id + 1``). A call draws its random numbers (:func:`draw_plan`)
    from a generator seeded with ``rng``, unless ``noise`` gives them as
    tensors by their plan names: ``export_serving`` makes them inputs of the
    exported program. Under a fused ``featurizer`` the input is frames,
    featurized with ``feat_params`` first (:func:`make_featurize`;
    ``darknet`` is the Darknet of ``"yolo"``). Each call is the root span
    ``caption`` (``utils.profiling``); a caller with a request id of its own
    opens a span with it around the call, and ``caption`` shares its root."""
    featurize = make_featurize(spec, featurizer, darknet)
    caption = _caption_fn(spec, beam_size, eos_id, sample_temperature, sample_top_k,
                          sample_top_p, rng, kv_cache, decode_weights)

    def featurized(params, frames: torch.Tensor, noise=None,
                   feat_params=None) -> torch.Tensor:
        return caption(params, featurize(feat_params, frames), noise)

    call = caption if featurize is None else featurized

    @functools.wraps(call)
    def spanned(*args, **kwargs) -> torch.Tensor:
        with span("caption"):
            return call(*args, **kwargs)

    return spanned


def _caption_fn(spec, beam_size, eos_id, sample_temperature, sample_top_k, sample_top_p,
                rng, kv_cache, decode_weights) -> Callable:
    """:func:`make_caption_fn`'s caption on features."""
    kv_cache, decode_weights = model_base.check_serving_modes(kv_cache, decode_weights)
    decode.check_decode_mode(beam_size, sample_temperature, sample_top_k, sample_top_p)
    decode.check_gru_kv_cache(spec, kv_cache)
    if (decode_weights == "int8" and spec.arch != "transformer" and beam_size <= 1
            and sample_temperature <= 0):
        raise ValueError(
            f"decode_weights='int8': the {spec.arch} greedy batch decode has no "
            "int8-weight form; int8 decode weights are served by the slot pool "
            "(serving_continuous.ContinuousCaptioner, --mode serve) and by the beam "
            "(beam_size > 1) and sampling paths")
    if eos_id is None:
        eos_id = spec.sos_id + 1
    _, apply_fn = model_base.build_model(spec.arch)  # raises for an unknown family
    if spec.arch in ("rationale", "spatial"):
        model_base.base_module(spec)  # raises for an unknown base

    if spec.arch == "transformer":
        return _transformer_caption_fn(spec, beam_size, eos_id, sample_temperature,
                                       sample_top_k, sample_top_p, rng, kv_cache,
                                       decode_weights)
    if sample_temperature > 0:
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            noise = noise or {}
            return decode.sample_tokens(params, spec, feats, eos_id, rng,
                                        sample_temperature, sample_top_k, sample_top_p,
                                        gumbel=noise.get("steps"),
                                        gumbel_noise=noise.get("select"),
                                        decode_weights=decode_weights)
    elif beam_size > 1 and spec.arch == "rationale":
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            tokens, _ = decode.rationale_beam_decode(
                params, spec, feats, beam_size, eos_id, rng=rng,
                decode_weights=decode_weights, gumbel_noise=(noise or {}).get("select"))
            return tokens[:, 0]                       # best beam per item
    elif beam_size > 1:
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            tokens, _ = decode.decode_tokens(params, spec, feats, eos_id, beam_size,
                                             decode_weights=decode_weights)
            return tokens[:, 0]                       # best beam per item
    elif spec.arch == "rationale":
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            return rationale.apply(params, spec, feats, emit="tokens", rng=rng,
                                   gumbel_noise=(noise or {}).get("select"))[0]
    elif spec.arch == "spatial":
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            return spatial.apply(params, spec, feats, emit="tokens")[0]
    else:
        def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
            return apply_fn(params, spec, feats, train=False, emit="tokens")

    return caption


def draw_plan(spec: model_base.ModelSpec, beam_size: int = 1,
              sample_temperature: float = 0.0) -> list:
    """The random draws of one call of :func:`make_caption_fn`'s caption, in
    the order its generator makes them: RationaleNet's frame-selection noise
    ``"select"`` (B, N, 2), then, when sampling, one (B, padded vocab) block
    per decode step, stacked as ``"steps"`` (L, B, padded vocab). Each entry
    is ``{"input", "kind": "gumbel", "shape"}`` with ``"b"`` for the batch,
    plus ``"steps"`` for a stack of per-step draws. Passing these tensors as
    the caption's ``noise`` gives the tokens of a call that draws them."""
    plan = []
    if spec.arch == "rationale":
        plan.append({"input": "select", "kind": "gumbel",
                     "shape": ["b", spec.num_frames, 2]})
    if sample_temperature > 0:
        plan.append({"input": "steps", "kind": "gumbel",
                     "shape": ["b", spec.padded_vocab_size], "steps": spec.max_len})
    return plan


def _transformer_caption_fn(spec: model_base.ModelSpec, beam_size: int, eos_id: int,
                            sample_temperature: float, sample_top_k: int,
                            sample_top_p: float, rng: int, kv_cache: str,
                            decode_weights: str) -> Callable:
    """The Transformer's serving decodes, all through the KV-cached stepper
    in the given modes, on features cast to the compute dtype: greedy, the
    gathered-cache beam, or sampling."""
    modes = {"kv_cache": kv_cache, "decode_weights": decode_weights}

    def caption(params, feats: torch.Tensor, noise=None) -> torch.Tensor:
        feats = feats.to(spec.cdtype)
        if sample_temperature > 0:
            return decode.sample_tokens(params, spec, feats, eos_id, rng,
                                        sample_temperature, sample_top_k, sample_top_p,
                                        gumbel=(noise or {}).get("steps"), **modes)
        if beam_size > 1:
            return decode.transformer_beam_decode_fast(params, spec, feats, beam_size,
                                                       eos_id, **modes)[0][:, 0]
        with span("encode"):
            e_outputs = tr.encode(params, spec, feats, tr.create_masks_inp(feats))
        return tr.decode_greedy_fast(params, spec, e_outputs, **modes)

    return caption
