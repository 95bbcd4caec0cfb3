"""Reference PyTorch checkpoints to and from this package's parameters: the
counterpart of ``vcr_tpu/convert.py`` for the families the port runs.

The reference saves ``{'state_dict': model.state_dict(), 'opts', 'epoch',
'n_iter', ...}`` with ``torch.save``. These converters map the state_dicts of
S2VTModel, S2VTAttModel, TransformerNet, and RationaleNet and SpatialNet
over S2VT or S2VT-att onto this package's parameter dicts, and back:

* torch's Linear stores (out, in), this package (in, out): weights
  transpose;
* GRU and LSTM gate matrices (gates, in) -> (in, gates), gate order kept;
* conv weights are (O, I, kH, kW) on both sides and move as they are;
  BatchNorm's weight and bias are ``scale`` and ``bias``, its running stats
  ``mean`` and ``var``;
* vocab-sized tensors (the embedding table, the vocab projection) are
  zero-padded up to ``spec.padded_vocab_size``, and the padding is cut off
  again on export;
* the Transformer's per-layer keys are stacked on a leading layer axis, as
  this package holds them, and unstacked on export; its ``Norm`` keeps
  ``alpha`` and ``bias``; its PE buffers, (1, L, d) in torch, are read where
  present (else built) and written back.

Converted parameters are float32 CPU tensors, copies of the source (a torch
state_dict's tensors may be a live model's). Exported state_dicts hold
float32 CPU tensors in the reference's key names and layouts, ready for the
reference's ``load_state_dict``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from vcr_tpu_torch.models import transformer
from vcr_tpu_torch.models.base import ModelSpec, build_model


def _tensor(v) -> torch.Tensor:
    """A float32 CPU copy of a tensor or an array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if rows <= x.shape[0]:
        return x
    return torch.cat([x, torch.zeros((rows - x.shape[0], *x.shape[1:]), dtype=x.dtype)])


def _lin(sd: Dict, prefix: str, pad_out_to: Optional[int] = None) -> Dict:
    p = {"w": _pad_rows(_tensor(sd[prefix + ".weight"]), pad_out_to or 0).t().contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = _pad_rows(_tensor(sd[prefix + ".bias"]), pad_out_to or 0)
    return p


def _rnn(sd: Dict, prefix: str, suffix: str = "") -> Dict:
    return {
        "w_ih": _tensor(sd[f"{prefix}.weight_ih_l0{suffix}"]).t().contiguous(),
        "w_hh": _tensor(sd[f"{prefix}.weight_hh_l0{suffix}"]).t().contiguous(),
        "b_ih": _tensor(sd[f"{prefix}.bias_ih_l0{suffix}"]),
        "b_hh": _tensor(sd[f"{prefix}.bias_hh_l0{suffix}"]),
    }


def _embedding(sd: Dict, key: str, padded_size: int) -> Dict:
    return {"table": _pad_rows(_tensor(sd[key]), padded_size)}


def _bn(sd: Dict, prefix: str) -> Dict:
    return {"scale": _tensor(sd[prefix + ".weight"]), "bias": _tensor(sd[prefix + ".bias"]),
            "mean": _tensor(sd[prefix + ".running_mean"]),
            "var": _tensor(sd[prefix + ".running_var"])}


def _bahdanau(sd: Dict, prefix: str) -> Dict:
    return {name: _lin(sd, f"{prefix}.{name}")
            for name in ("key_layer", "query_layer", "energy_layer")}


def _mha(sd: Dict, prefix: str) -> Dict:
    return {"q": _lin(sd, prefix + ".q_linear"), "k": _lin(sd, prefix + ".k_linear"),
            "v": _lin(sd, prefix + ".v_linear"), "out": _lin(sd, prefix + ".out")}


def _norm(sd: Dict, prefix: str) -> Dict:
    return {"alpha": _tensor(sd[prefix + ".alpha"]), "bias": _tensor(sd[prefix + ".bias"])}


def _ff(sd: Dict, prefix: str) -> Dict:
    return {"linear_1": _lin(sd, prefix + ".linear_1"),
            "linear_2": _lin(sd, prefix + ".linear_2")}


def _strip(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------- convert

def convert_s2vt(sd: Dict, spec: ModelSpec) -> Dict:
    return {
        "embedding": _embedding(sd, "embedding.0.weight", spec.padded_vocab_size),
        "rnn1": _rnn(sd, "rnn1"),
        "rnn2": _rnn(sd, "rnn2"),
        "linear": _lin(sd, "linear.1", spec.padded_vocab_size),
    }


def convert_s2vt_att(sd: Dict, spec: ModelSpec) -> Dict:
    return {
        "encoder": {"rnn": _rnn(sd, "encoder.rnn")},
        "decoder": {
            "embedding": _embedding(sd, "decoder.embedding.weight", spec.padded_vocab_size),
            "rnn": _rnn(sd, "decoder.rnn"),
            "attention": _bahdanau(sd, "decoder.attention"),
            "pred_linear": _lin(sd, "decoder.pred_linear.1", spec.padded_vocab_size),
        },
    }


def convert_transformer(sd: Dict, spec: ModelSpec) -> Dict:
    """TransformerNet: per-layer keys stacked on a leading layer axis."""
    n = spec.tf_layers
    enc_layers = [{"norm_1": _norm(sd, f"encoder.layers.{i}.norm_1"),
                   "norm_2": _norm(sd, f"encoder.layers.{i}.norm_2"),
                   "attn": _mha(sd, f"encoder.layers.{i}.attn"),
                   "ff": _ff(sd, f"encoder.layers.{i}.ff")} for i in range(n)]
    dec_layers = [{"norm_1": _norm(sd, f"decoder.layers.{i}.norm_1"),
                   "norm_2": _norm(sd, f"decoder.layers.{i}.norm_2"),
                   "norm_3": _norm(sd, f"decoder.layers.{i}.norm_3"),
                   "attn_1": _mha(sd, f"decoder.layers.{i}.attn_1"),
                   "attn_2": _mha(sd, f"decoder.layers.{i}.attn_2"),
                   "ff": _ff(sd, f"decoder.layers.{i}.ff")} for i in range(n)]

    def pe(key, width):
        if key in sd:
            return _tensor(sd[key])[0]
        return torch.from_numpy(transformer.make_positional_encoding(width))

    return {
        "encoder": {"pe": pe("encoder.pe.pe", spec.vid_feat_size),
                    "layers": transformer.stack_layers(enc_layers),
                    "norm": _norm(sd, "encoder.norm")},
        "decoder": {
            "embedding": _embedding(sd, "decoder.embedding.weight", spec.padded_vocab_size),
            "pe": pe("decoder.pe.pe", spec.embed_size),
            "layers": transformer.stack_layers(dec_layers),
            "norm": _norm(sd, "decoder.norm"),
            "norm_out": _norm(sd, "decoder.norm_out"),
            "pred_linear": _lin(sd, "decoder.pred_linear.1", spec.padded_vocab_size),
        },
    }


def convert_rationale(sd: Dict, spec: ModelSpec) -> Dict:
    """RationaleNet over ``spec.base_arch``: its caption net under
    ``caption_net.``, the BiLSTM generator under ``gen.``."""
    return {
        "caption_net": _convert_base(sd, spec),
        "gen": {
            "rnn": {"fwd": _rnn(sd, "gen.rnn"), "bwd": _rnn(sd, "gen.rnn", "_reverse")},
            "linear": _lin(sd, "gen.linear"),
        },
    }


def convert_spatial(sd: Dict, spec: ModelSpec) -> Dict:
    """SpatialNet over ``spec.base_arch``: its caption net under
    ``caption_net.``, the trunk's ``nn.Sequential`` under ``conv.`` (convs
    at 0 and 3, BatchNorms at 1 and 4), the attention under
    ``attention.``."""
    return {
        "caption_net": _convert_base(sd, spec),
        "conv1": {"w": _tensor(sd["conv.0.weight"]), "b": _tensor(sd["conv.0.bias"])},
        "bn1": _bn(sd, "conv.1"),
        "conv2": {"w": _tensor(sd["conv.3.weight"]), "b": _tensor(sd["conv.3.bias"])},
        "bn2": _bn(sd, "conv.4"),
        "attention": _bahdanau(sd, "attention"),
    }


def _convert_base(sd: Dict, spec: ModelSpec) -> Dict:
    """A wrapped family's caption net, from its ``caption_net.`` keys."""
    cap = convert_s2vt_att if spec.base_arch == "s2vt-att" else convert_s2vt
    return cap(_strip(sd, "caption_net."), spec)


CONVERTERS = {"s2vt": convert_s2vt, "s2vt-att": convert_s2vt_att,
              "transformer": convert_transformer, "rationale": convert_rationale,
              "spatial": convert_spatial}


def convert_state_dict(sd: Dict, spec: ModelSpec, arch: str) -> Dict:
    """A reference state_dict of family ``arch`` -> this package's params."""
    if arch not in CONVERTERS:
        build_model(arch)  # raises for an unknown family
    return CONVERTERS[arch](sd, spec)


# ---------------------------------------------------------------- export

def _lin_out(p, prefix: str, out: Dict, vocab_size: Optional[int] = None) -> None:
    """Back to torch's (out, in), the vocab padding cut off."""
    rows = slice(vocab_size)
    out[prefix + ".weight"] = _tensor(p["w"]).t()[rows].contiguous()
    if "b" in p:
        out[prefix + ".bias"] = _tensor(p["b"])[rows].contiguous()


def _rnn_out(p, prefix: str, out: Dict, suffix: str = "") -> None:
    out[f"{prefix}.weight_ih_l0{suffix}"] = _tensor(p["w_ih"]).t().contiguous()
    out[f"{prefix}.weight_hh_l0{suffix}"] = _tensor(p["w_hh"]).t().contiguous()
    out[f"{prefix}.bias_ih_l0{suffix}"] = _tensor(p["b_ih"])
    out[f"{prefix}.bias_hh_l0{suffix}"] = _tensor(p["b_hh"])


def _bn_out(p, prefix: str, out: Dict) -> None:
    """BatchNorm back to torch's keys, with a ``num_batches_tracked`` of 0
    (``tools.export_reference_checkpoint`` writes the checkpoint's n_iter
    there)."""
    out[prefix + ".weight"] = _tensor(p["scale"])
    out[prefix + ".bias"] = _tensor(p["bias"])
    out[prefix + ".running_mean"] = _tensor(p["mean"])
    out[prefix + ".running_var"] = _tensor(p["var"])
    out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def export_s2vt(params: Dict, spec: ModelSpec) -> Dict:
    """S2VT params -> a reference S2VTModel state_dict; the inverse of
    :func:`convert_s2vt`."""
    out: Dict = {"embedding.0.weight": _tensor(params["embedding"]["table"])[
        :spec.vocab_size].contiguous()}
    _rnn_out(params["rnn1"], "rnn1", out)
    _rnn_out(params["rnn2"], "rnn2", out)
    _lin_out(params["linear"], "linear.1", out, spec.vocab_size)
    return out


def export_s2vt_att(params: Dict, spec: ModelSpec) -> Dict:
    """S2VT-att params -> a reference S2VTAttModel state_dict; the inverse of
    :func:`convert_s2vt_att`."""
    out: Dict = {}
    _rnn_out(params["encoder"]["rnn"], "encoder.rnn", out)
    dec = params["decoder"]
    out["decoder.embedding.weight"] = _tensor(dec["embedding"]["table"])[
        :spec.vocab_size].contiguous()
    _rnn_out(dec["rnn"], "decoder.rnn", out)
    for name in ("key_layer", "query_layer", "energy_layer"):
        _lin_out(dec["attention"][name], f"decoder.attention.{name}", out)
    _lin_out(dec["pred_linear"], "decoder.pred_linear.1", out, spec.vocab_size)
    return out


def _norm_out(p, prefix: str, out: Dict) -> None:
    out[prefix + ".alpha"] = _tensor(p["alpha"])
    out[prefix + ".bias"] = _tensor(p["bias"])


def _mha_out(p, prefix: str, out: Dict) -> None:
    for name, key in (("q", "q_linear"), ("k", "k_linear"), ("v", "v_linear"),
                      ("out", "out")):
        _lin_out(p[name], f"{prefix}.{key}", out)


def _ff_out(p, prefix: str, out: Dict) -> None:
    _lin_out(p["linear_1"], prefix + ".linear_1", out)
    _lin_out(p["linear_2"], prefix + ".linear_2", out)


def export_transformer(params: Dict, spec: ModelSpec) -> Dict:
    """Transformer params -> a reference TransformerNet state_dict, the
    layers unstacked and the PE buffers in torch's (1, L, d) shape; the
    inverse of :func:`convert_transformer`."""
    out: Dict = {}
    enc, dec = params["encoder"], params["decoder"]
    for i in range(spec.tf_layers):
        lp = transformer.layer_params(enc["layers"], i)
        _norm_out(lp["norm_1"], f"encoder.layers.{i}.norm_1", out)
        _norm_out(lp["norm_2"], f"encoder.layers.{i}.norm_2", out)
        _mha_out(lp["attn"], f"encoder.layers.{i}.attn", out)
        _ff_out(lp["ff"], f"encoder.layers.{i}.ff", out)
        lp = transformer.layer_params(dec["layers"], i)
        for norm in ("norm_1", "norm_2", "norm_3"):
            _norm_out(lp[norm], f"decoder.layers.{i}.{norm}", out)
        _mha_out(lp["attn_1"], f"decoder.layers.{i}.attn_1", out)
        _mha_out(lp["attn_2"], f"decoder.layers.{i}.attn_2", out)
        _ff_out(lp["ff"], f"decoder.layers.{i}.ff", out)
    out["encoder.pe.pe"] = _tensor(enc["pe"])[None]
    out["decoder.pe.pe"] = _tensor(dec["pe"])[None]
    _norm_out(enc["norm"], "encoder.norm", out)
    out["decoder.embedding.weight"] = _tensor(dec["embedding"]["table"])[
        :spec.vocab_size].contiguous()
    _norm_out(dec["norm"], "decoder.norm", out)
    _norm_out(dec["norm_out"], "decoder.norm_out", out)
    _lin_out(dec["pred_linear"], "decoder.pred_linear.1", out, spec.vocab_size)
    return out


def export_rationale(params: Dict, spec: ModelSpec) -> Dict:
    """RationaleNet params -> a reference RationaleNet state_dict; the
    inverse of :func:`convert_rationale`."""
    out = _export_base(params, spec)
    _rnn_out(params["gen"]["rnn"]["fwd"], "gen.rnn", out)
    _rnn_out(params["gen"]["rnn"]["bwd"], "gen.rnn", out, suffix="_reverse")
    _lin_out(params["gen"]["linear"], "gen.linear", out)
    return out


def export_spatial(params: Dict, spec: ModelSpec) -> Dict:
    """SpatialNet params -> a reference SpatialNet state_dict; the inverse of
    :func:`convert_spatial`."""
    out = _export_base(params, spec)
    for conv, bn, index in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
        out[f"conv.{index}.weight"] = _tensor(params[conv]["w"])
        out[f"conv.{index}.bias"] = _tensor(params[conv]["b"])
        _bn_out(params[bn], f"conv.{index + 1}", out)
    for name in ("key_layer", "query_layer", "energy_layer"):
        _lin_out(params["attention"][name], f"attention.{name}", out)
    return out


def _export_base(params: Dict, spec: ModelSpec) -> Dict:
    """A wrapped family's caption net under ``caption_net.``."""
    exp = export_s2vt_att if spec.base_arch == "s2vt-att" else export_s2vt
    return {"caption_net." + k: v for k, v in exp(params["caption_net"], spec).items()}


EXPORTERS = {"s2vt": export_s2vt, "s2vt-att": export_s2vt_att,
             "transformer": export_transformer, "rationale": export_rationale,
             "spatial": export_spatial}


def export_state_dict(params: Dict, spec: ModelSpec, arch: str) -> Dict:
    """This package's params of family ``arch`` -> a reference state_dict."""
    if arch not in EXPORTERS:
        build_model(arch)  # raises for an unknown family
    return EXPORTERS[arch](params, spec)


# ---------------------------------------------------------------- detect, load

def detect_arch(sd: Dict) -> str:
    """The reference model family, from the state_dict's key structure."""
    keys = set(sd)
    if any(k.startswith("gen.rnn.") for k in keys):
        return "rationale"
    if "conv.0.weight" in keys and any(k.startswith("caption_net.") for k in keys):
        return "spatial"
    if any(k.startswith("encoder.layers.0.attn.q_linear") for k in keys):
        return "transformer"
    if any(k.startswith("decoder.attention.") for k in keys):
        return "s2vt-att"
    return "s2vt"


def detect_base_arch(sd: Dict) -> Optional[str]:
    """For a wrapped family (RationaleNet, SpatialNet): the captioner inside,
    from its ``caption_net.`` keys; None for an unwrapped state_dict."""
    if not any(k.startswith("caption_net.") for k in sd):
        return None
    if any(k.startswith("caption_net.decoder.attention.") for k in sd):
        return "s2vt-att"
    return "s2vt"


def read_reference_checkpoint(path: str) -> Dict:
    """A reference ``.net`` file -> its dict, read with ``weights_only``:
    tensors and plain values, plus the ``opts`` the reference stores as an
    ``argparse.Namespace``. Nothing else is unpickled."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(path: str, spec: ModelSpec, arch: str):
    """Read a reference ``model_{latest,best}.net`` and convert it -> (params,
    meta): meta holds everything but the weights, plus ``detected_arch`` and
    ``detected_base_arch``. A wrapped family and its captioner are taken from
    the keys where they differ from ``arch`` and ``spec.base_arch``."""
    blob = read_reference_checkpoint(path)
    sd = blob["state_dict"]
    detected = detect_arch(sd)
    if detected != arch and detected in ("rationale", "spatial"):
        arch = detected
    base = detect_base_arch(sd)
    if base is not None and base != spec.base_arch:
        spec = spec.with_(base_arch=base)
    params = convert_state_dict(sd, spec, arch)
    meta = {k: v for k, v in blob.items() if k != "state_dict"}
    meta["detected_arch"] = detected
    meta["detected_base_arch"] = base
    return params, meta
