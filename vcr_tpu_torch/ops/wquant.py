"""Symmetric per-output-channel int8 quantization of decode weights (W8A16):
the counterpart of ``vcr_tpu/ops/wquant.py``, in plain PyTorch.

For a dense ``y = x @ W`` with ``W`` (in, out), each output column gets one
float32 scale::

    s[o]     = max_i |W[i, o]| / 127
    Wq[i, o] = round(W[i, o] * (1 / s[o]))          (int8)
    y        = (x @ Wq) * s + b

The scale is constant along the contraction, so it factors out of the
product exactly; only the rounding of the weights differs from the float
weights. The codes go into the product cast to the compute dtype (int8 is
exact in bf16), with float32 accumulation (``nn.layers.vdot``), and the
scale multiplies the small (rows, out) result. A zero column gets scale 0
and codes 0.

The Transformer's decoder replaces its dense dicts by quantized ones
(``{"wq", "ws"[, "b"]}``, :func:`quantize_dense`). The GRU families'
recurrent dicts also drive their encoders, so they are augmented instead
(:func:`augment_gru`, :func:`augment_dense`: the codes beside the float32
originals), and the encoders keep reading the originals.
"""

from __future__ import annotations

from typing import Optional

import torch

from vcr_tpu_torch.nn.layers import vdot
from vcr_tpu_torch.ops import kvquant

_QMAX = 127.0


def resolve_mode(decode_weights: Optional[str]) -> str:
    """``"bf16"`` (also for None) or ``"int8"``; anything else raises."""
    dw = decode_weights or "bf16"
    if dw not in ("bf16", "int8"):
        raise ValueError(f"decode_weights must be 'bf16' or 'int8', got {dw!r}")
    return dw


def _quantize_w(w: torch.Tensor):
    """(..., in, out) -> (int8 codes, float32 scales (..., out)), reduced
    over the contraction axis, so a layer stack quantizes per layer."""
    w = w.float()
    scale = kvquant.true_div(w.abs().amax(dim=-2), _QMAX)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0),
                      torch.zeros_like(scale))
    q = torch.round(w * inv[..., None, :]).clamp(-_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize_dense(p: dict) -> dict:
    """{"w" (..., in, out)[, "b"]} -> {"wq" int8, "ws" float32 (..., out)[, "b"]}."""
    q, s = _quantize_w(p["w"])
    out = {"wq": q, "ws": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dense_q(p: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
            ) -> torch.Tensor:
    """The dense of a quantized dict: (x @ Wq) * s (+ b), float32."""
    y = vdot(x, p["wq"], compute_dtype) * p["ws"]
    if "b" in p:
        y = y + p["b"]
    return y


def dequantize_dense(p: dict) -> dict:
    """Reference dequantization back to a float dense dict (tests)."""
    out = {"w": p["wq"].float() * p["ws"][..., None, :]}
    if "b" in p:
        out["b"] = p["b"]
    return out


def augment_gru(p: dict) -> dict:
    """A GRU dict plus ``wq_ih``/``ws_ih``/``wq_hh``/``ws_hh``: the codes and
    per-gate-column scales of w_ih and w_hh. Idempotent."""
    if "wq_hh" in p:
        return p
    qi, si = _quantize_w(p["w_ih"])
    qh, sh = _quantize_w(p["w_hh"])
    return dict(p, wq_ih=qi, ws_ih=si, wq_hh=qh, ws_hh=sh)


def augment_dense(p: dict) -> dict:
    """A dense dict plus ``wq``/``ws``. Idempotent."""
    if "wq" in p:
        return p
    q, s = _quantize_w(p["w"])
    return dict(p, wq=q, ws=s)


# the dense of an augmented dict, through its int8 codes: the same product
dense_aug = dense_q


def gru_x_gates(p: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """x @ w_ih + b_ih through the codes of an augmented GRU dict."""
    return vdot(x, p["wq_ih"], compute_dtype) * p["ws_ih"] + p["b_ih"]


def gru_h_gates(p: dict, h: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """h @ w_hh + b_hh through the codes of an augmented GRU dict, for
    ``nn.rnn.gru_gates``' ``h_gates``."""
    return vdot(h, p["wq_hh"], compute_dtype) * p["ws_hh"] + p["b_hh"]
