"""Symmetric per-vector integer quantization of attention K/V caches: the
counterpart of ``vcr_tpu/ops/kvquant.py``, in plain PyTorch.

A cache of (rows, h, L, d) vectors is stored as integer codes with one
float32 scale per (row, head, position) vector: ``scale = max|v| / qmax``,
``q = round(v * (1 / scale))`` clipped to [-qmax, qmax] (127 for int8, 7 for
int4: a symmetric codebook). A zero vector gets scale 0 and codes 0, which
dequantize to exact zeros (the unwritten cache). The codes are computed as
the JAX package computes them, a product with the reciprocal and
``torch.round``'s half-to-even, so identical inputs give identical codes.

Both uses of a cache fold the dequantization into small score-side tensors,
so nothing cache-sized is dequantized: K's scales multiply the (..., L)
scores after the product with the codes (:func:`fold_k`), V's multiply the
attention weights before theirs (:func:`fold_v`).

int4: torch has no usable int4 arithmetic, so int4 codes are stored two to a
byte, in ``uint8``, packed along the last axis (d_k): an int4 cache really
holds a quarter of bf16's bytes, plus the scales. :func:`unpack` restores
the int8 codes before a product.
"""

from __future__ import annotations

from typing import Tuple

import torch

# kv_cache mode -> qmax; int4 codes are stored packed (pack_int4)
_QMAX = {"int8": 127.0, "int4": 7.0}


def mode_params(kv_cache: str) -> Tuple[float, torch.dtype]:
    """-> (qmax, storage dtype) of a quantized kv_cache mode."""
    return _QMAX[kv_cache], (torch.int8 if kv_cache == "int8" else torch.uint8)


def code_width(kv_cache: str, d: int) -> int:
    """The stored width of ``d`` codes: d, or d / 2 bytes for int4."""
    return d if kv_cache == "int8" else d // 2


def true_div(x: torch.Tensor, q: float) -> torch.Tensor:
    """x / q correctly rounded on both devices. On the card PyTorch divides
    by a Python scalar as a product with its reciprocal, which can round
    differently; a divisor tensor on x's device takes the true division,
    which the CPU and the JAX package compute."""
    return x / torch.full((), q, dtype=x.dtype, device=x.device)


def quantize(v: torch.Tensor, qmax: float = 127.0, dim: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (codes int8 within [-qmax, qmax], scale float32 shaped like ``v``
    with ``dim`` reduced to 1)."""
    vf = v.float()
    amax = vf.abs().amax(dim=dim, keepdim=True)
    scale = true_div(amax, qmax)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0),
                      torch.zeros_like(scale))
    q = torch.round(vf * inv).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], (..., d) with d even -> uint8 (..., d / 2):
    code 2j in the low nibble of byte j, code 2j+1 in the high one."""
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: uint8 (..., d / 2) -> int8 (..., d)."""
    lo = (p & 0xF).to(torch.int16)
    hi = (p >> 4).to(torch.int16)
    q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], 2 * p.shape[-1])
    return (q - ((q & 0x8) << 1)).to(torch.int8)           # sign-extend the nibble


def quantize_store(v: torch.Tensor, kv_cache: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., d) vectors for a cache of mode ``kv_cache`` -> (stored
    codes, scales (...,) float32): int8 codes, or int4 codes packed."""
    qmax, _ = mode_params(kv_cache)
    q, s = quantize(v, qmax)
    return (q if kv_cache == "int8" else pack_int4(q)), s[..., 0]


def unpack(codes: torch.Tensor) -> torch.Tensor:
    """Stored codes -> int8 codes: packed int4 (uint8) is unpacked."""
    return unpack_int4(codes) if codes.dtype == torch.uint8 else codes


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference dequantization (tests): codes times their broadcast scale."""
    return (unpack(q).float() * scale).to(dtype)


def fold_k(scores_q: torch.Tensor, scale_k: torch.Tensor) -> torch.Tensor:
    """K's scales after the product of the queries with the codes: both
    (..., L)."""
    return scores_q * scale_k


def fold_v(weights: torch.Tensor, scale_v: torch.Tensor) -> torch.Tensor:
    """V's scales folded into the attention weights before their product
    with the codes: both (..., L)."""
    return weights * scale_v
