"""Bahdanau (additive) attention: the counterpart of the Bahdanau part of
``vcr_tpu/nn/attention.py``.

energy = tanh(W_q q + W_k k), scores = v^T energy, softmax over frames,
deliberately unmasked as in the reference ("we assume all the frames are
valid"), then the context as the alphas' weighted sum of the values.

The context product takes bf16 alphas and bf16 values and accumulates in
float32, as the JAX package's ``einsum(..., preferred_element_type=f32)``.
Both devices take one route: the operands rounded to the compute dtype, then
up-cast to float32 and multiplied in float32. A product of two bf16 numbers
is exact in float32 (and in TF32, whose 10-bit mantissa holds a bf16 one),
so this gives the exact products with float32 sums, and autograd gives the
JAX package's gradient (float32 products, each rounded to its operand's
dtype). Multi-head attention is ROADMAP A12's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vcr_tpu_torch.nn.layers import dense, dense_init


def bahdanau_init(gen: torch.Generator, hidden_size: int) -> dict:
    """Three bias-free (H, H), (H, H), (H, 1) layers, float32 on the CPU."""
    return {
        "key_layer": dense_init(gen, hidden_size, hidden_size, use_bias=False),
        "query_layer": dense_init(gen, hidden_size, hidden_size, use_bias=False),
        "energy_layer": dense_init(gen, hidden_size, 1, use_bias=False),
    }


def bahdanau_project_keys(params, keys: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W_k·keys (B, N, H) -> (B, N, H) float32, once per sequence."""
    return dense(params["key_layer"], keys, compute_dtype)


def bahdanau_scores(params, query: torch.Tensor, proj_key: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """query (B, H), projected keys (B, N, H) -> energies (B, N) float32.
    Reads ``query_layer`` and ``energy_layer`` only."""
    q = dense(params["query_layer"], query, compute_dtype)            # (B, H)
    energy = torch.tanh(q[:, None, :] + proj_key)                      # (B, N, H)
    return dense(params["energy_layer"], energy, compute_dtype)[..., 0]


def bahdanau_context(scores: torch.Tensor, values: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, N), values (B, N, D) -> (context (B, D) float32, alphas
    (B, N)): the unmasked softmax, then its weighted sum of the values with
    both operands rounded to ``compute_dtype`` and float32 sums."""
    alphas = torch.softmax(scores, dim=-1)
    a = alphas.to(compute_dtype).float()
    v = values.to(compute_dtype).float()
    return torch.bmm(a[:, None, :], v)[:, 0], alphas


def bahdanau_attend(params, query: torch.Tensor, proj_key: torch.Tensor,
                    values: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (context (B, D), alphas (B, N)). No masking: parity with the
    reference's all-frames-valid assumption."""
    scores = bahdanau_scores(params, query, proj_key, compute_dtype)
    return bahdanau_context(scores, values, compute_dtype)
