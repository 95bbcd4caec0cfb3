"""Bahdanau (additive) attention and the Transformer's multi-head attention:
the counterpart of ``vcr_tpu/nn/attention.py``.

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
dtype).

Multi-head attention keeps the reference Transformer's widths: q, k and v
project from the raw encoder (4096) or decoder (300) width to the hidden
width, and the output projects back to the query's width. Its two products
(the scores and the context) take operands rounded to the compute dtype and
give float32 results (``layers.bmm_f32``), as the JAX package's einsums with
``preferred_element_type=float32`` do; ``F.scaled_dot_product_attention``
would round its output to the compute dtype and mask otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcr_tpu_torch.nn.layers import apply_keep_mask, bmm_f32, dense, dense_init


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


# ---------------- multi-head attention (the reference Transformer's widths) ----------------

def mha_init(gen: torch.Generator, hidden_size: int, flag: str, e_width: int = 4096,
             d_width: int = 300) -> dict:
    """flag: "e" (encoder: q, k, v at the raw feature width), "d" (decoder:
    at the word-vector width) or "ed" (cross: q at the decoder's width, k
    and v at the encoder's). The output projects back to q's width. The
    head count is an argument of :func:`mha_apply`, so stacked layers hold
    tensors only."""
    if flag == "e":
        q_in = kv_in = e_width
    elif flag == "d":
        q_in = kv_in = d_width
    elif flag == "ed":
        q_in, kv_in = d_width, e_width
    else:
        raise NotImplementedError(flag)
    return {"q": dense_init(gen, q_in, hidden_size), "k": dense_init(gen, kv_in, hidden_size),
            "v": dense_init(gen, kv_in, hidden_size),
            "out": dense_init(gen, hidden_size, q_in)}


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, hidden) -> (B, heads, L, hidden // heads)."""
    b, l, hidden = x.shape
    return x.reshape(b, l, heads, hidden // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, d_k) -> (B, L, heads * d_k)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def mha_apply(params, heads: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
              dropout_rate: float = 0.1,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Scaled dot-product attention over ``heads`` heads -> (B, Lq, q's
    width) float32.

    The scores are the compute-dtype product of q and k with a float32
    result, divided by sqrt(d_k); where ``mask`` (broadcastable to (B, 1,
    Lq, Lk)) is 0 they are set to -1e9, as the reference's ``masked_fill``.
    The softmax is float32; ``keep`` (B, heads, Lq, Lk), a dropout keep-mask,
    drops probabilities at ``dropout_rate`` (train time only). The context
    is the product of the probabilities and v, both rounded to the compute
    dtype, with a float32 result."""
    d_k = params["q"]["w"].shape[1] // heads
    qh = split_heads(dense(params["q"], q, compute_dtype), heads)
    kh = split_heads(dense(params["k"], k, compute_dtype), heads)
    vh = split_heads(dense(params["v"], v, compute_dtype), heads)
    scores = bmm_f32(qh, kh.transpose(-1, -2), compute_dtype) / (d_k ** 0.5)
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e9)
    attn = torch.softmax(scores, dim=-1)
    if keep is not None:
        attn = apply_keep_mask(attn, keep, dropout_rate)
    return dense(params["out"], merge_heads(bmm_f32(attn, vh, compute_dtype)),
                 compute_dtype)
