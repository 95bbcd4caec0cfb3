"""Core functional layers: the mixed-precision product, dense, embedding and
dropout.

Every product runs through :func:`vdot`: operands rounded to the compute
dtype, float32 accumulation and a float32 result. Parameters are stored
float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from vcr_tpu_torch.nn import init as vinit


class _MatmulF32(torch.autograd.Function):
    """x (M, K) @ w (K, N) on the card, both operands in the compute dtype,
    with a float32 result from cuBLAS.

    ``torch.mm(..., out_dtype=)`` has no derivative of its own. The backward
    is the CPU branch's autograd, which is also what JAX gives for
    ``vcr_tpu.nn.layers.vdot``: dX = g @ w^T and dW = x^T @ g as float32
    products of the float32 gradient and the rounded operands, each rounded
    to its operand's dtype. These float32 products follow torch's matmul
    precision: full float32 unless the caller turns TF32 on.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = (g @ w.float().t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = (x.float().t() @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def vdot(x: torch.Tensor, w: torch.Tensor,
         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w (K, N) with operands cast to ``compute_dtype``, float32
    accumulation and a float32 result. Differentiable on both devices.

    A plain bf16 ``matmul`` would round its result to bf16 a second time. On
    the card the product asks cuBLAS for a float32 output
    (:class:`_MatmulF32`); on the CPU, which has no such kernel, the
    bf16-rounded operands are up-cast to float32, which gives the same exact
    products.
    """
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    if compute_dtype == torch.float32:
        return xc @ wc
    if xc.is_cuda:
        y = _MatmulF32.apply(xc.reshape(-1, xc.shape[-1]), wc)
        return y.reshape(*xc.shape[:-1], wc.shape[-1])
    return xc.float() @ wc.float()


# ---------------- dense ----------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True) -> dict:
    return vinit.dense_init(gen, in_dim, out_dim, use_bias)


def dense(params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    y = vdot(x, params["w"], compute_dtype)
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------- embedding ----------------

def embedding_init(vectors, padded_size: Optional[int] = None) -> dict:
    """GloVe-initialised embedding table, optionally zero-padded on the vocab
    axis to ``padded_size``."""
    table = torch.as_tensor(vectors, dtype=torch.float32)
    if padded_size is not None and padded_size > table.shape[0]:
        pad = torch.zeros((padded_size - table.shape[0], table.shape[1]),
                          dtype=torch.float32)
        table = torch.cat([table, pad], dim=0)
    return {"table": table}


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def mask_vocab_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Force padded vocab columns to -1e9 so they never win argmax."""
    if logits.shape[-1] == vocab_size:
        return logits
    invalid = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(invalid, -1e9)


# ---------------- dropout ----------------

def keep_mask(shape, rate: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A bool dropout mask of ``shape``: True keeps, with probability
    1 - ``rate``, drawn from ``generator``, which lives on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_keep_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout through a drawn mask: kept values scaled by
    1/(1-p), the rest zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) at train time). The mask is drawn
    from ``generator``, which must live on ``x``'s device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at train time needs an explicit generator")
    return apply_keep_mask(x, keep_mask(x.shape, rate, generator, x.device), rate)
