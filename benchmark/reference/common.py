"""What the plain references share: the products at a stated precision, the
GRU and LSTM cells with torch.nn.GRU's and torch.nn.LSTM's gate equations,
and a scope in which a float32 product is float32.

Every weight is in torch's layout, (out, in), as the reference project's
``state_dict`` holds it. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

PRECISIONS = ("fp32", "bf16", "fp8")
FP8_MAX = 448.0     # the largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for matrix products and cuDNN inside the scope; the caller's
    settings come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32. The gradient
    passes through unchanged, so a backward product reads the rounded
    operand, as a bf16 program's backward reads its bf16 operands."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, back in float32, the gradient unchanged."""
    return t + (t.detach().bfloat16().float() - t).detach()


def product(x: torch.Tensor, w: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """x (..., in) @ w (out, in)^T, both operands rounded to ``prec`` first
    and the product accumulated and returned in float32."""
    if prec == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    elif prec == "bf16":
        x, w = bf16_round(x), bf16_round(w)
    elif prec != "fp32":
        raise ValueError(f"precision {prec!r} is none of {PRECISIONS}")
    return x @ w.t()


def gru_cell(gi: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             prec: str) -> torch.Tensor:
    """One step of torch.nn.GRU from its input gates ``gi`` = x W_ih^T +
    b_ih: gate order r, z, n; n = tanh(gi_n + r * (h W_hn^T + b_hn))."""
    gh = product(h, w_hh, prec) + b_hh
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell(gi: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor, prec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of torch.nn.LSTM from its input gates: gate order i, f, g, o;
    c' = f c + i g, h' = o tanh(c')."""
    g_all = gi + product(h, w_hh, prec) + b_hh
    i, f, g, o = g_all.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c
