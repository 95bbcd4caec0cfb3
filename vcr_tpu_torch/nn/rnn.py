"""Plain GRU and LSTM cells with torch.nn.GRU's and torch.nn.LSTM's gate
semantics.

The input-to-hidden projection for a whole sequence is one (T·B, I) @ (I, kH)
product outside the recurrence; each step then does the (B, H) @ (H, kH)
recurrent product and the gate math. Gate order is r, z, n (GRU) and
i, f, g, o (LSTM) as in torch, and the state is carried in float32.

These are the plain recurrences. The models' sequence recurrences go
through ``vcr_tpu_torch.ops.cuda_gru`` and ``ops.cuda_lstm``, whose plain
versions are :func:`gru_scan` and :func:`lstm_scan`, and whose gradients
rerun :func:`gru_sequence` and :func:`lstm_sequence`.

Gate remat: inside a :func:`gate_remat_default` scope that is on,
:func:`gru_gates` runs its recurrent product and gate math under
``torch.utils.checkpoint``, so the backward recomputes them from ``x_gates``
and ``h`` instead of keeping the gate intermediates. The recompute is the same
float32 sequence of operations, so a train step is bitwise the same with the
scope on or off. The JAX package's ``VCR_GRU_GATES_REMAT`` environment
override is not ported: the scope is the only switch.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint

from vcr_tpu_torch.nn import init as vinit
from vcr_tpu_torch.nn.layers import vdot


def gru_init(gen: torch.Generator, input_size: int, hidden_size: int) -> dict:
    """Params for a single-layer GRU, stored (in, 3H) / (H, 3H), gate order
    [r | z | n]."""
    return {
        "w_ih": vinit.rnn_mat_init(gen, input_size, 3 * hidden_size),
        "w_hh": vinit.rnn_mat_init(gen, hidden_size, 3 * hidden_size),
        "b_ih": vinit.const_bias(3 * hidden_size),
        "b_hh": vinit.const_bias(3 * hidden_size),
    }


# Whether gru_gates checkpoints its step, for the code that runs inside a
# gate_remat_default scope; a context variable, so that each thread and task
# sees its own scope.
_GATE_REMAT: contextvars.ContextVar[bool] = contextvars.ContextVar("gate_remat",
                                                                   default=False)


@contextlib.contextmanager
def gate_remat_default(enabled: bool) -> Iterator[None]:
    """Scope gate remat (:func:`gru_gates`) on or off for the code run
    inside, restoring the outer setting on exit. The S2VT train step runs its
    forward inside ``gate_remat_default(True)`` (``train/step.py``)."""
    token = _GATE_REMAT.set(enabled)
    try:
        yield
    finally:
        _GATE_REMAT.reset(token)


def _gru_gates(x_gates: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return _gru_update(x_gates, vdot(h, w_hh, compute_dtype) + b_hh, h)


def _gru_update(x_gates: torch.Tensor, h_gates: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    xr, xz, xn = x_gates.chunk(3, dim=-1)
    hr, hz, hn = h_gates.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_gates(x_gates: torch.Tensor, h: torch.Tensor, params,
              compute_dtype: torch.dtype = torch.bfloat16,
              h_gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU step given precomputed input gates x_gates = x @ w_ih + b_ih.

    r = σ(xr + hr); z = σ(xz + hz); n = tanh(xn + r∘hn); h' = (1-z)∘n + z∘h.
    Checkpointed inside a :func:`gate_remat_default` scope that is on; the
    step draws no random numbers, so the RNG state is not stashed.
    ``h_gates``: a precomputed h @ w_hh + b_hh (the int8-weight decode
    steppers' ``ops.wquant.gru_h_gates``), used as given (decode only).
    """
    if h_gates is not None:
        return _gru_update(x_gates, h_gates, h)
    if _GATE_REMAT.get():
        return torch.utils.checkpoint.checkpoint(
            _gru_gates, x_gates, h, params["w_hh"], params["b_hh"], compute_dtype,
            use_reentrant=False, preserve_rng_state=False)
    return _gru_gates(x_gates, h, params["w_hh"], params["b_hh"], compute_dtype)


def gru_step(params, x: torch.Tensor, h: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Single GRU step from raw input x (B, I)."""
    x_gates = vdot(x, params["w_ih"], compute_dtype) + params["b_ih"]
    return gru_gates(x_gates, h, params, compute_dtype)


def gru_scan(x_gates: torch.Tensor, params, h0: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The recurrence alone: x_gates (T, B, 3H) float32, h0 (B, H) float32
    -> outputs (T, B, H) float32, one :func:`gru_gates` per step."""
    h, outs = h0, []
    for xg in x_gates:
        h = gru_gates(xg, h, params, compute_dtype)
        outs.append(h)
    return torch.stack(outs)


def gru_sequence(params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU over xs (T, B, I) -> (outputs (T, B, H), h_last (B, H)).
    The input gates stay float32 here."""
    t, b, i = xs.shape
    hidden = params["w_hh"].shape[0]
    x_gates = (vdot(xs.reshape(t * b, i), params["w_ih"], compute_dtype)
               + params["b_ih"]).reshape(t, b, 3 * hidden)
    if h0 is None:
        h0 = torch.zeros((b, hidden), dtype=torch.float32, device=xs.device)
    outs = gru_scan(x_gates, params, h0, compute_dtype)
    return outs, outs[-1]


# ---------------- LSTM ----------------

def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int) -> dict:
    """Params for a single-layer LSTM, stored (in, 4H) / (H, 4H), gate order
    [i | f | g | o]."""
    return {
        "w_ih": vinit.rnn_mat_init(gen, input_size, 4 * hidden_size),
        "w_hh": vinit.rnn_mat_init(gen, hidden_size, 4 * hidden_size),
        "b_ih": vinit.const_bias(4 * hidden_size),
        "b_hh": vinit.const_bias(4 * hidden_size),
    }


def lstm_gates(x_gates: torch.Tensor, hc: Tuple[torch.Tensor, torch.Tensor],
               params, compute_dtype: torch.dtype = torch.bfloat16,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step given precomputed input gates x_gates = x @ w_ih + b_ih.

    i, f, o = σ(x + h·W_hh + b_hh); g = tanh(...); c' = f∘c + i∘g;
    h' = o∘tanh(c').
    """
    h, c = hc
    h_gates = vdot(h, params["w_hh"], compute_dtype) + params["b_hh"]
    xi, xf, xg, xo = x_gates.chunk(4, dim=-1)
    hi, hf, hg, ho = h_gates.chunk(4, dim=-1)
    i = torch.sigmoid(xi + hi)
    f = torch.sigmoid(xf + hf)
    g = torch.tanh(xg + hg)
    o = torch.sigmoid(xo + ho)
    c_next = f * c + i * g
    return o * torch.tanh(c_next), c_next


def lstm_scan(x_gates: torch.Tensor, params,
              hc0: Tuple[torch.Tensor, torch.Tensor],
              compute_dtype: torch.dtype = torch.bfloat16, reverse: bool = False,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The recurrence alone: x_gates (T, B, 4H) float32, hc0 two (B, H)
    float32 -> (outputs (T, B, H), (h_last, c_last)). ``reverse`` walks t
    from T-1 down to 0 and stores each step's h at its own time index, as
    ``lax.scan(reverse=True)`` does; the last state is then that of t=0."""
    hc, outs = hc0, [None] * x_gates.shape[0]
    order = range(x_gates.shape[0] - 1, -1, -1) if reverse else range(x_gates.shape[0])
    for t in order:
        hc = lstm_gates(x_gates[t], hc, params, compute_dtype)
        outs[t] = hc[0]
    return torch.stack(outs), hc


def lstm_sequence(params, xs: torch.Tensor,
                  hc0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  reverse: bool = False,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run an LSTM over xs (T, B, I) -> (outputs (T, B, H), (h_last, c_last)).
    The input gates stay float32 here."""
    t, b, i = xs.shape
    hidden = params["w_hh"].shape[0]
    x_gates = (vdot(xs.reshape(t * b, i), params["w_ih"], compute_dtype)
               + params["b_ih"]).reshape(t, b, 4 * hidden)
    if hc0 is None:
        zeros = torch.zeros((b, hidden), dtype=torch.float32, device=xs.device)
        hc0 = (zeros, zeros)
    return lstm_scan(x_gates, params, hc0, compute_dtype, reverse)


def bilstm_init(gen: torch.Generator, input_size: int, hidden_size: int) -> dict:
    """Bidirectional LSTM: one LSTM per direction."""
    return {"fwd": lstm_init(gen, input_size, hidden_size),
            "bwd": lstm_init(gen, input_size, hidden_size)}


def bilstm_sequence(params, xs: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xs (T, B, I) -> outputs (T, B, 2H): [forward ; backward], torch's
    bidirectional layout."""
    outs_f, _ = lstm_sequence(params["fwd"], xs, compute_dtype=compute_dtype)
    outs_b, _ = lstm_sequence(params["bwd"], xs, reverse=True,
                              compute_dtype=compute_dtype)
    return torch.cat([outs_f, outs_b], dim=-1)
