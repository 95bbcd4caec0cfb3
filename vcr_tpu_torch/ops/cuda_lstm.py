"""Fused LSTM sequence: the hand-written CUDA kernel and its plain version.

Counterpart of ``vcr_tpu/ops/pallas_gru.py::lstm_sequence_pallas`` and
``bilstm_sequence_pallas``. The input projection is one product outside the
kernel, and its result ``x_gates`` is rounded to the compute dtype as the TPU
path does; the kernel (``csrc/lstm_seq.cu``) then runs all T steps of the
recurrence, in either direction, with ``(h, c)`` kept on chip.

The kernel has two bodies, chosen by dtype and shape alone
(:func:`tc_takes`): bf16 at H % 128 == 0 up to H = 640 runs on the
tensor-core body, which holds W_hh in the shared memory of a 16-CTA cluster
(the design of B1's, ``ops/cuda_gru.py``), with the launch geometry of
:func:`tc_plan`; float32 and other bf16 shapes run on the scalar body.

A CUDA tensor launches the kernel or raises; the plain version
:func:`lstm_recurrence_plain` serves CPU tensors only. The raw launcher is
forward only; :func:`lstm_sequence_fused` (and so
:func:`bilstm_sequence_fused`) is differentiable on both devices through
:class:`LstmSequence`, the counterpart of ``_lstm_pallas_ad``, whose backward
recomputes the plain recurrence.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vcr_tpu_torch.nn.layers import vdot
from vcr_tpu_torch.nn.rnn import lstm_scan, lstm_sequence
from vcr_tpu_torch.ops import _build
from vcr_tpu_torch.ops.cuda_gru import (TC_CHUNK, TC_CLUSTER, TC_SMEM_LIMIT,
                                        cluster_split)

# kernel launches made by lstm_recurrence, for showing that a run went
# through the kernel; launches_tc counts those that ran the tensor-core body
launches = 0
launches_tc = 0


def lstm_recurrence_plain(x_gates: torch.Tensor, w_hh: torch.Tensor,
                          b_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                          compute_dtype: torch.dtype, reverse: bool = False,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: x_gates (T, B, 4H) in the
    compute dtype, h0 and c0 (B, H) float32 -> (outs (T, B, H), c_last (B, H))
    float32."""
    outs, (_, c_last) = lstm_scan(x_gates.float(), {"w_hh": w_hh, "b_hh": b_hh},
                                  (h0, c0), compute_dtype, reverse)
    return outs, c_last


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_seq")
    lib.lstm_seq_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                     + [ctypes.c_void_p])
    lib.lstm_seq_forward.restype = ctypes.c_int
    lib.lstm_seq_tc_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.lstm_seq_tc_forward.restype = ctypes.c_int
    lib.lstm_seq_tc_clusters.argtypes = [ctypes.c_int]
    lib.lstm_seq_tc_clusters.restype = ctypes.c_int
    lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.lstm_seq_error_string.restype = ctypes.c_char_p
    return lib


def tc_smem_bytes(hidden: int) -> int:
    """Shared memory of one CTA of the tensor-core body: its W_hh slice,
    H x 4H / TC_CLUSTER bf16 values (H*H/2 bytes)."""
    return hidden * 4 * (hidden // TC_CLUSTER) * 2


def tc_takes(hidden: int, compute_dtype: torch.dtype) -> bool:
    """Whether B2 runs the tensor-core body: bf16, each CTA's hidden units a
    whole number of 8-column mma tiles (H % 128 == 0), and its W_hh slice
    within a block's shared memory (H <= 640)."""
    return (compute_dtype == torch.bfloat16 and hidden >= 8 * TC_CLUSTER
            and hidden % (8 * TC_CLUSTER) == 0
            and tc_smem_bytes(hidden) <= TC_SMEM_LIMIT)


def tc_plan(batch: int, hidden: int, compute_dtype: torch.dtype,
            max_clusters: int) -> Optional[Tuple[int, int, int, int]]:
    """Launch geometry of the tensor-core body, or None where it does not
    apply (:func:`tc_takes`). Else (cluster, clusters, rows_per_cluster,
    chunk), the split of ``cuda_gru.cluster_split``."""
    if not tc_takes(hidden, compute_dtype):
        return None
    clusters, rows = cluster_split(batch, max_clusters,
                                   f"the tensor-core LSTM body at H={hidden}")
    return TC_CLUSTER, clusters, rows, TC_CHUNK


@functools.lru_cache(maxsize=None)
def _tc_max_clusters(device: int, hidden: int) -> int:
    lib = _lib()
    with torch.cuda.device(device):
        n = lib.lstm_seq_tc_clusters(hidden)
    if n < 0:
        raise RuntimeError("cluster occupancy query failed: "
                           + lib.lstm_seq_error_string(-n).decode())
    return n


def tc_max_clusters(hidden: int, device: Optional[torch.device] = None) -> int:
    """Clusters of the tensor-core body that the card holds at once, at this
    hidden size (cudaOccupancyMaxActiveClusters), queried once."""
    index = torch.device(device if device is not None else "cuda").index
    return _tc_max_clusters(torch.cuda.current_device() if index is None else index,
                            hidden)


def _check(x_gates, w_hh, b_hh, h0, c0, compute_dtype) -> Tuple[int, int, int]:
    """Raise on what neither body takes, on any device, and then on a tensor
    that is not on the card; return (T, B, H)."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    if x_gates.dim() != 3:
        raise ValueError(f"x_gates must be (T, B, 4H), got {tuple(x_gates.shape)}")
    t, b, h4 = x_gates.shape
    hidden = h4 // 4
    expected = {
        "x_gates": (x_gates, (t, b, 4 * hidden), compute_dtype),
        "w_hh": (w_hh, (hidden, 4 * hidden), compute_dtype),
        "b_hh": (b_hh, (4 * hidden,), torch.float32),
        "h0": (h0, (b, hidden), torch.float32),
        "c0": (c0, (b, hidden), torch.float32),
    }
    for name, (x, shape, dtype) in expected.items():
        if x.device != x_gates.device:
            raise ValueError(f"{name} must be on {x_gates.device}, got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if hidden % 4 or t < 1 or b < 1:
        raise ValueError(f"x_gates shape {tuple(x_gates.shape)}: need T, B >= 1 "
                         "and a hidden size that is a multiple of 4")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (x_gates, w_hh, b_hh, h0, c0)):
        raise NotImplementedError(
            "the CUDA LSTM kernel is forward only; lstm_sequence_fused is the "
            "differentiable entry: its backward recomputes the plain recurrence")
    if tc_takes(hidden, compute_dtype) and x_gates.data_ptr() % 4:
        raise ValueError("the lstm_seq kernel reads bf16 x_gates in pairs: it needs "
                         "x_gates on a 4-byte boundary")
    if not x_gates.is_cuda:
        raise ValueError(f"the lstm_seq kernel takes CUDA tensors, got {x_gates.device}")
    return t, b, hidden


def lstm_recurrence_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                         compute_dtype: torch.dtype, reverse: bool = False,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream, through the body that dtype
    and shape pick (:func:`tc_takes`); same contract as
    :func:`lstm_recurrence_plain`, on CUDA tensors."""
    global launches, launches_tc
    t, b, hidden = _check(x_gates, w_hh, b_hh, h0, c0, compute_dtype)
    lib = _lib()
    out = torch.empty((t, b, hidden), dtype=torch.float32, device=x_gates.device)
    c_last = torch.empty((b, hidden), dtype=torch.float32, device=x_gates.device)
    tc = tc_takes(hidden, compute_dtype)
    if tc:
        _, clusters, rows, _ = tc_plan(b, hidden, compute_dtype,
                                       tc_max_clusters(hidden, x_gates.device))
        # h rounded to bf16, double-buffered by step parity, in the kernel's
        # own order; c_last doubles as the running c
        hs = torch.empty((2, clusters * rows, hidden), dtype=torch.bfloat16,
                         device=x_gates.device)
    with torch.cuda.device(x_gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = lib.lstm_seq_tc_forward(
                x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                c0.data_ptr(), out.data_ptr(), c_last.data_ptr(), hs.data_ptr(), t, b,
                hidden, clusters, rows, int(reverse), stream)
        else:
            err = lib.lstm_seq_forward(
                x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                c0.data_ptr(), out.data_ptr(), c_last.data_ptr(), t, b, hidden,
                int(compute_dtype == torch.bfloat16), int(reverse), stream)
    if err != 0:
        raise RuntimeError("lstm_seq kernel launch failed: "
                           + lib.lstm_seq_error_string(err).decode())
    launches += 1
    launches_tc += int(tc)
    return out, c_last


def lstm_recurrence(x_gates, w_hh, b_hh, h0, c0, compute_dtype,
                    reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The custom op ``vcr_tpu_torch::lstm_recurrence`` (``ops/library.py``):
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x_gates.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no LSTM recurrence for device {x_gates.device}")
    return torch.ops.vcr_tpu_torch.lstm_recurrence(x_gates, w_hh, b_hh, h0, c0,
                                                   compute_dtype, reverse)


class LstmSequence(torch.autograd.Function):
    """B2's sequence in one direction, with a gradient: the counterpart of
    ``_lstm_pallas_ad`` (``vcr_tpu/ops/pallas_gru.py:359-425``).

    Forward: the input projection, the rounding of ``x_gates`` to the compute
    dtype and the recurrence (B2 on CUDA tensors, its plain version on CPU
    tensors) -> (outs, c_last), with ``(w_ih, b_ih, w_hh, b_hh, xs, h0, c0)``
    saved. Backward: :func:`vcr_tpu_torch.nn.rnn.lstm_sequence` rerun on the
    saved inputs under autograd, on float32 ``x_gates``, as
    ``_lstm_pallas_bwd`` does. An output that nothing used (often
    ``c_last``) brings no gradient.
    """

    @staticmethod
    def forward(ctx, w_ih, b_ih, w_hh, b_hh, xs, h0, c0, reverse, compute_dtype):
        ctx.set_materialize_grads(False)
        ctx.reverse, ctx.compute_dtype = reverse, compute_dtype
        ctx.save_for_backward(w_ih, b_ih, w_hh, b_hh, xs, h0, c0)
        t, b, i = xs.shape
        hidden = w_hh.shape[0]
        x_gates = (vdot(xs.reshape(t * b, i), w_ih, compute_dtype)
                   + b_ih).reshape(t, b, 4 * hidden).to(compute_dtype)
        return lstm_recurrence(x_gates, w_hh.to(compute_dtype).contiguous(),
                               b_hh.float().contiguous(), h0.float().contiguous(),
                               c0.float().contiguous(), compute_dtype, reverse)

    @staticmethod
    def backward(ctx, g_outs, g_c_last):
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            w_ih, b_ih, w_hh, b_hh, xs, h0, c0 = inputs = [
                x.detach().requires_grad_(need)
                for x, need in zip(ctx.saved_tensors, needs)]
            outs, (_, c_last) = lstm_sequence(
                {"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh}, xs, (h0, c0),
                ctx.reverse, ctx.compute_dtype)
            used = [(y, g) for y, g in ((outs, g_outs), (c_last, g_c_last))
                    if g is not None]
            grads = iter(torch.autograd.grad(
                [y for y, _ in used], [x for x, need in zip(inputs, needs) if need],
                [g for _, g in used]))
        return tuple(next(grads) if need else None for need in needs) + (None, None)


def lstm_sequence_fused(params, xs: torch.Tensor,
                        hc0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        reverse: bool = False,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """xs (T, B, I) -> (outputs (T, B, H), (h_last, c_last)), all float32,
    through kernel B2; differentiable (:class:`LstmSequence`). Reversed, the
    last state is that of t=0, so h_last is outputs[0]."""
    if hc0 is None:
        zeros = torch.zeros((xs.shape[1], params["w_hh"].shape[0]), dtype=torch.float32,
                            device=xs.device)
        hc0 = (zeros, zeros)
    outs, c_last = LstmSequence.apply(params["w_ih"], params["b_ih"], params["w_hh"],
                                      params["b_hh"], xs, hc0[0], hc0[1], reverse,
                                      compute_dtype)
    return outs, (outs[0] if reverse else outs[-1], c_last)


def bilstm_sequence_fused(params, xs: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xs (T, B, I) -> (T, B, 2H) float32, [forward ; backward]: one kernel
    launch per direction."""
    outs_f, _ = lstm_sequence_fused(params["fwd"], xs, compute_dtype=compute_dtype)
    outs_b, _ = lstm_sequence_fused(params["bwd"], xs, reverse=True,
                                    compute_dtype=compute_dtype)
    return torch.cat([outs_f, outs_b], dim=-1)
