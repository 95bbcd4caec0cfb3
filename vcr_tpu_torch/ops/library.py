"""Kernels B1-B4 as ``torch.library`` custom ops.

Each kernel of ``ops/cuda_gru.py`` and ``ops/cuda_lstm.py`` is one op of
the ``vcr_tpu_torch`` namespace, so the dispatcher, and so ``torch.export``,
sees it as one opaque call:

* ``vcr_tpu_torch::gru_recurrence`` (B1, time-major),
* ``vcr_tpu_torch::gru_recurrence_bt`` (B3, batch-major),
* ``vcr_tpu_torch::gru_recurrence_dma`` (B4),
* ``vcr_tpu_torch::lstm_recurrence`` (B2, one direction a launch).

Each op has three implementations. On CUDA tensors it is the hand-written
kernel's launcher (``gru_recurrence_cuda`` etc.), with its checks, its
errors and its launch counters, so an exported program that runs on the
card counts its launches as the live call does. On CPU tensors it is the
kernel's plain version. Its fake implementation gives the output shapes and
dtypes, ``(T, B, H)`` float32 (``(B, T, H)`` for B3) and, for the LSTM,
``c_last (B, H)`` float32, without touching any data. On any other device
the op raises.

The ops are forward only. ``cuda_gru.GruSequence`` and
``cuda_lstm.LstmSequence`` call them inside their forward and take their
gradients from the plain recurrence; a backward through an op itself (B3 or
B4 on a tensor that requires a gradient) raises.

Beside them are four device-neutral product ops (``mm_f32``, ``bmm_f32``,
``conv2d_same``, ``conv2d_f32out``, below), which an exported program holds
in place of the models' bf16 products. Importing ``vcr_tpu_torch.ops``
registers all of them; a serving host that runs an exported program imports
this module and nothing of the models.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vcr_tpu_torch.ops import cuda_gru, cuda_lstm

NAMESPACE = "vcr_tpu_torch"


def _no_device(kind: str, x: torch.Tensor):
    raise ValueError(f"no {kind} recurrence for device {x.device}")


@torch.library.custom_op(f"{NAMESPACE}::gru_recurrence", mutates_args=())
def gru_recurrence(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """B1: x_gates (T, B, 3H) in the compute dtype, h0 (B, H) float32 ->
    outs (T, B, H) float32."""
    _no_device("GRU", x_gates)


@torch.library.custom_op(f"{NAMESPACE}::gru_recurrence_bt", mutates_args=())
def gru_recurrence_bt(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                      h0: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """B3: x_gates (B, T, 3H) -> outs (B, T, H) float32."""
    _no_device("GRU", x_gates)


@torch.library.custom_op(f"{NAMESPACE}::gru_recurrence_dma", mutates_args=())
def gru_recurrence_dma(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       h0: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """B4: B1's function, x_gates (T, B, 3H) -> outs (T, B, H) float32."""
    _no_device("GRU", x_gates)


@torch.library.custom_op(f"{NAMESPACE}::lstm_recurrence", mutates_args=())
def lstm_recurrence(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor, compute_dtype: torch.dtype,
                    reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: x_gates (T, B, 4H), h0 and c0 (B, H) float32 -> (outs (T, B, H),
    c_last (B, H)) float32, walking t backwards where ``reverse``."""
    _no_device("LSTM", x_gates)


gru_recurrence.register_kernel("cuda")(cuda_gru.gru_recurrence_cuda)
gru_recurrence.register_kernel("cpu")(cuda_gru.gru_recurrence_plain)
gru_recurrence_bt.register_kernel("cuda")(cuda_gru.gru_recurrence_bt_cuda)
gru_recurrence_bt.register_kernel("cpu")(cuda_gru.gru_recurrence_bt_plain)
gru_recurrence_dma.register_kernel("cuda")(cuda_gru.gru_recurrence_dma_cuda)
gru_recurrence_dma.register_kernel("cpu")(cuda_gru.gru_recurrence_plain)
lstm_recurrence.register_kernel("cuda")(cuda_lstm.lstm_recurrence_cuda)
lstm_recurrence.register_kernel("cpu")(cuda_lstm.lstm_recurrence_plain)


def _fake_time_major(x_gates, w_hh, b_hh, h0, compute_dtype):
    t, b, _ = x_gates.shape
    return x_gates.new_empty((t, b, w_hh.shape[0]), dtype=torch.float32)


@gru_recurrence_bt.register_fake
def _fake_batch_major(x_gates, w_hh, b_hh, h0, compute_dtype):
    b, t, _ = x_gates.shape
    return x_gates.new_empty((b, t, w_hh.shape[0]), dtype=torch.float32)


@lstm_recurrence.register_fake
def _fake_lstm(x_gates, w_hh, b_hh, h0, c0, compute_dtype, reverse):
    t, b, _ = x_gates.shape
    hidden = w_hh.shape[0]
    return (x_gates.new_empty((t, b, hidden), dtype=torch.float32),
            x_gates.new_empty((b, hidden), dtype=torch.float32))


gru_recurrence.register_fake(_fake_time_major)
gru_recurrence_dma.register_fake(_fake_time_major)


# ------------------------------------------------- device-neutral products
#
# The models pick the form of a bf16 product by the device of its operands
# (``nn.layers.vdot``, ``bmm_f32``, ``conv2d``, ``conv2d_f32``): cuBLAS or
# cuDNN with a float32 or bf16 output on the card, float32 products of the
# rounded operands on the CPU. ``torch.export`` would bake the tracing device's
# form into the program, so while it traces, those layers emit these ops
# instead, and the device picks the form when the program runs. They are
# called dozens of times a decode, so they are registered through the
# low-level ``Library`` API, which dispatches in a few microseconds.

_PRODUCTS = torch.library.Library(NAMESPACE, "FRAGMENT")
_PRODUCTS.define("mm_f32(Tensor x, Tensor w) -> Tensor")
_PRODUCTS.define("bmm_f32(Tensor a, Tensor b) -> Tensor")
_PRODUCTS.define("conv2d_same(Tensor x, Tensor w) -> Tensor")
_PRODUCTS.define("conv2d_f32out(Tensor x, Tensor w, int[] stride, int[] padding) -> Tensor")


def _mm_f32_cuda(x, w):
    return torch.mm(x.reshape(-1, x.shape[-1]), w,
                    out_dtype=torch.float32).reshape(*x.shape[:-1], w.shape[-1])


def _mm_f32_cpu(x, w):
    return x.float() @ w.float()


def _bmm_f32_cuda(a, b):
    y = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                  out_dtype=torch.float32)
    return y.reshape(*a.shape[:-2], *y.shape[-2:])


def _conv2d_same_cuda(x, w):
    return torch.nn.functional.conv2d(x, w, padding=(w.shape[2] // 2, w.shape[3] // 2))


def _conv2d_same_cpu(x, w):
    return _conv2d_same_cuda(x.float(), w.float()).to(x.dtype)


def _conv2d_f32out_cuda(x, w, stride, padding):
    """The backbones' bf16 conv on the card (``nn.layers.conv2d_f32``):
    cuDNN's bf16 output, up-cast."""
    return torch.nn.functional.conv2d(x, w, stride=stride, padding=padding).float()


def _conv2d_f32out_cpu(x, w, stride, padding):
    return torch.nn.functional.conv2d(x.float(), w.float(), stride=stride, padding=padding)


for _name, _cuda, _cpu in (("mm_f32", _mm_f32_cuda, _mm_f32_cpu),
                           ("bmm_f32", _bmm_f32_cuda, _mm_f32_cpu),
                           ("conv2d_same", _conv2d_same_cuda, _conv2d_same_cpu),
                           ("conv2d_f32out", _conv2d_f32out_cuda, _conv2d_f32out_cpu)):
    _PRODUCTS.impl(_name, _cuda, "CUDA")
    _PRODUCTS.impl(_name, _cpu, "CPU")


@torch.library.register_fake(f"{NAMESPACE}::mm_f32", lib=_PRODUCTS)
def _fake_mm_f32(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[-1]), dtype=torch.float32)


@torch.library.register_fake(f"{NAMESPACE}::bmm_f32", lib=_PRODUCTS)
def _fake_bmm_f32(a, b):
    return a.new_empty((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)


@torch.library.register_fake(f"{NAMESPACE}::conv2d_same", lib=_PRODUCTS)
def _fake_conv2d_same(x, w):
    return x.new_empty((x.shape[0], w.shape[0], *x.shape[2:]))


@torch.library.register_fake(f"{NAMESPACE}::conv2d_f32out", lib=_PRODUCTS)
def _fake_conv2d_f32out(x, w, stride, padding):
    size = [(n + 2 * p - k) // s + 1
            for n, k, s, p in zip(x.shape[2:], w.shape[2:], stride, padding)]
    return x.new_empty((x.shape[0], w.shape[0], *size), dtype=torch.float32)
