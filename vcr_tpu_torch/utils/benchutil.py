"""Benchmark helpers: the card's peak rates, MFU, CUDA-event timing, FLOP and
gather-byte counts, bench rows, chunked host-to-card copies, and the
least-time bounds of the kernels and the backbones.

Counterpart of ``vcr_tpu/utils/benchutil.py``. MFU (model FLOPs utilisation)
is the products' FLOPs over the wall time over the card's peak bf16 rate.
The FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which
counts the aten products (matrix products and convolutions) of one call.
It sees a custom op as one opaque call, so importing this module registers
a FLOP formula for each of the eight ops of ``ops/library.py`` (and lets
torch's bmm formula count ``torch.bmm(..., out_dtype=)``, which it cannot):

* ``gru_recurrence``, ``gru_recurrence_bt``, ``gru_recurrence_dma`` (B1,
  B3, B4): T steps of ``h @ W_hh``, T * 2 * B * H * 3H;
* ``lstm_recurrence`` (B2): T * 2 * B * H * 4H;
* ``mm_f32``, ``bmm_f32``, ``conv2d_same``, ``conv2d_f32out``: the aten
  product each stands for.

The count of a call is then the same on the card, where the recurrence ops
launch B1-B4, as on the CPU, where they run their plain versions, and the
same again in an exported program, which holds the product ops. As in the
JAX package, only products count: the gate math, softmax and gathers ride
along.

Nothing here reads the environment: the JAX module's ``VCR_BENCH_TAG`` is
``emit_row``'s ``tag`` and ``VCR_UPLOAD_CHUNK_MB`` is ``chunked_to``'s
``limit_mb``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import (FlopCounterMode, conv_flop_count, flop_registry,
                                      register_flop_formula)

from vcr_tpu_torch.ops import library  # noqa: F401  (registers the ops)

# Published dense peaks per card, by torch.cuda.get_device_name (NVIDIA H100
# SXM data sheet, at its 700 W limit): bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, device-memory (HBM3) bytes/s.
CARD_PEAKS: Dict[str, Tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def emit_row(row: dict, tag: Optional[str] = None) -> None:
    """Print one bench JSON line. ``tag`` marks a variant's row: its metric
    becomes ``"<metric> [<tag>]"``, so a report keyed on the metric keeps the
    variant beside the product row instead of replacing it."""
    if tag and "metric" in row:
        row = {**row, "metric": f'{row["metric"]} [{tag}]'}
    print(json.dumps(row), flush=True)


# ------------------------------------------------------------ peaks and MFU

def card_peaks(device) -> Optional[Tuple[float, float, float]]:
    """(bf16 FLOP/s, float32 FLOP/s, bytes/s) of ``device``'s card, or None
    for the CPU and for a card the table does not hold."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return CARD_PEAKS.get(torch.cuda.get_device_name(device))


def peak_bf16_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device``'s card, or None (the CPU, or a
    card the table does not hold)."""
    peaks = card_peaks(device)
    return None if peaks is None else peaks[0]


def mfu(flops_total: Optional[float], seconds: float, device) -> Optional[float]:
    """flops_total / seconds as a fraction of the card's peak bf16 rate; None
    where the count or the peak is unknown."""
    peak = peak_bf16_flops(device)
    if flops_total is None or peak is None or seconds <= 0:
        return None
    return flops_total / seconds / peak


# ------------------------------------------------------------------- timing

def require_card(device) -> torch.device:
    """``device`` as a ``torch.device`` if it is a CUDA device and a card is
    there; RuntimeError otherwise: a CPU time is not a device measurement."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"timing needs a CUDA device, not {device}: a CPU time "
                           "is not a device measurement")
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device, and no CUDA device is available")
    return device


def time_ms(fn: Callable, iters: int = 1, reps: int = 3) -> float:
    """Best of ``reps`` runs of ``iters`` calls, in ms per call, by CUDA
    events, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def median_best_ms(fn: Callable) -> Tuple[float, float]:
    """(best, median) ms of 3 calls by CUDA events, after the warm-up of the
    first."""
    runs = sorted(time_ms(fn, reps=1) for _ in range(3))
    return runs[0], runs[1]


def time_chained(run_n: Callable, args: tuple, device, reps: int = 3,
                 count: Optional[int] = None) -> dict:
    """Time ``run_n(*args)`` on the card: one warm-up call, then ``reps``
    calls, each between two CUDA events, and one synchronise at the end.

    -> {"best_s", "median_s", "flops", "mfu", "loadavg", "launches"}: the
    best and median seconds of a call, the products of one call (``count``
    where the caller has them, else :func:`flops` of one more call), the MFU
    of the best call, the host's 1/5/15-minute load averages at the end,
    since readings that the host paces move with its load, and the kernel
    launches of the best call (:func:`kernel_launches` read before and after
    it: a wrapper counts on the host as it launches)."""
    device = require_card(device)
    run_n(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    launches = []
    for start, end in events:
        before = kernel_launches()
        start.record()
        run_n(*args)
        end.record()
        launches.append({k: v - before[k] for k, v in kernel_launches().items()})
    torch.cuda.synchronize(device)
    secs = [start.elapsed_time(end) / 1e3 for start, end in events]
    best = min(range(reps), key=secs.__getitem__)
    if count is None:
        count = flops(run_n, *args)
    return {"best_s": secs[best], "median_s": sorted(secs)[reps // 2], "flops": count,
            "mfu": mfu(count, secs[best], device), "loadavg": list(os.getloadavg()),
            "launches": launches[best]}


# --------------------------------------------------------------- the counts

def kernel_launches() -> Dict[str, int]:
    """The launch counters of B1-B4 (``ops.cuda_gru``, ``ops.cuda_lstm``) and
    of the beam's word pick (``ops.beam_pick``): each wrapper adds one where
    it launches its kernel, on the card only."""
    from vcr_tpu_torch.ops import beam_pick, cuda_gru, cuda_lstm

    return {"gru_seq": cuda_gru.launches, "gru_seq_tc": cuda_gru.launches_tc,
            "gru_seq_bt": cuda_gru.launches_bt, "gru_seq_dma": cuda_gru.launches_dma,
            "lstm_seq": cuda_lstm.launches, "lstm_seq_tc": cuda_lstm.launches_tc,
            "beam_pick": beam_pick.launches}


def flops(fn: Callable, *args, **kwargs) -> int:
    """The products' FLOPs of one call ``fn(*args, **kwargs)``, by
    FlopCounterMode with the custom ops' formulas of this module."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


_GATHERS = ("index_select", "gather", "take_along_dim", "index", "embedding")


class _GatherBytes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket.__name__ in _GATHERS and isinstance(out, torch.Tensor):
            self.total += out.numel() * out.element_size()
        return out


def gather_bytes(fn: Callable, *args, **kwargs) -> int:
    """Bytes produced by the gathers of one call (``index_select``,
    ``gather``, ``take_along_dim``, ``embedding`` and advanced indexing).
    Each gathered byte is also a byte read from the source, so the memory
    traffic of a gather is about twice this: a beam's physical reorder is one
    row gather per state tensor per step."""
    with _GatherBytes() as mode:
        fn(*args, **kwargs)
    return mode.total


def _recurrence_flops(gates: int, batch_major: bool = False):
    def formula(x_shape, w_shape, *args, out_shape=None, **kwargs):
        t, b = (x_shape[1], x_shape[0]) if batch_major else (x_shape[0], x_shape[1])
        hidden = w_shape[0]
        return t * 2 * b * hidden * gates * hidden
    return formula


def _mm_f32_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return 2 * int(np.prod(x_shape[:-1])) * x_shape[-1] * w_shape[-1]


def _bmm_f32_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return 2 * int(np.prod(a_shape[:-1])) * a_shape[-1] * b_shape[-1]


def _conv_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return conv_flop_count(list(x_shape), list(w_shape), list(out_shape))


def _drop_out_dtype(formula):
    """torch's bmm formula reads the ``.dtype`` overload's ``out_dtype`` (the
    card's float32-output product, ``nn.layers.bmm_f32``) as its output shape
    and raises; the count drops it."""
    def count(a, b, *_out_dtype, **kwargs):
        return formula(a, b, **kwargs)
    count.drops_out_dtype = True
    return count


def _register_formulas() -> None:
    bmm = torch.ops.aten.bmm
    if not getattr(flop_registry[bmm], "drops_out_dtype", False):
        flop_registry[bmm] = _drop_out_dtype(flop_registry[bmm])
    ops = torch.ops.vcr_tpu_torch
    for op, formula in ((ops.gru_recurrence, _recurrence_flops(3)),
                        (ops.gru_recurrence_dma, _recurrence_flops(3)),
                        (ops.gru_recurrence_bt, _recurrence_flops(3, batch_major=True)),
                        (ops.lstm_recurrence, _recurrence_flops(4)),
                        (ops.mm_f32, _mm_f32_flops), (ops.bmm_f32, _bmm_f32_flops),
                        (ops.conv2d_same, _conv_flops), (ops.conv2d_f32out, _conv_flops)):
        if op not in flop_registry:  # the registry is torch's, process-wide
            register_flop_formula(op)(formula)


_register_formulas()


# ------------------------------------------------------------------ copies

def chunked_to(tensor, device, limit_mb: Optional[float] = None) -> torch.Tensor:
    """``tensor`` (a tensor or an array) on ``device``, copied in row slices
    of at most ``limit_mb`` MB each; None or 0 copies it in one piece, and so
    does a 0-d tensor. The result is the same tensor either way."""
    src = torch.as_tensor(tensor)
    nbytes = src.numel() * src.element_size()
    if not limit_mb or src.dim() == 0 or nbytes <= limit_mb * 1e6:
        return src.to(device)
    row = max(src[:1].numel() * src.element_size(), 1)
    rows_per = max(1, int(limit_mb * 1e6 // row))
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    for i in range(0, src.shape[0], rows_per):
        out[i:i + rows_per].copy_(src[i:i + rows_per])
    return out


# ------------------------------------------------------------------ bounds
#
# The least time a call could take on a card with ``peaks`` (CARD_PEAKS):
# the larger of its bytes (each input read once, each output written once)
# over the memory rate and its operations over the peak rate of their type.
# Each returns (ms, "bytes" or "operations").

def _bound(ops_s: float, bytes_s: float) -> Tuple[float, str]:
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def gru_bound_ms(t: int, b: int, hidden: int, peaks) -> Tuple[float, str]:
    """One B1 call in bf16: x_gates, W_hh, b_hh and h0 read and the float32
    outputs written once, or the recurrent product at the bf16 tensor-core
    rate plus the gate math (14 float32 operations per hidden element) at
    the float32 rate."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 3 * hidden * 2 + hidden * 3 * hidden * 2 + 3 * hidden * 4
              + b * hidden * 4 + t * b * hidden * 4)
    ops_s = 2 * t * b * hidden * 3 * hidden / bf16_rate + 14 * t * b * hidden / f32_rate
    return _bound(ops_s, nbytes / mem_rate)


def lstm_bound_ms(t: int, b: int, hidden: int, peaks) -> Tuple[float, str]:
    """One B2 call (one direction) in bf16: its inputs read and outputs
    written once, or the recurrent product at the bf16 tensor-core rate plus
    the gate math (23 float32 operations per hidden element: 8 adds, 3
    sigmoids at 3, 2 tanh at 1, 4 for the c and h updates) at the float32
    rate."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 4 * hidden * 2 + hidden * 4 * hidden * 2 + 4 * hidden * 4
              + 2 * b * hidden * 4 + t * b * hidden * 4 + b * hidden * 4)
    ops_s = 2 * t * b * hidden * 4 * hidden / bf16_rate + 23 * t * b * hidden / f32_rate
    return _bound(ops_s, nbytes / mem_rate)


def conv_bound_ms(frames: int, f: int, hidden: int, k: int, peaks) -> Tuple[float, str]:
    """SpatialNet's conv trunk in bf16: its two 3x3 convs' products at the
    bf16 tensor-core rate (BatchNorm and ReLU left out), or the float32
    input read and the trunk's float32 output written once."""
    bf16_rate, _, mem_rate = peaks
    cells = frames * k * k
    ops_s = 2 * cells * hidden * 9 * (f + hidden) / bf16_rate
    return _bound(ops_s, (cells * f * 4 + cells * hidden * 4) / mem_rate)


def backbone_bound_ms(flops_total: float, in_bytes: int, out_bytes: int,
                      peaks) -> Tuple[float, str]:
    """A backbone call in bf16: its products (:func:`flops`) at the bf16
    tensor-core rate (BatchNorm, bias, activation and pools left out), or its
    frames and weights read and its features written once."""
    bf16_rate, _, mem_rate = peaks
    return _bound(flops_total / bf16_rate, (in_bytes + out_bytes) / mem_rate)

