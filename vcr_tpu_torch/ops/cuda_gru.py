"""Fused GRU sequences: the hand-written CUDA kernels and their plain version.

Three drop-ins, one per kernel of ``vcr_tpu/ops/pallas_gru.py``, all
computing one function:

* :func:`gru_sequence_fused`, counterpart of ``gru_sequence_pallas``
  (kernel B1, time-major, ``csrc/gru_seq.cu``): the captioners' path;
* :func:`gru_sequence_fused_bt`, counterpart of ``gru_sequence_pallas_bt``
  (kernel B3, the same source in its batch-major form): (B, T, I) in,
  (B, T, H) out, with no transpose;
* :func:`gru_sequence_fused_dma`, counterpart of ``gru_sequence_pallas_dma``
  (kernel B4, ``csrc/gru_seq_dma.cu``): B1's function, with ``x_gates``
  copied ahead and outputs copied back by TMA copies on ``mbarrier``s.

Each does the input projection as one product outside the kernel and rounds
its result ``x_gates`` to the compute dtype as the TPU path does; the kernel
then runs all T steps of the recurrence with the hidden state kept on chip.

B1 and B3 have two bodies in ``csrc/gru_seq.cu``, chosen by dtype and shape
alone (:func:`tc_takes`): bf16 at H % 128 == 0 (up to H = 768) runs on the
tensor-core body, which holds W_hh in the shared memory of a 16-CTA cluster,
with the launch geometry of :func:`tc_plan`; float32 and other bf16 shapes
run on the scalar body. B4 has two bodies in ``csrc/gru_seq_dma.cu``,
chosen the same way (:func:`dma_tc_plan`): bf16 at H % 128 == 0 whose shared
memory budget fits runs on a tensor-core body of the same cluster design,
with a copy ring per warp; everything else on the scalar body.

A CUDA tensor launches the kernel or raises; the plain versions serve CPU
tensors only. :func:`gru_sequence_fused` is differentiable on both devices,
through :class:`GruSequence`, the counterpart of ``_gru_pallas_ad``: its
backward is not a kernel but the JAX package's, the gradient of the plain
recurrence recomputed from the saved inputs. The raw launchers and the B3
and B4 drop-ins are forward only, as ``gru_sequence_pallas_bt`` and
``gru_sequence_pallas_dma`` are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vcr_tpu_torch.nn.layers import vdot
from vcr_tpu_torch.nn.rnn import gru_scan, gru_sequence
from vcr_tpu_torch.ops import _build

# kernel launches made by gru_recurrence (B1), gru_recurrence_bt (B3) and
# gru_recurrence_dma (B4), for showing that a run went through each kernel;
# launches_tc counts the B1 and B3 launches that ran the tensor-core body,
# launches_dma_tc the B4 launches that ran B4's
launches = 0
launches_bt = 0
launches_dma = 0
launches_tc = 0
launches_dma_tc = 0

# The tensor-core bodies of B1 and B3 (and of B2, ops/cuda_lstm.py):
# clusters of TC_CLUSTER CTAs, each CTA holding the W_hh columns of
# H / TC_CLUSTER hidden units in shared memory, each warp computing TC_CHUNK
# batch rows at a time. TC_SMEM_LIMIT is the shared memory a block may opt
# into on sm_90.
TC_CLUSTER = 16
TC_CHUNK = 16
TC_SMEM_LIMIT = 232448
# B4's tensor-core body (csrc/gru_seq_dma.cu, dma_tc::kWarps and kSlots):
# warps per CTA at one CTA per SM, and x_gates copy slots in each warp's ring
DMA_TC_WARPS = 10
DMA_TC_SLOTS = 2


def gru_recurrence_plain(x_gates: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, h0: torch.Tensor,
                         compute_dtype: torch.dtype) -> torch.Tensor:
    """The function of kernels B1 and B4 in plain PyTorch: x_gates (T, B, 3H)
    in the compute dtype, h0 (B, H) float32 -> outs (T, B, H) float32."""
    return gru_scan(x_gates.float(), {"w_hh": w_hh, "b_hh": b_hh}, h0,
                    compute_dtype)


def gru_recurrence_bt_plain(x_gates: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, h0: torch.Tensor,
                            compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel B3's function in plain PyTorch: x_gates (B, T, 3H) -> outs
    (B, T, H) float32, contiguous as the kernel writes them."""
    return gru_recurrence_plain(x_gates.transpose(0, 1), w_hh, b_hh, h0,
                                compute_dtype).transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_seq")
    for fn in (lib.gru_seq_forward, lib.gru_seq_bt_forward):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gru_seq_tc_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.gru_seq_tc_forward.restype = ctypes.c_int
    lib.gru_seq_tc_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gru_seq_tc_clusters.restype = ctypes.c_int
    lib.gru_seq_error_string.argtypes = [ctypes.c_int]
    lib.gru_seq_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _dma_lib() -> ctypes.CDLL:
    lib = _build.load("gru_seq_dma")
    lib.gru_seq_dma_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
    lib.gru_seq_dma_forward.restype = ctypes.c_int
    lib.gru_seq_dma_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gru_seq_dma_rows.restype = ctypes.c_int
    lib.gru_seq_dma_tc_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
    lib.gru_seq_dma_tc_forward.restype = ctypes.c_int
    lib.gru_seq_dma_tc_clusters.argtypes = [ctypes.c_int]
    lib.gru_seq_dma_tc_clusters.restype = ctypes.c_int
    lib.gru_seq_dma_error_string.argtypes = [ctypes.c_int]
    lib.gru_seq_dma_error_string.restype = ctypes.c_char_p
    return lib


def tc_smem_bytes(hidden: int) -> int:
    """Shared memory of one CTA of the tensor-core body: its W_hh slice,
    H x 3H / TC_CLUSTER bf16 values."""
    return hidden * 3 * (hidden // TC_CLUSTER) * 2


def tc_takes(hidden: int, compute_dtype: torch.dtype) -> bool:
    """Whether B1 and B3 run the tensor-core body: bf16, each CTA's hidden
    units a whole number of 8-column mma tiles (H % 128 == 0), and its W_hh
    slice within a block's shared memory (H <= 768)."""
    return (compute_dtype == torch.bfloat16 and hidden >= 8 * TC_CLUSTER
            and hidden % (8 * TC_CLUSTER) == 0
            and tc_smem_bytes(hidden) <= TC_SMEM_LIMIT)


def cluster_split(batch: int, max_clusters: int, body: str) -> Tuple[int, int]:
    """The batch cut into ``clusters`` <= ``max_clusters`` contiguous runs of
    ``rows`` rows each (a multiple of TC_CHUNK; the last run may reach past
    the batch), one per cluster of a tensor-core body: (clusters, rows).
    Raises where the card holds no cluster of ``body``."""
    if max_clusters < 1:
        raise ValueError(f"the card holds no cluster of {TC_CLUSTER} CTAs of {body}")
    rows = -(-batch // max_clusters)
    rows = -(-rows // TC_CHUNK) * TC_CHUNK
    return -(-batch // rows), rows


def tc_plan(batch: int, hidden: int, compute_dtype: torch.dtype,
            max_clusters: int) -> Optional[Tuple[int, int, int, int]]:
    """Launch geometry of the tensor-core body, or None where it does not
    apply (:func:`tc_takes`). Else (cluster, clusters, rows_per_cluster,
    chunk), from :func:`cluster_split`."""
    if not tc_takes(hidden, compute_dtype):
        return None
    clusters, rows = cluster_split(batch, max_clusters,
                                   f"the tensor-core GRU body at H={hidden}")
    return TC_CLUSTER, clusters, rows, TC_CHUNK


@functools.lru_cache(maxsize=None)
def _tc_max_clusters(device: int, hidden: int, time_major: bool) -> int:
    lib = _lib()
    with torch.cuda.device(device):
        n = lib.gru_seq_tc_clusters(hidden, int(time_major))
    if n < 0:
        raise RuntimeError("cluster occupancy query failed: "
                           + lib.gru_seq_error_string(-n).decode())
    return n


def tc_max_clusters(hidden: int, time_major: bool = True,
                    device: Optional[torch.device] = None) -> int:
    """Clusters of the tensor-core body that the card holds at once, at this
    hidden size and layout (cudaOccupancyMaxActiveClusters), queried once."""
    index = torch.device(device if device is not None else "cuda").index
    return _tc_max_clusters(torch.cuda.current_device() if index is None else index,
                            hidden, time_major)


def dma_tc_smem_bytes(hidden: int, chunks: int, warps: int = DMA_TC_WARPS,
                      slots: int = DMA_TC_SLOTS) -> int:
    """Shared memory of one CTA of B4's tensor-core body with ``chunks``
    16-row chunks: its W_hh slice (:func:`tc_smem_bytes`), one float32 h/out
    tile per chunk, and each warp's ring of ``slots`` x_gates slots (16 rows
    x 3 gates x H/16 units, bf16) with an mbarrier each."""
    units = hidden // TC_CLUSTER
    return (tc_smem_bytes(hidden) + chunks * TC_CHUNK * units * 4
            + warps * slots * (TC_CHUNK * 3 * units * 2 + 8))


def dma_tc_takes(hidden: int, compute_dtype: torch.dtype, warps: int = DMA_TC_WARPS,
                 slots: int = DMA_TC_SLOTS) -> bool:
    """Whether B4's tensor-core body applies at this width at all: bf16, H %
    128 == 0, and one chunk a CTA within the shared-memory budget (H <= 512
    with 10 warps of 2 slots; the larger slices leave too little room)."""
    return (compute_dtype == torch.bfloat16 and hidden >= 8 * TC_CLUSTER
            and hidden % (8 * TC_CLUSTER) == 0
            and dma_tc_smem_bytes(hidden, 1, warps, slots) <= TC_SMEM_LIMIT)


def dma_tc_plan(batch: int, hidden: int, compute_dtype: torch.dtype, max_clusters: int,
                warps: int = DMA_TC_WARPS, slots: int = DMA_TC_SLOTS,
                ) -> Optional[Tuple[int, int, int, int, int, int]]:
    """Launch geometry of B4's tensor-core body, or None where it does not
    apply: not :func:`dma_tc_takes`, or a batch whose chunks per CTA do not
    fit the shared-memory budget (beyond ~3,900 rows at 7 clusters, H=512).
    Else (cluster, clusters, rows_per_cluster, chunk, warps, slots), the
    rows from :func:`cluster_split`."""
    if not dma_tc_takes(hidden, compute_dtype, warps, slots):
        return None
    clusters, rows = cluster_split(batch, max_clusters,
                                   f"B4's tensor-core GRU body at H={hidden}")
    if dma_tc_smem_bytes(hidden, rows // TC_CHUNK, warps, slots) > TC_SMEM_LIMIT:
        return None
    return TC_CLUSTER, clusters, rows, TC_CHUNK, warps, slots


@functools.lru_cache(maxsize=None)
def _dma_tc_max_clusters(device: int, hidden: int) -> int:
    lib = _dma_lib()
    with torch.cuda.device(device):
        n = lib.gru_seq_dma_tc_clusters(hidden)
    if n < 0:
        raise RuntimeError("cluster occupancy query failed: "
                           + lib.gru_seq_dma_error_string(-n).decode())
    return n


def dma_tc_max_clusters(hidden: int, device: Optional[torch.device] = None) -> int:
    """Clusters of B4's tensor-core body that the card holds at once at this
    hidden size, one CTA per SM (cudaOccupancyMaxActiveClusters), queried
    once."""
    index = torch.device(device if device is not None else "cuda").index
    return _dma_tc_max_clusters(torch.cuda.current_device() if index is None else index,
                                hidden)


def dma_batch_tile(hidden: int, compute_dtype: torch.dtype) -> int:
    """Batch rows per block of B4's scalar body on the current card: the
    largest of 16, 8, 4, 2, 1 whose buffers fit a block's shared memory."""
    return _dma_lib().gru_seq_dma_rows(hidden, int(compute_dtype == torch.bfloat16))


def _check(kernel: str, x_gates, w_hh, b_hh, h0, compute_dtype, batch_major: bool,
           hidden_multiple: int, no_grad_reason: str, align: int = 1,
           ) -> Tuple[int, int, int]:
    """Raise on what ``kernel`` cannot take, ``x_gates`` off an ``align``-byte
    boundary included, before the device check; return (T, B, H)."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    layout = "(B, T, 3H)" if batch_major else "(T, B, 3H)"
    if x_gates.dim() != 3:
        raise ValueError(f"x_gates must be {layout}, got {tuple(x_gates.shape)}")
    if batch_major:
        b, t, h3 = x_gates.shape
    else:
        t, b, h3 = x_gates.shape
    hidden = h3 // 3
    expected = {
        "x_gates": (x_gates, tuple(x_gates.shape[:2]) + (3 * hidden,), compute_dtype),
        "w_hh": (w_hh, (hidden, 3 * hidden), compute_dtype),
        "b_hh": (b_hh, (3 * hidden,), torch.float32),
        "h0": (h0, (b, hidden), torch.float32),
    }
    for name, (x, shape, dtype) in expected.items():
        if x.device != x_gates.device:
            raise ValueError(f"{name} must be on {x_gates.device}, got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if hidden % hidden_multiple or t < 1 or b < 1:
        raise ValueError(f"x_gates shape {tuple(x_gates.shape)}: need T, B >= 1 and "
                         f"a hidden size that is a multiple of {hidden_multiple}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (x_gates, w_hh, b_hh, h0)):
        raise NotImplementedError(f"the CUDA {kernel} kernel is forward only; "
                                  + no_grad_reason)
    if x_gates.data_ptr() % align:
        raise ValueError(f"the {kernel} kernel needs x_gates on a {align}-byte boundary")
    if not x_gates.is_cuda:
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {x_gates.device}")
    return t, b, hidden


def _launch(fn, error_string, kernel: str, x_gates, w_hh, b_hh, h0, out, t, b, hidden,
            compute_dtype) -> None:
    with torch.cuda.device(x_gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                 out.data_ptr(), t, b, hidden, int(compute_dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           + error_string(err).decode())


def _launch_b1_b3(kernel: str, x_gates, w_hh, b_hh, h0, out, t, b, hidden,
                  compute_dtype, time_major: bool) -> None:
    """Launch B1 (time-major) or B3 through the body that dtype and shape
    pick (:func:`tc_takes`)."""
    global launches_tc
    lib = _lib()
    if not tc_takes(hidden, compute_dtype):
        _launch(lib.gru_seq_forward if time_major else lib.gru_seq_bt_forward,
                lib.gru_seq_error_string, kernel, x_gates, w_hh, b_hh, h0, out, t, b,
                hidden, compute_dtype)
        return
    if x_gates.data_ptr() % 4:
        raise ValueError(f"the {kernel} kernel reads bf16 x_gates in pairs: it needs "
                         "x_gates on a 4-byte boundary")
    _, clusters, rows, _ = tc_plan(b, hidden, compute_dtype,
                                   tc_max_clusters(hidden, time_major, x_gates.device))
    # h rounded to bf16, double-buffered by step parity, in the kernel's own order
    hs = torch.empty((2, clusters * rows, hidden), dtype=torch.bfloat16,
                     device=x_gates.device)
    with torch.cuda.device(x_gates.device):
        err = lib.gru_seq_tc_forward(
            x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            out.data_ptr(), hs.data_ptr(), t, b, hidden, clusters, rows,
            int(time_major), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           + lib.gru_seq_error_string(err).decode())
    launches_tc += 1


_B1_NO_GRAD = ("gru_sequence_fused is the differentiable entry: its backward "
               "recomputes the plain recurrence")
_DROP_IN_NO_GRAD = ("the JAX package's gru_sequence_pallas_bt and "
                    "gru_sequence_pallas_dma have no gradient either")


def gru_recurrence_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor,
                        b_hh: torch.Tensor, h0: torch.Tensor,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """Launch kernel B1 on the current stream; same contract as
    :func:`gru_recurrence_plain`, on CUDA tensors."""
    global launches
    t, b, hidden = _check("gru_seq", x_gates, w_hh, b_hh, h0, compute_dtype,
                          batch_major=False, hidden_multiple=4,
                          no_grad_reason=_B1_NO_GRAD)
    out = torch.empty((t, b, hidden), dtype=torch.float32, device=x_gates.device)
    _launch_b1_b3("gru_seq", x_gates, w_hh, b_hh, h0, out, t, b, hidden, compute_dtype,
                  time_major=True)
    launches += 1
    return out


def gru_recurrence_bt_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor,
                           b_hh: torch.Tensor, h0: torch.Tensor,
                           compute_dtype: torch.dtype) -> torch.Tensor:
    """Launch kernel B3 on the current stream; same contract as
    :func:`gru_recurrence_bt_plain`, on CUDA tensors."""
    global launches_bt
    t, b, hidden = _check("gru_seq_bt", x_gates, w_hh, b_hh, h0, compute_dtype,
                          batch_major=True, hidden_multiple=4,
                          no_grad_reason=_DROP_IN_NO_GRAD)
    out = torch.empty((b, t, hidden), dtype=torch.float32, device=x_gates.device)
    _launch_b1_b3("gru_seq_bt", x_gates, w_hh, b_hh, h0, out, t, b, hidden,
                  compute_dtype, time_major=False)
    launches_bt += 1
    return out


def gru_recurrence_dma_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, h0: torch.Tensor,
                            compute_dtype: torch.dtype) -> torch.Tensor:
    """Launch kernel B4 on the current stream, through the body that dtype
    and shape pick (:func:`dma_tc_plan`). Its plain version is
    :func:`gru_recurrence_plain`: B4 computes B1's function. Its copies need
    16-byte rows, so the hidden size must be a multiple of 8 and x_gates on
    a 16-byte boundary (``out`` is allocated here, on one)."""
    global launches_dma, launches_dma_tc
    t, b, hidden = _check("gru_seq_dma", x_gates, w_hh, b_hh, h0, compute_dtype,
                          batch_major=False, hidden_multiple=8,
                          no_grad_reason=_DROP_IN_NO_GRAD, align=16)
    lib = _dma_lib()
    out = torch.empty((t, b, hidden), dtype=torch.float32, device=x_gates.device)
    # the card's cluster occupancy is asked only where the body may apply
    plan = (dma_tc_plan(b, hidden, compute_dtype,
                        dma_tc_max_clusters(hidden, x_gates.device))
            if dma_tc_takes(hidden, compute_dtype) else None)
    if plan is None:
        _launch(lib.gru_seq_dma_forward, lib.gru_seq_dma_error_string, "gru_seq_dma",
                x_gates, w_hh, b_hh, h0, out, t, b, hidden, compute_dtype)
    else:
        _, clusters, rows, _, warps, slots = plan
        # h rounded to bf16, double-buffered by step parity, in the kernel's order
        hs = torch.empty((2, clusters * rows, hidden), dtype=torch.bfloat16,
                         device=x_gates.device)
        with torch.cuda.device(x_gates.device):
            err = lib.gru_seq_dma_tc_forward(
                x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                out.data_ptr(), hs.data_ptr(), t, b, hidden, clusters, rows, warps,
                slots, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("gru_seq_dma kernel launch failed: "
                               + lib.gru_seq_dma_error_string(err).decode())
        launches_dma_tc += 1
    launches_dma += 1
    return out


def _dispatch(op_name: str, x_gates, *args) -> torch.Tensor:
    """The custom op ``vcr_tpu_torch::<op_name>`` (``ops/library.py``): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if x_gates.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no GRU recurrence for device {x_gates.device}")
    return getattr(torch.ops.vcr_tpu_torch, op_name)(x_gates, *args)


def gru_recurrence(x_gates, w_hh, b_hh, h0, compute_dtype) -> torch.Tensor:
    """B1 on CUDA tensors, the plain version on CPU tensors."""
    return _dispatch("gru_recurrence", x_gates, w_hh, b_hh, h0, compute_dtype)


def gru_recurrence_bt(x_gates, w_hh, b_hh, h0, compute_dtype) -> torch.Tensor:
    """B3 on CUDA tensors, the plain version on CPU tensors."""
    return _dispatch("gru_recurrence_bt", x_gates, w_hh, b_hh, h0, compute_dtype)


def gru_recurrence_dma(x_gates, w_hh, b_hh, h0, compute_dtype) -> torch.Tensor:
    """B4 on CUDA tensors, the plain version on CPU tensors."""
    return _dispatch("gru_recurrence_dma", x_gates, w_hh, b_hh, h0, compute_dtype)


def _run(recurrence, params, xs, h0, batch, compute_dtype):
    """Project xs (..., I) to x_gates in the compute dtype, with one product
    over all rows in their given order, then run ``recurrence`` on it."""
    hidden = params["w_hh"].shape[0]
    x_gates = (vdot(xs.reshape(-1, xs.shape[-1]), params["w_ih"], compute_dtype)
               + params["b_ih"]).reshape(*xs.shape[:2], 3 * hidden).to(compute_dtype)
    if h0 is None:
        h0 = torch.zeros((batch, hidden), dtype=torch.float32, device=xs.device)
    return recurrence(x_gates, params["w_hh"].to(compute_dtype).contiguous(),
                      params["b_hh"].float().contiguous(), h0.float().contiguous(),
                      compute_dtype)


class GruSequence(torch.autograd.Function):
    """B1's sequence with a gradient, the counterpart of ``_gru_pallas_ad``
    (``vcr_tpu/ops/pallas_gru.py:132-167``).

    Forward: the input projection, the rounding of ``x_gates`` to the compute
    dtype and the recurrence (B1 on CUDA tensors, its plain version on CPU
    tensors), with ``(w_ih, b_ih, w_hh, b_hh, xs, h0)`` saved. Backward:
    :func:`vcr_tpu_torch.nn.rnn.gru_sequence` rerun on the saved inputs under
    autograd, as ``_gru_pallas_bwd`` takes the vjp of ``gru_sequence``: that
    recurrence keeps ``x_gates`` in float32, so the gradient is that of the
    unrounded function. Saved views (the prime's ``w_ih[:H]``, a transposed
    ``xs``) pass their gradients on to their bases through autograd.
    """

    @staticmethod
    def forward(ctx, w_ih, b_ih, w_hh, b_hh, xs, h0, compute_dtype):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(w_ih, b_ih, w_hh, b_hh, xs, h0)
        params = {"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh}
        return _run(gru_recurrence, params, xs, h0, xs.shape[1], compute_dtype)

    @staticmethod
    def backward(ctx, g_outs):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            w_ih, b_ih, w_hh, b_hh, xs, h0 = inputs = [
                x.detach().requires_grad_(need)
                for x, need in zip(ctx.saved_tensors, needs)]
            outs, _ = gru_sequence({"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh,
                                    "b_hh": b_hh}, xs, h0, ctx.compute_dtype)
            grads = iter(torch.autograd.grad(
                outs, [x for x, need in zip(inputs, needs) if need], g_outs))
        return tuple(next(grads) if need else None for need in needs) + (None,)


def gru_sequence_fused(params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (T, B, I) -> (outputs (T, B, H) float32, h_last (B, H) float32),
    through kernel B1; differentiable (:class:`GruSequence`)."""
    if h0 is None:
        h0 = torch.zeros((xs.shape[1], params["w_hh"].shape[0]), dtype=torch.float32,
                         device=xs.device)
    outs = GruSequence.apply(params["w_ih"], params["b_ih"], params["w_hh"],
                             params["b_hh"], xs, h0, compute_dtype)
    return outs, outs[-1]


def gru_sequence_fused_bt(params, xs_bt: torch.Tensor, h0: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major: xs (B, T, I) -> (outputs (B, T, H) float32, h_last (B, H)
    float32), through kernel B3. Neither xs nor x_gates is transposed."""
    outs = _run(gru_recurrence_bt, params, xs_bt, h0, xs_bt.shape[0], compute_dtype)
    return outs, outs[:, -1]


def gru_sequence_fused_dma(params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (T, B, I) -> (outputs (T, B, H) float32, h_last (B, H) float32),
    through kernel B4."""
    outs = _run(gru_recurrence_dma, params, xs, h0, xs.shape[1], compute_dtype)
    return outs, outs[-1]
