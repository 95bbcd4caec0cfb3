"""The beam's word pick: a hand-written CUDA kernel and its plain version.

One step of beam search over B items of K beams picks, from the step's
logits (B*K, V), each item's K best continuations: the log-softmax of each
row, a finished row continuing with eos alone at no cost, each row's top K
of score + log-probability, then each item's top K of its K*K survivors.
Both stages order by value descending, then index ascending, which is
``lax.top_k``'s order in the JAX package.

* :func:`beam_pick_cuda` launches ``csrc/beam_pick.cu`` once a step on CUDA
  tensors: it reads each live row once and keeps everything else on chip.
  It takes K <= :data:`MAX_K` and raises above it.
* :func:`beam_pick_plain` is the same function in plain PyTorch (the
  log-softmax, the ``where`` and two stable sorts), for CPU tensors.

``vcr_tpu_torch::beam_pick`` (``ops/library.py``) dispatches between them by
device; ``decode.beam_pick`` calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from vcr_tpu_torch.ops import _build

NEG_INF = -1e9        # decode.NEG_INF: what a finished beam gives every word but eos
MAX_K = 32            # beams a kernel launch takes (csrc/beam_pick.cu, kMaxK)

# kernel launches made by beam_pick_cuda, for showing that a run went
# through the kernel
launches = 0


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, in descending order; among equal
    values the lower index first (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_pick_plain(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                    k: int, eos_id: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (B*K, V), scores (B*K,) float32, finished (B*K,) bool ->
    (top_scores (B, K) float32, word_idx (B, K) int32, flat_src (B*K,) int64,
    the row of ``logits`` each new beam continues)."""
    batch = logits.shape[0] // k
    logp = torch.log_softmax(logits.float(), dim=-1)
    eos_only = torch.full((1, logp.shape[-1]), NEG_INF, device=logp.device)
    eos_only[0, eos_id] = 0.0
    # a finished beam continues with eos for free, with nothing else
    cont = torch.where(finished[:, None], eos_only, logp)
    # two stages: each beam's top k over the vocabulary, then the top k of
    # the K*K survivors. A global winner is in its own beam's top k, and with
    # index-stable ties this equals a top k over (B, K*V).
    s1, i1 = top_k(scores[:, None] + cont, k)                      # (B*K, K)
    top_scores, top_idx = top_k(s1.reshape(batch, k * k), k)      # (B, K)
    beam_idx = torch.div(top_idx, k, rounding_mode="floor")
    word_idx = i1.reshape(batch, k * k).gather(1, top_idx).to(torch.int32)
    rows = torch.arange(batch, device=logits.device)[:, None] * k
    # contiguous, as the kernel writes them and the op's fake says
    return top_scores.contiguous(), word_idx, (rows + beam_idx).reshape(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("beam_pick")
    lib.beam_pick_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.beam_pick_forward.restype = ctypes.c_int
    lib.beam_pick_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.beam_pick_scratch_words.restype = ctypes.c_longlong
    lib.beam_pick_error_string.argtypes = [ctypes.c_int]
    lib.beam_pick_error_string.restype = ctypes.c_char_p
    return lib


def _check(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
               k: int, eos_id: int) -> Tuple[int, int]:
    """Raise on what the kernel cannot take, before the device check; return
    (items B, vocabulary V)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the beam_pick kernel takes 1 <= beam size <= {MAX_K}, got {k}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (B*K, V), got {tuple(logits.shape)}")
    rows, vocab = logits.shape
    if rows % k:
        raise ValueError(f"logits has {rows} rows, not a multiple of the beam size {k}")
    if vocab < k:
        raise ValueError(f"a vocabulary of {vocab} words has no top {k}")
    if not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} is outside the vocabulary of {vocab} words")
    for name, x, shape, dtype in (("logits", logits, (rows, vocab), torch.float32),
                                  ("scores", scores, (rows,), torch.float32),
                                  ("finished", finished, (rows,), torch.bool)):
        if x.device != logits.device:
            raise ValueError(f"{name} must be on {logits.device}, got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if not logits.is_cuda:
        raise ValueError(f"the beam_pick kernel takes CUDA tensors, got {logits.device}")
    return rows // k, vocab


def beam_pick_cuda(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                   k: int, eos_id: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; same contract as
    :func:`beam_pick_plain`, on CUDA tensors, for k <= :data:`MAX_K`."""
    global launches
    items, vocab = _check(logits, scores, finished, k, eos_id)
    dev = logits.device
    top_scores = torch.empty((items, k), dtype=torch.float32, device=dev)
    word_idx = torch.empty((items, k), dtype=torch.int32, device=dev)
    flat_src = torch.empty((items * k,), dtype=torch.int64, device=dev)
    if items == 0:
        return top_scores, word_idx, flat_src
    lib = _lib()
    # each row's k picks and each item's count of rows done, for the item's
    # last block
    scratch = torch.empty((lib.beam_pick_scratch_words(items, k),), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.beam_pick_forward(
            logits.data_ptr(), scores.data_ptr(), finished.data_ptr(), scratch.data_ptr(),
            top_scores.data_ptr(), word_idx.data_ptr(), flat_src.data_ptr(), items, k,
            vocab, eos_id, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("beam_pick kernel launch failed: "
                           + lib.beam_pick_error_string(err).decode())
    launches += 1
    return top_scores, word_idx, flat_src
