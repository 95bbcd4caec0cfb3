"""The yardstick's arithmetic: the card's published peaks, the model FLOPs of
a request from a configuration's sizes, the least time of the GRU and LSTM
recurrences, and the union of device intervals.

These are copies, kept here so that a change to the program cannot move the
yardstick: the peaks and the two bounds are those of
``vcr_tpu_torch/utils/benchutil.py`` (``CARD_PEAKS``, ``gru_bound_ms``,
``lstm_bound_ms``), the union that of ``scripts/profile_torch_s2vt.busy_us``.
The FLOPs are counted from the configuration, never from what the program
executes: two per multiply-add of every product the model's equations need,
where a product with an operand that is zero by construction (the zero word
embedding of S2VT's priming pass, the zero frame of its decode) is not needed
work. Gate math, softmax, gathers and the optimizer's arithmetic ride along
uncounted.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

# Published dense peaks per card, by torch.cuda.get_device_name (NVIDIA H100
# SXM data sheet, at its 700 W limit): bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, device-memory (HBM3) bytes/s.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def card_peaks(kind: str) -> Optional[Tuple[float, float, float]]:
    """The peaks of the card named ``kind``, or None for a card the table
    does not hold."""
    return CARD_PEAKS.get(kind)


# ------------------------------------------------------------ model FLOPs

def s2vt_encode_flops(m: dict) -> int:
    """One video's encoder and priming pass: GRU1's input projection and
    recurrence over the N frames, then GRU2 over [GRU1's outputs ; zero word
    embedding], whose input product needs only the first H input rows."""
    n, v, h = m["num_frames"], m["vid_feat_size"], m["hidden_size"]
    return 2 * n * v * 3 * h + 2 * n * h * 3 * h + 2 * n * h * 3 * h + 2 * n * h * 3 * h


def s2vt_step_flops(m: dict, vocab: int) -> int:
    """One decode step of one row: GRU1's recurrence (its input is a zero
    frame), GRU2's input product over [GRU1 out ; word embedding] and its
    recurrence, and the vocabulary projection."""
    h, e = m["hidden_size"], m["embed_size"]
    return 2 * h * 3 * h + 2 * (h + e) * 3 * h + 2 * h * 3 * h + 2 * h * vocab


def generator_flops(m: dict) -> int:
    """RationaleNet's frame selector for one video: both directions of the
    BiLSTM (input projection and recurrence) and the 2H -> 2 projection."""
    n, v, h = m["num_frames"], m["vid_feat_size"], m["hidden_size"]
    return 2 * (2 * n * v * 4 * h + 2 * n * h * 4 * h) + 2 * n * 2 * h * 2


def caption_flops(m: dict, beam_size: int = 1, vocab: Optional[int] = None) -> int:
    """The products of one caption: the encoder at one row, then ``max_len``
    decode steps at ``beam_size`` rows; RationaleNet adds its selector.
    ``vocab`` defaults to the configuration's (the published size)."""
    vocab = m["vocab_size"] if vocab is None else vocab
    flops = s2vt_encode_flops(m) + beam_size * m["max_len"] * s2vt_step_flops(m, vocab)
    if m["arch"] == "rationale":
        flops += generator_flops(m)
    return flops


def train_forward_flops(m: dict, vocab: Optional[int] = None) -> int:
    """The teacher-forced forward of one training video: S2VT's encoder and
    ``max_len`` decode steps, the same products as a greedy caption."""
    return caption_flops({**m, "arch": "s2vt"}, 1, vocab)


def train_flops(m: dict, vocab: Optional[int] = None) -> int:
    """One training video: three times its teacher-forced forward (the
    forward, and the backward's two products per forward product)."""
    return 3 * train_forward_flops(m, vocab)


# ------------------------------------------------------- recurrence bounds
#
# The least time a call could take on a card with ``peaks``: the larger of
# its bytes (each input read once, each output written once) over the memory
# rate and its operations over the peak rate of their type. Each returns
# (ms, "bytes" or "operations").

def _bound(ops_s: float, bytes_s: float) -> Tuple[float, str]:
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def gru_bound_ms(t: int, b: int, hidden: int, peaks) -> Tuple[float, str]:
    """One GRU recurrence in bf16: x_gates, W_hh, b_hh and h0 read and the
    float32 outputs written once, or the recurrent product at the bf16
    tensor-core rate plus the gate math (14 float32 operations per hidden
    element) at the float32 rate."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 3 * hidden * 2 + hidden * 3 * hidden * 2 + 3 * hidden * 4
              + b * hidden * 4 + t * b * hidden * 4)
    ops_s = 2 * t * b * hidden * 3 * hidden / bf16_rate + 14 * t * b * hidden / f32_rate
    return _bound(ops_s, nbytes / mem_rate)


def lstm_bound_ms(t: int, b: int, hidden: int, peaks) -> Tuple[float, str]:
    """One LSTM recurrence (one direction) in bf16: its inputs read and
    outputs written once, or the recurrent product at the bf16 tensor-core
    rate plus the gate math (23 float32 operations per hidden element) at
    the float32 rate."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 4 * hidden * 2 + hidden * 4 * hidden * 2 + 4 * hidden * 4
              + 2 * b * hidden * 4 + t * b * hidden * 4 + b * hidden * 4)
    ops_s = 2 * t * b * hidden * 4 * hidden / bf16_rate + 23 * t * b * hidden / f32_rate
    return _bound(ops_s, nbytes / mem_rate)


# ------------------------------------------------------------ the union

def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total
