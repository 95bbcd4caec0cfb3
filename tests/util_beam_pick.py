"""Inputs of the beam's word pick (``vcr_tpu_torch::beam_pick``) for its CPU
and card tests: each case is (logits (B*K, V) float32, scores (B*K,) float32,
finished (B*K,) bool, k, eos_id), drawn on the CPU from a seed so that both
devices see the same numbers.

The tie cases are built from logits of 0 and -30 (or rows of one value), so
each row's sum of exp is a small whole number plus less than half its last
bit, in any order of summation: the log-softmax is then the same on every
device and the ties are exact."""

from __future__ import annotations

import torch

EOS = 2
NEG_INF = -1e9


def _draw(seed: int):
    return torch.Generator().manual_seed(seed)


def random_case(seed: int, batch: int, k: int, vocab: int, finished_share: float = 0.1,
                eos_id: int = EOS):
    """Logits like a decoder's (normal, scale 3), scores like a search's
    running sums (uniform in [-30, 0]), a share of the beams finished."""
    g = _draw(seed)
    n = batch * k
    logits = torch.randn((n, vocab), generator=g) * 3.0
    scores = -30.0 * torch.rand((n,), generator=g)
    finished = torch.rand((n,), generator=g) < finished_share
    return logits, scores, finished, k, eos_id


def _hot(n: int, vocab: int, hot_cols) -> torch.Tensor:
    """Rows of -30 with 0 at each row's hot columns."""
    logits = torch.full((n, vocab), -30.0)
    for r, cols in enumerate(hot_cols):
        logits[r, list(cols)] = 0.0
    return logits


def equal_rows(batch: int = 4, k: int = 5, vocab: int = 1000):
    """Every word of a row has the same logit; the beams' scores tie in pairs."""
    n = batch * k
    logits = torch.linspace(-2.0, 2.0, n)[:, None].expand(n, vocab).contiguous()
    scores = torch.tensor([0.0, -1.0, 0.0, -1.0, -0.5] * (n // 5) + [0.0] * (n % 5))
    return logits, scores, torch.zeros((n,), dtype=torch.bool), k, EOS


def ties_across_beams(batch: int = 4, k: int = 5, vocab: int = 1000):
    """Beams of one item share hot words and scores, so equal values meet in
    both stages and the lower word, then the lower beam, must win."""
    n = batch * k
    hot = [((r // k) % vocab, (r // k * 7 + 3) % vocab, 11 + (r % 2)) for r in range(n)]
    scores = torch.tensor([0.0, 0.0, -1.0, 0.0, -1.0] * (n // 5) + [0.0] * (n % 5))
    return _hot(n, vocab, hot), scores, torch.zeros((n,), dtype=torch.bool), k, EOS


def step_zero(seed: int = 3, batch: int = 4, k: int = 5, vocab: int = 1000):
    """The first step: beam 0 of each item live at 0, the others at NEG_INF,
    whose candidates all round to the same value."""
    logits, _, _, _, _ = random_case(seed, batch, k, vocab)
    scores = torch.full((batch, k), NEG_INF)
    scores[:, 0] = 0.0
    return logits, scores.reshape(-1), torch.zeros((batch * k,), dtype=torch.bool), k, EOS


def finished_rows(batch: int = 4, k: int = 5, vocab: int = 1000):
    """Finished beams at equal and unequal scores beside live ones whose best
    candidates tie with them."""
    n = batch * k
    hot = [(EOS, 5, 9) if r % 3 else (5,) for r in range(n)]
    scores = torch.tensor([-1.0, -1.0, -2.0, -1.0, -0.5] * (n // 5) + [0.0] * (n % 5))
    finished = torch.tensor([True, True, False, False, True] * (n // 5)
                            + [False] * (n % 5))
    return _hot(n, vocab, hot), scores, finished, k, EOS


def clustered_top(seed: int = 9, batch: int = 4, k: int = 5, vocab: int = 9088):
    """Each row's best words at columns 4t + 1024q + c of one t, which one
    thread of the kernel's block loads: it wins round after round."""
    logits, scores, finished, _, _ = random_case(seed, batch, k, vocab, 0.0)
    logits = logits * 0.1
    cols = [20, 21, 22, 23, 1044, 1045, 1046, 1047, 2068]
    logits[:, cols] = 5.0 + 0.25 * torch.arange(len(cols), dtype=torch.float32).flip(0)
    return logits, scores, finished, k, EOS


def tie_cases():
    """{name: case} of the exact-tie cases, the beam widths 1 and 32,
    vocabularies that are not a multiple of a block's columns (one not even
    of four, so the kernel loads one float at a time) or span several, and
    rows whose best words one thread of the kernel holds."""
    return {
        "equal_rows": equal_rows(),
        "ties_across_beams": ties_across_beams(),
        "step_zero": step_zero(),
        "finished_rows": finished_rows(),
        "ragged_vocab": random_case(5, 3, 5, 1001, 0.3),
        "ragged_ties": ties_across_beams(vocab=9001),
        "wide_vocab": random_case(6, 2, 4, 30001, 0.25),
        "k1": random_case(7, 6, 1, 9088),
        "k32": random_case(8, 3, 32, 2000, 0.2),
        "clustered_top": clustered_top(),
    }


def to(case, device):
    logits, scores, finished, k, eos_id = case
    return logits.to(device), scores.to(device), finished.to(device), k, eos_id
