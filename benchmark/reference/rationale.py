"""Plain float32 RationaleNet over S2VT, as the reference project defines it:
a BiLSTM generator reads the N frame features, a 2H -> 2 projection gives
two logits per frame, and at eval the hard Gumbel-Softmax keeps frame t
where logit_1 + g_1 > logit_0 + g_0 (the argmax of the softmax at any tau,
the first index on a tie). The kept frames' features, the others zeroed,
go to S2VT (``s2vt.py`` here).

The Gumbel noise (S, N, 2) is the benchmark's, handed to both sides.

Where the reference's margin logit_1 + g_1 - (logit_0 + g_0) of a frame lies
within ``select_margin`` of the tie, a program that computes in its stated
lower precision may rightly choose either side. For such frames (at most
``MAX_OPEN`` per row, the nearest ties first) the check takes each choice and
keeps the one under which the served caption lies closest to the
reference's: the frame selection is held to the reference everywhere else.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Optional, Tuple

import torch

from benchmark.reference import s2vt
from benchmark.reference.common import exact_float32, lstm_cell, product

MAX_OPEN = 4


def layout(m: dict) -> List[Tuple[str, tuple, Optional[float]]]:
    """The caption net's tensors under ``caption_net.``, the generator's
    BiLSTM (``_reverse`` for the backward direction) and projection under
    ``gen.``, all torch's default init but the embedding."""
    h, v = m["hidden_size"], m["vid_feat_size"]
    k = 1.0 / math.sqrt(h)
    out = s2vt.layout(m, "caption_net.")
    for sfx in ("", "_reverse"):
        out += [(f"gen.rnn.weight_ih_l0{sfx}", (4 * h, v), k),
                (f"gen.rnn.weight_hh_l0{sfx}", (4 * h, h), k),
                (f"gen.rnn.bias_ih_l0{sfx}", (4 * h,), k),
                (f"gen.rnn.bias_hh_l0{sfx}", (4 * h,), k)]
    kl = 1.0 / math.sqrt(2 * h)
    return out + [("gen.linear.weight", (2, 2 * h), kl), ("gen.linear.bias", (2,), kl)]


def margins(sd, m: dict, feats: torch.Tensor, noise: torch.Tensor, prec: str) -> torch.Tensor:
    """The selection margins (S, N): logit_1 + g_1 - logit_0 - g_0 per frame;
    frame t is kept where its margin is above 0."""
    w = {k[4:]: t.to(feats.device, torch.float32) for k, t in sd.items()
         if k.startswith("gen.")}
    s, n = feats.shape[:2]
    h = m["hidden_size"]
    outs = []
    for sfx, order in (("", range(n)), ("_reverse", range(n - 1, -1, -1))):
        gi = product(feats, w[f"rnn.weight_ih_l0{sfx}"], prec) + w[f"rnn.bias_ih_l0{sfx}"]
        hs, c = feats.new_zeros((s, h)), feats.new_zeros((s, h))
        seq = [None] * n
        for t in order:
            hs, c = lstm_cell(gi[:, t], hs, c, w[f"rnn.weight_hh_l0{sfx}"],
                              w[f"rnn.bias_hh_l0{sfx}"], prec)
            seq[t] = hs
        outs.append(torch.stack(seq, 1))
    logits = product(torch.cat(outs, -1), w["linear.weight"], prec) + w["linear.bias"]
    z = logits + noise.float()
    return z[..., 1] - z[..., 0]


def serve(sd, m: dict, feats: torch.Tensor, noise, beam_size: int, prec: str) -> torch.Tensor:
    """The reference in the program's place, products at ``prec``."""
    with torch.no_grad(), exact_float32():
        keep = margins(sd, m, feats.float(), noise, prec) > 0
        model = s2vt.S2VT(sd, m, prec, prefix="caption_net.", device=feats.device)
        state = model.encode(feats.float() * keep[..., None])
        if beam_size > 1:
            return s2vt.beam_search(model, state, m, beam_size)[0]
        return s2vt.greedy(model, state, m)


def served_gaps(sd, m: dict, feats: torch.Tensor, noise, tokens: torch.Tensor,
                beam_size: int, cell: dict) -> torch.Tensor:
    """Per row (S,), S2VT's gap of the served caption under the reference's
    frame selection, the least over the choices of its open frames (within
    ``cell["select_margin"]`` of a tie)."""
    with torch.no_grad(), exact_float32():
        feats = feats.float()
        marg = margins(sd, m, feats, noise, "fp32")
        keep = marg > 0
        near = marg.abs() < cell["select_margin"]
        rows, variants = [], []
        for r in range(feats.shape[0]):
            open_t = [int(t) for t in torch.nonzero(near[r])[:, 0]]
            open_t = sorted(open_t, key=lambda t: float(marg[r, t].abs()))[:MAX_OPEN]
            for choice in itertools.product((False, True), repeat=len(open_t)):
                k = keep[r].clone()
                for t, c in zip(open_t, choice):
                    k[t] = c
                rows.append(r)
                variants.append(k)
        rows_t = torch.tensor(rows, device=feats.device)
        model = s2vt.S2VT(sd, m, "fp32", prefix="caption_net.", device=feats.device)
        gaps = []
        for lo in range(0, len(rows), feats.shape[0]):
            idx = rows_t[lo:lo + feats.shape[0]]
            sel = torch.stack(variants[lo:lo + feats.shape[0]])
            state = model.encode(feats[idx] * sel[..., None])
            gaps.append(s2vt.gaps_from_state(model, state, tokens[idx], m, beam_size))
        gaps = torch.cat(gaps)
        best = torch.full((feats.shape[0],), torch.inf, device=feats.device)
        return best.scatter_reduce(0, rows_t, gaps, reduce="amin")
