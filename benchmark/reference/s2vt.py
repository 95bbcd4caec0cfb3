"""Plain float32 S2VT (Venugopalan et al., arXiv 1505.00487), as the reference
project (p-kar/pytorch-video-caption-rationale) defines it, read from its
``state_dict``: the encoder, greedy decoding, beam search, the score of a
given caption, and the train step with masked cross-entropy, the global-norm
clip and Adam.

* encode: GRU1 over the N frame features; GRU2 over [GRU1's output ; a zero
  word embedding] for the same N steps, keeping its last state.
* decode step: GRU1 takes a zero frame, GRU2 takes [GRU1's output ; the
  embedding of the previous word] (<sos> first), then the vocabulary
  projection; greedy feeds the argmax back.
* beam search: the score of a hypothesis is the sum of its tokens'
  log-probabilities; a hypothesis that has emitted <eos> goes on with <eos>
  at no cost, so the best of a row is the best complete caption. A served
  caption is judged token by token (``token_gaps``): along it, each token
  must be among its prefix's k best.
* training: teacher forcing at probability 1.0, inverted dropout on the
  word embedding and on GRU2's output before the projection, cross-entropy
  averaged over each sentence's valid tokens and then over the sentences;
  the gradient's global norm clipped, L2 weight decay added to it, Adam.

The dropout masks follow the draw order that the program documents for a
train-time decode (``vcr_tpu_torch/models/s2vt.py``, its module docstring):
from one ``torch.Generator`` on the features' device, seeded with the
step's int, the L teacher-forcing coins, then the (L, B, E) embedding
keep-masks, then the (L, B, H) output keep-masks, each ``rand < 1 - p``.
Here they are drawn anew from the seed; nothing is taken from the program.

Products run at ``prec`` (``common.product``): "fp32" is the reference, a
lower precision makes the control. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference.common import exact_float32, gru_cell, product

def layout(m: dict, prefix: str = "") -> List[Tuple[str, tuple, Optional[float]]]:
    """(key, shape, bound) of every tensor of the reference's state_dict:
    GRUs and the projection uniform in [-1/sqrt(H), 1/sqrt(H)] (torch's
    default), the embedding (bound None) normal at the scale the
    configuration states."""
    h, v, e, vocab = m["hidden_size"], m["vid_feat_size"], m["embed_size"], m["vocab_size"]
    k = 1.0 / math.sqrt(h)
    out = [(prefix + "embedding.0.weight", (vocab, e), None)]
    for name, width in (("rnn1", v), ("rnn2", h + e)):
        out += [(f"{prefix}{name}.weight_ih_l0", (3 * h, width), k),
                (f"{prefix}{name}.weight_hh_l0", (3 * h, h), k),
                (f"{prefix}{name}.bias_ih_l0", (3 * h,), k),
                (f"{prefix}{name}.bias_hh_l0", (3 * h,), k)]
    out += [(prefix + "linear.1.weight", (vocab, h), k), (prefix + "linear.1.bias", (vocab,), k)]
    return out


class S2VT:
    """The model over the tensors ``w`` (the state_dict's, without
    ``prefix``), products at ``prec``."""

    def __init__(self, sd: Dict[str, torch.Tensor], m: dict, prec: str = "fp32",
                 prefix: str = "", device=None):
        self.m, self.prec = m, prec
        self.w = {k[len(prefix):]: t.to(device or t.device, torch.float32)
                  for k, t in sd.items() if k.startswith(prefix)}

    def gru(self, name: str, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_cell(gi, h, self.w[f"{name}.weight_hh_l0"], self.w[f"{name}.bias_hh_l0"],
                        self.prec)

    def in_gates(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return product(x, self.w[f"{name}.weight_ih_l0"], self.prec) + self.w[
            f"{name}.bias_ih_l0"]

    def encode(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (S, N, V) float32 -> the decoder's start states (h1, h2)."""
        s, n = feats.shape[:2]
        h = self.m["hidden_size"]
        zero_h = feats.new_zeros((s, h))
        gi1 = self.in_gates("rnn1", feats)                           # (S, N, 3H)
        h1, outs = zero_h, []
        for t in range(n):
            h1 = self.gru("rnn1", gi1[:, t], h1)
            outs.append(h1)
        zero_word = feats.new_zeros((s, self.m["embed_size"]))
        h2 = zero_h
        for t in range(n):
            h2 = self.gru("rnn2", self.in_gates("rnn2", torch.cat([outs[t], zero_word], -1)),
                          h2)
        return h1, h2

    def step(self, state, words: torch.Tensor, emb_keep=None, out_keep=None):
        """One decode step -> (new state, vocab logits (rows, vocab)); the keep
        masks, where given, are this step's dropout."""
        h1, h2 = state
        gi1 = self.w["rnn1.bias_ih_l0"].expand(h1.shape[0], -1)     # a zero frame
        h1 = self.gru("rnn1", gi1, h1)
        emb = self.w["embedding.0.weight"][words.long()]
        if emb_keep is not None:
            emb = torch.where(emb_keep, emb / (1.0 - self.m["dropout_p"]), 0.0)
        h2 = self.gru("rnn2", self.in_gates("rnn2", torch.cat([h1, emb], -1)), h2)
        out = h2 if out_keep is None else torch.where(
            out_keep, h2 / (1.0 - self.m["dropout_p"]), 0.0)
        return (h1, h2), product(out, self.w["linear.1.weight"], self.prec) + self.w[
            "linear.1.bias"]


# ------------------------------------------------------------ decoding

def _rows(state) -> int:
    return state[0].shape[0]


def greedy(model, state, m: dict) -> torch.Tensor:
    """All ``max_len`` greedy steps from ``state`` -> tokens (S, L) int64."""
    words = torch.full((_rows(state),), m["sos_id"], dtype=torch.long,
                       device=state[0].device)
    out = []
    for _ in range(m["max_len"]):
        state, logits = model.step(state, words)
        words = logits.argmax(-1)
        out.append(words)
    return torch.stack(out, 1)


def forced_logits(model, state, tokens: torch.Tensor, m: dict) -> torch.Tensor:
    """The logits (S, L, vocab) at each position of ``tokens`` (S, L), the
    previous served token fed back (<sos> first)."""
    s = _rows(state)
    prev = torch.full((s,), m["sos_id"], dtype=torch.long, device=tokens.device)
    out = []
    for t in range(tokens.shape[1]):
        state, logits = model.step(state, prev)
        out.append(logits)
        prev = tokens[:, t].long().clamp(0, m["vocab_size"] - 1)
    return torch.stack(out, 1)


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor, k: int = 1,
               eos_id: Optional[int] = None) -> torch.Tensor:
    """Per row, the widest gap by which a served token's logit lies below the
    ``k``-th best logit at its position. Greedy (``k`` = 1) holds every
    position to the best. A beam of width ``k`` keeps a continuation only
    where fewer than ``k`` continuations of the same prefix score higher,
    so each token of its best caption, up to the first ``eos_id``, is among
    its prefix's ``k`` best; after that <eos> must follow <eos>. A token
    outside the vocabulary, or another token after <eos>, is an infinite
    gap. -> (S,)"""
    vocab = logits.shape[-1]
    ok = (tokens >= 0) & (tokens < vocab)
    picked = logits.gather(-1, tokens.long().clamp(0, vocab - 1)[..., None])[..., 0]
    gap = torch.where(ok, logits.topk(k, -1).values[..., -1] - picked, torch.inf)
    if eos_id is not None:
        is_eos = tokens == eos_id
        after = (is_eos.long().cumsum(1) - is_eos.long()) > 0   # past the first eos
        gap = torch.where(after, torch.where(is_eos, -torch.inf, torch.inf), gap)
    return gap.amax(-1)


def tile(state, k: int):
    return tuple(x.repeat_interleave(k, 0) for x in state)


def beam_search(model, state, m: dict, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the best caption per row (S, L), its score (S,)): each row's ``k``
    beams start from one live copy; every step keeps the ``k`` best of the
    ``k`` x vocab continuations; <eos> ends a hypothesis, which then goes on
    with <eos> at no cost."""
    s, eos, length = _rows(state), m["eos_id"], m["max_len"]
    dev = state[0].device
    state = tile(state, k)
    scores = torch.full((s, k), -torch.inf, device=dev)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    done = torch.zeros(s * k, dtype=torch.bool, device=dev)
    hist = torch.zeros((s * k, length), dtype=torch.long, device=dev)
    words = torch.full((s * k,), m["sos_id"], dtype=torch.long, device=dev)
    base = torch.arange(s, device=dev)[:, None] * k
    for t in range(length):
        state, logits = model.step(state, words)
        logp = torch.log_softmax(logits, -1)
        only_eos = torch.full_like(logp[:1], -torch.inf)
        only_eos[0, eos] = 0.0
        cand = scores[:, None] + torch.where(done[:, None], only_eos, logp)
        vocab = cand.shape[-1]
        top, idx = cand.reshape(s, k * vocab).topk(k, -1)
        src = (base + idx // vocab).reshape(-1)
        words = (idx % vocab).reshape(-1)
        state = tuple(x[src] for x in state)
        hist, done = hist[src], done[src]
        hist[:, t] = words
        done = done | (words == eos)
        scores = top.reshape(-1)
    best = scores.reshape(s, k).argmax(-1)
    rows = torch.arange(s, device=dev) * k + best
    return hist[rows], scores[rows]


def serve(sd, m: dict, feats: torch.Tensor, noise, beam_size: int, prec: str) -> torch.Tensor:
    """The reference in the program's place: captions (S, L) of ``feats``,
    greedy or by beam search, products at ``prec``."""
    with torch.no_grad(), exact_float32():
        model = S2VT(sd, m, prec, device=feats.device)
        state = model.encode(feats.float())
        if beam_size > 1:
            return beam_search(model, state, m, beam_size)[0]
        return greedy(model, state, m)


def served_gaps(sd, m: dict, feats: torch.Tensor, noise, tokens: torch.Tensor,
                beam_size: int, cell: dict) -> torch.Tensor:
    """Per row (S,), the widest gap of a served token's logit below the
    reference's best at its position (greedy), or below its ``beam_size``-th
    best (the best caption of a beam; ``token_gaps``), the reference fed the
    served tokens."""
    with torch.no_grad(), exact_float32():
        model = S2VT(sd, m, "fp32", device=feats.device)
        state = model.encode(feats.float())
        return gaps_from_state(model, state, tokens, m, beam_size)


def gaps_from_state(model, state, tokens, m: dict, beam_size: int) -> torch.Tensor:
    return token_gaps(forced_logits(model, state, tokens, m), tokens, beam_size,
                      m["eos_id"] if beam_size > 1 else None)


# ------------------------------------------------------------ training

def draw_masks(seed: int, batch: int, m: dict, device):
    """The step's (L, B, E) and (L, B, H) keep-masks, drawn after the L
    teacher-forcing coins from a generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    length, keep = m["max_len"], 1.0 - m["dropout_p"]
    torch.rand((length,), generator=gen, device=device)                 # the coins
    emb = torch.rand((length, batch, m["embed_size"]), generator=gen, device=device) < keep
    out = torch.rand((length, batch, m["hidden_size"]), generator=gen, device=device) < keep
    return emb, out


def train_loss(model: S2VT, batch: dict, masks, m: dict) -> torch.Tensor:
    """Masked cross-entropy of the teacher-forced decode with dropout: each
    sentence's mean over its valid tokens, then the mean over sentences."""
    feats, sent, lens = batch["vid_feats"].float(), batch["sent"].long(), batch["sent_len"]
    state = model.encode(feats)
    prev = torch.full((feats.shape[0],), m["sos_id"], dtype=torch.long, device=feats.device)
    nll = []
    for t in range(m["max_len"]):
        state, logits = model.step(state, prev, masks[0][t], masks[1][t])
        nll.append(-torch.log_softmax(logits, -1).gather(-1, sent[:, t:t + 1])[:, 0])
        prev = sent[:, t]
    nll = torch.stack(nll, 1)
    valid = (torch.arange(m["max_len"], device=feats.device)[None] < lens[:, None]).float()
    return ((nll * valid).sum(1) / valid.sum(1).clamp(min=1.0)).mean()


def train_steps(sd, m: dict, opt: dict, batches: List[dict], seeds: List[int],
                prec: str = "fp32", fault: Optional[str] = None) -> dict:
    """The reference's first ``len(batches)`` optimizer steps from ``sd``.

    -> {"loss": [per step], "grad": {key: the first step's gradient as Adam
    gets it (clipped, weight decay added)}, "raw_grad": {key: the first
    step's clipped loss gradient}, "change": {key: parameters after the last
    step less before the first}}. ``fault`` plants a fault in the reference
    put in the program's place: "frozen" (the state never moves), "half"
    (each step sees the first half of its batch)."""
    with exact_float32():
        model = S2VT(sd, m, prec, device=batches[0]["vid_feats"].device)
        keys = list(model.w)
        start = {k: model.w[k].detach().clone() for k in keys}
        for k in keys:
            model.w[k] = model.w[k].detach().clone().requires_grad_(True)
        b1, b2, eps = opt["betas"][0], opt["betas"][1], opt["eps"]
        exp_avg = {k: torch.zeros_like(model.w[k]) for k in keys}
        exp_sq = {k: torch.zeros_like(model.w[k]) for k in keys}
        out: Dict = {"loss": []}
        for i, (batch, seed) in enumerate(zip(batches, seeds), start=1):
            if fault == "half":
                batch = {k: x[: x.shape[0] // 2] for k, x in batch.items()}
            masks = draw_masks(seed, batch["vid_feats"].shape[0], m, batch["vid_feats"].device)
            loss = train_loss(model, batch, masks, m)
            grads = torch.autograd.grad(loss, [model.w[k] for k in keys])
            out["loss"].append(float(loss.detach()))
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            coef = torch.clamp(opt["max_norm"] / (norm + 1e-6), max=1.0)
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    g = g * coef
                    if i == 1:
                        out.setdefault("raw_grad", {})[k] = g.clone()
                    g = g + opt["wd"] * model.w[k]
                    if i == 1:
                        out.setdefault("grad", {})[k] = g.clone()
                    if fault == "frozen":
                        continue
                    exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
                    exp_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (exp_sq[k].sqrt() / math.sqrt(1 - b2 ** i)).add_(eps)
                    model.w[k].addcdiv_(exp_avg[k], denom, value=-opt["lr"] / (1 - b1 ** i))
        out["change"] = {k: (model.w[k].detach() - start[k]) for k in keys}
        return out
