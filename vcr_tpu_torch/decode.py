"""Decoding beyond greedy: beam search and sampling, for S2VT and for
RationaleNet over S2VT. The counterpart of the S2VT and RationaleNet parts
of ``vcr_tpu/decode.py``.

The beam folds into the batch axis: B*K rows go through the same cell as the
greedy decode (``_s2vt_stepper``, plain PyTorch as in the JAX package), and
reordering the beams gathers the rows of the state. Encode and prime run once
at B rows through kernel B1. Beam width 1 gives the greedy tokens up to and
including the first eos; after it the search holds finished rows at eos.

Ties break as in the JAX package, whose ``lax.top_k`` is index-stable: among
equal scores the lower word id wins within a beam, and the lower beam across
beams. ``torch.topk`` promises no order among ties, so :func:`_top_k` takes
the first k of a stable descending sort.

Sampling draws ``argmax(logits + g)`` with Gumbel noise g, which is
``jax.random.categorical``'s form; the noise comes from a ``torch.Generator``
seeded with an int, or is injected. Masked logits are ``NEG_INF``, a finite
number, so no noise draw makes a masked token win.

Families not ported raise naming their ROADMAP item; decode weights other
than bf16 (the int8 stepper) raise naming A13. Nothing here reads an
environment variable.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, s2vt
from vcr_tpu_torch.nn.gumbel import sample_gumbel
from vcr_tpu_torch.nn.layers import dense, embed, mask_vocab_pad, vdot
from vcr_tpu_torch.nn.rnn import gru_gates

NEG_INF = -1e9


def check_decode_weights(decode_weights: Optional[str]) -> None:
    """None and "bf16" are the bf16-weight stepper; anything else raises."""
    if decode_weights not in (None, "bf16"):
        raise NotImplementedError(
            f"decode_weights={decode_weights!r} is not ported yet: ROADMAP A13 "
            "(quantized serving modes)")


def check_decode_mode(beam_size: int, temperature: float, top_k: int,
                      top_p: float) -> None:
    """Beam search and sampling exclude each other, and the sampling filters
    need sampling on: raise ValueError on a combination that would otherwise
    drop an option."""
    if temperature > 0 and beam_size > 1:
        raise ValueError("beam_size > 1 and sampling are mutually exclusive "
                         "(beam maximizes sequence log-prob; sampling draws "
                         "from it)")
    if temperature <= 0 and (top_k or top_p):
        raise ValueError("sample_top_k and sample_top_p filter sampling: set "
                         "sample_temperature > 0")


def _not_ported(arch: str):
    """Raise for a family whose decode is not ported, naming its item."""
    model_base.build_model(arch)
    raise NotImplementedError(f"decode for {arch!r}")


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, in descending order; among equal
    values the lower index first (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _tile_beam(tree, k: int):
    """Repeat each batch row k times: (B, ...) -> (B*K, ...)."""
    return {name: x.repeat_interleave(k, dim=0) for name, x in tree.items()}


def beam_search(step_fn: Callable, init_state, batch: int, beam_size: int,
                max_len: int, sos_id: int, eos_id: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens (B, K, L) int32 sorted best-first, scores (B, K) float32).

    ``step_fn(state, words (B*K,), i) -> (state, logits (B*K, V))``;
    ``init_state`` a dict of tensors with B*K leading rows. Reordering the
    beams gathers the leading rows of every state tensor."""
    k = beam_size
    device = next(iter(init_state.values())).device
    words = torch.full((batch * k,), sos_id, dtype=torch.int32, device=device)
    # only beam 0 of each item is live at step 0 (the beams start as copies)
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    finished = torch.zeros((batch * k,), dtype=torch.bool, device=device)
    tokens = torch.zeros((batch * k, max_len), dtype=torch.int32, device=device)
    rows = torch.arange(batch, device=device)[:, None] * k
    state = init_state
    eos_only = None
    for i in range(max_len):
        state, logits = step_fn(state, words, i)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if eos_only is None:
            eos_only = torch.full((1, logp.shape[-1]), NEG_INF, device=device)
            eos_only[0, eos_id] = 0.0
        # a finished beam continues with eos for free, with nothing else
        cont = torch.where(finished[:, None], eos_only, logp)
        # two stages: each beam's top k over the vocabulary, then the top k
        # of the K*K survivors. A global winner is in its own beam's top k,
        # and with index-stable ties this equals a top k over (B, K*V).
        s1, i1 = _top_k(scores[:, None] + cont, k)               # (B*K, K)
        top_scores, top_idx = _top_k(s1.reshape(batch, k * k), k)  # (B, K)
        beam_idx = torch.div(top_idx, k, rounding_mode="floor")
        word_idx = i1.reshape(batch, k * k).gather(1, top_idx).to(torch.int32)
        flat_src = (rows + beam_idx).reshape(-1)
        state = {name: x[flat_src] for name, x in state.items()}
        # the histories follow their beams before step i is written
        tokens = tokens[flat_src]
        finished = finished[flat_src]
        words = word_idx.reshape(-1)
        tokens[:, i] = words
        finished = finished | (words == eos_id)
        scores = top_scores.reshape(-1)
    return tokens.reshape(batch, k, max_len), scores.reshape(batch, k)


def apply_sampling_filters(logits: torch.Tensor, temperature: float = 1.0,
                           top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """(rows, V) logits -> float32 logits scaled by 1/temperature with the
    non-candidates set to NEG_INF: optionally only the top_k, then optionally
    the top_p nucleus (the smallest probability-sorted set reaching mass
    top_p, over the already-filtered distribution)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p and 0.0 < top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        before = torch.cumsum(sp, dim=-1) - sp            # mass strictly above
        keep = (before < top_p).sum(dim=-1, keepdim=True)  # >= 1
        thresh = sp.gather(-1, keep - 1)
        logits = torch.where(probs < thresh, NEG_INF, logits)
    return logits


def sample_search(step_fn: Callable, init_state, rows: int, max_len: int,
                  sos_id: int, eos_id: int, rng=0, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0,
                  gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-step categorical sampling from softmax(logits / temperature),
    optionally restricted by top_k and/or top_p (:func:`apply_sampling_filters`).
    Rows that emitted eos keep emitting it. -> tokens (rows, max_len) int32.

    Step i adds Gumbel noise ``gumbel[i]`` (max_len, rows, V) where it is
    given, else a fresh (rows, V) draw from a generator seeded with ``rng``
    (an int, or a ``torch.Generator`` on the state's device)."""
    device = next(iter(init_state.values())).device
    gen = None if gumbel is not None else s2vt.generator_for(rng, device)
    words = torch.full((rows,), sos_id, dtype=torch.int32, device=device)
    finished = torch.zeros((rows,), dtype=torch.bool, device=device)
    state, out = init_state, []
    for i in range(max_len):
        state, logits = step_fn(state, words, i)
        logits = apply_sampling_filters(logits, temperature, top_k, top_p)
        noise = gumbel[i] if gumbel is not None else sample_gumbel(
            logits.shape, gen, device)
        sampled = (logits + noise).argmax(dim=-1).to(torch.int32)
        words = torch.where(finished, eos_id, sampled).to(torch.int32)
        finished = finished | (words == eos_id)
        out.append(words)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------- S2VT

def _s2vt_stepper(params, spec: model_base.ModelSpec, rows: int,
                  decode_weights: Optional[str] = None) -> Callable:
    """The S2VT decode cell as a (state, words, i) step over ``rows`` rows
    (B*K for beam search, B for sampling): the cell of the greedy decode
    (``s2vt.decode_from_states``). bf16 decode weights only."""
    check_decode_weights(decode_weights)
    cd = spec.cdtype
    rnn1, rnn2 = params["rnn1"], params["rnn2"]
    # GRU1's decode-phase input is a zero frame: its input gates are b_ih
    xg1 = rnn1["b_ih"].expand(rows, 3 * spec.hidden_size)

    def step_fn(state, words, i):
        out1 = gru_gates(xg1, state["s1"], rnn1, cd)
        emb = embed(params["embedding"], words)
        xg2 = vdot(torch.cat([out1, emb], dim=-1), rnn2["w_ih"], cd) + rnn2["b_ih"]
        out2 = gru_gates(xg2, state["s2"], rnn2, cd)
        logits = mask_vocab_pad(dense(params["linear"], out2, cd), spec.vocab_size)
        return {"s1": out1, "s2": out2}, logits

    return step_fn


def s2vt_beam_from_states(params, spec: model_base.ModelSpec, enc_outs: torch.Tensor,
                          state1: torch.Tensor, beam_size: int, eos_id: int,
                          decode_weights: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode from S2VT's encoder states: the prime through B1 at B
    rows, then the stepper at B*K rows."""
    check_decode_weights(decode_weights)
    state2 = s2vt._prime_state2(params, spec, enc_outs)
    b = enc_outs.shape[1]
    init_state = _tile_beam({"s1": state1, "s2": state2}, beam_size)
    step_fn = _s2vt_stepper(params, spec, b * beam_size)
    return beam_search(step_fn, init_state, b, beam_size, spec.max_len,
                       spec.sos_id, eos_id)


def s2vt_sample_from_states(params, spec: model_base.ModelSpec, enc_outs: torch.Tensor,
                            state1: torch.Tensor, rng, eos_id: int,
                            temperature: float = 1.0, top_k: int = 0,
                            top_p: float = 0.0,
                            gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampling decode from S2VT's encoder states."""
    state2 = s2vt._prime_state2(params, spec, enc_outs)
    b = enc_outs.shape[1]
    step_fn = _s2vt_stepper(params, spec, b)
    return sample_search(step_fn, {"s1": state1, "s2": state2}, b, spec.max_len,
                         spec.sos_id, eos_id, rng, temperature, top_k, top_p,
                         gumbel=gumbel)


def s2vt_sample_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                       rng, eos_id: int, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0,
                       gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature/top-k/top-p sampling decode for S2VT -> tokens (B, L)."""
    enc_outs, state1 = s2vt.encode(params, spec, vid_feats.to(spec.cdtype))
    return s2vt_sample_from_states(params, spec, enc_outs, state1, rng, eos_id,
                                   temperature, top_k, top_p, gumbel=gumbel)


def s2vt_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                     beam_size: int, eos_id: int,
                     decode_weights: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode for S2VT: the greedy decode's cell, B*K rows."""
    enc_outs, state1 = s2vt.encode(params, spec, vid_feats.to(spec.cdtype))
    return s2vt_beam_from_states(params, spec, enc_outs, state1, beam_size, eos_id,
                                 decode_weights=decode_weights)


# ------------------------------------------------------------ RationaleNet

def _rationale_select(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                      gen: torch.Generator,
                      gumbel_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Hard Gumbel frame selection (eval): the selected features (B, N, V).
    The noise is ``gumbel_noise`` (B, N, 2), else drawn from ``gen`` as
    ``rationale.apply`` draws it at eval."""
    rationale.base_module(spec)  # raises for a base not ported
    vid_feats = vid_feats.to(spec.cdtype)
    if gumbel_noise is None:
        gumbel_noise = sample_gumbel((*vid_feats.shape[:2], 2), gen, vid_feats.device)
    sel, _ = rationale.generator(params["gen"], spec, vid_feats,
                                 gumbel_noise=gumbel_noise, train=False)
    return sel


def rationale_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                          beam_size: int, eos_id: int, rng=None,
                          decode_weights: Optional[str] = None,
                          gumbel_noise: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard Gumbel frame selection, then beam search on the wrapped S2VT over
    the selected features. The selection's noise is drawn from a generator
    seeded with ``rng`` (None: 0), as the greedy ``rationale.apply`` draws it
    for that seed, or is ``gumbel_noise``."""
    check_decode_weights(decode_weights)
    gen = s2vt.generator_for(rng, vid_feats.device)
    sel = _rationale_select(params, spec, vid_feats, gen, gumbel_noise)
    return s2vt_beam_decode(params["caption_net"], spec, sel, beam_size, eos_id)


def sample_tokens(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                  eos_id: int, rng=0, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, gumbel: Optional[torch.Tensor] = None,
                  gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic decoding for S2VT and RationaleNet -> tokens (B, L).
    ``top_k=1`` is argmax: the greedy decode up to the first eos.

    One generator seeded with ``rng`` draws everything, in order:
    RationaleNet's frame-selection noise (unless ``gumbel_noise`` is given),
    then each step's sampling noise (unless ``gumbel`` is given)."""
    if spec.arch == "s2vt":
        return s2vt_sample_decode(params, spec, vid_feats, rng, eos_id, temperature,
                                  top_k, top_p, gumbel=gumbel)
    if spec.arch == "rationale":
        gen = s2vt.generator_for(rng, vid_feats.device)
        sel = _rationale_select(params, spec, vid_feats, gen, gumbel_noise)
        return sample_tokens(params["caption_net"], spec.with_(arch=spec.base_arch),
                             sel, eos_id, gen, temperature, top_k, top_p, gumbel=gumbel)
    _not_ported(spec.arch)


def decode_tokens(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                  eos_id: int, beam_size: int = 1, rng=None,
                  decode_weights: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode for S2VT and RationaleNet -> (tokens (B, K, L), scores
    (B, K)). Beam width 1's best row equals the greedy rollout up to the
    first eos. ``rng`` seeds RationaleNet's frame selection."""
    if spec.arch == "s2vt":
        return s2vt_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                decode_weights=decode_weights)
    if spec.arch == "rationale":
        return rationale_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                     rng=rng, decode_weights=decode_weights)
    _not_ported(spec.arch)
