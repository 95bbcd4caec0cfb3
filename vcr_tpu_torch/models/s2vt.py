"""S2VT: Sequence-to-Sequence Video-to-Text (Venugopalan et al., arXiv 1505.00487).

PyTorch counterpart of ``vcr_tpu/models/s2vt.py``:

* encode: GRU1 over the N frame features, through the fused GRU kernel
  (``ops.cuda_gru``), with the frame->gates projection as one product.
* prime: GRU2 over [enc_out ; zero word embedding] for all N steps, keeping
  only its final state; only the first H rows of GRU2's W_ih meet non-zero
  input, so only they are multiplied.
* decode: L steps where GRU1 sees a zero frame (its input gates are the
  constant b_ih) and GRU2 sees [GRU1 out ; word embedding]; linear -> vocab
  logits. At eval the argmax feeds back (greedy).

Training (``train=True``, teacher tokens ``s``): encode and prime go through
B1's differentiable sequence (``cuda_gru.GruSequence``). Each decode step
takes the teacher token or the argmax for the whole batch by one coin
(``coin < teacher_force_prob``), with dropout on the word embedding and on
GRU2's output before the vocab product. Where ``teacher_force_prob`` is a
Python number >= 1.0 the logits never feed back, so the hoisted form runs:
the embeddings and their dropout before the loop, a loop that emits only
GRU2's states, then one (L·B, H) @ (H, V) product with its dropout and the
pad mask.

Randomness: ``rng`` is an int seed, or a ``torch.Generator`` that the caller
has already drawn from (RationaleNet passes its own). A call draws all of its
random numbers before the recurrences, from one generator on the features'
device, in this order (:func:`draw_train_noise`): the L coins, the (L, B, E)
embedding keep-masks, the (L, B, H) output keep-masks (the masks only where
``dropout_p`` > 0). Both forms read the same tensors, so they agree for one
seed. Nothing is drawn inside a region that ``torch.utils.checkpoint``
replays: it restores the global RNG state, never a ``Generator``. A forward
checkpointed whole builds its generator anew from the seed, so its replay
draws the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from vcr_tpu_torch.models import base
from vcr_tpu_torch.nn.layers import (apply_keep_mask, dense, dense_init, embed,
                                     embedding_init, keep_mask, mask_vocab_pad,
                                     vocab_argmax, vdot)
from vcr_tpu_torch.nn.rnn import gru_gates, gru_init
from vcr_tpu_torch.ops.cuda_gru import gru_sequence_fused
from vcr_tpu_torch.utils.profiling import span

Rng = Union[int, torch.Generator, None]


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``."""
    return {
        "embedding": embedding_init(glove_vectors, spec.padded_vocab_size),
        "rnn1": gru_init(gen, spec.vid_feat_size, spec.hidden_size),
        "rnn2": gru_init(gen, spec.hidden_size + spec.embed_size, spec.hidden_size),
        "linear": dense_init(gen, spec.hidden_size, spec.padded_vocab_size),
    }


def encode(params, spec: base.ModelSpec, vid_feats: torch.Tensor):
    """vid_feats (B, N, V) -> (enc_outs (N, B, H), state1 (B, H))."""
    xs = vid_feats.transpose(0, 1)
    return gru_sequence_fused(params["rnn1"], xs, compute_dtype=spec.cdtype)


def encode_step(params, spec: base.ModelSpec, vid_feat: torch.Tensor,
                state: torch.Tensor):
    """One GRU1 step (B, V), (B, H) -> (out, state), both the new h:
    SpatialNet's encoder, which feeds each frame's attended context."""
    rnn = params["rnn1"]
    h = gru_gates(vdot(vid_feat, rnn["w_ih"], spec.cdtype) + rnn["b_ih"], state, rnn,
                  spec.cdtype)
    return h, h


def _prime_state2(params, spec: base.ModelSpec, enc_outs: torch.Tensor) -> torch.Tensor:
    """Run GRU2 over [enc_outs ; zero word embeddings], keep the final state.
    The zero half contributes nothing to the input projection, so only the
    first H rows of W_ih are multiplied."""
    with span("prime"):
        sliced = dict(params["rnn2"])
        sliced["w_ih"] = params["rnn2"]["w_ih"][: spec.hidden_size]
        _, state2 = gru_sequence_fused(sliced, enc_outs, compute_dtype=spec.cdtype)
    return state2


class TrainNoise(NamedTuple):
    """The random numbers of one train-time decode: ``coins`` (L,) uniform in
    [0, 1); ``emb_keep`` (L, B, E) and ``out_keep`` (L, B, H) dropout keep
    masks, None where ``dropout_p`` is 0."""

    coins: torch.Tensor
    emb_keep: Optional[torch.Tensor]
    out_keep: Optional[torch.Tensor]


def generator_for(rng: Rng, device) -> torch.Generator:
    """``rng`` itself if it is a Generator, else a new one on ``device``
    seeded with it (None: 0)."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(0 if rng is None else int(rng))


def draw_train_noise(gen: torch.Generator, spec: base.ModelSpec, batch: int,
                     device) -> TrainNoise:
    """Draw a train-time decode's random numbers from ``gen``, in the order
    coins, embedding masks, output masks."""
    steps, p = spec.max_len, spec.dropout_p
    coins = torch.rand((steps,), generator=gen, device=device)
    if p <= 0.0:
        return TrainNoise(coins, None, None)
    return TrainNoise(coins,
                      keep_mask((steps, batch, spec.embed_size), p, gen, device),
                      keep_mask((steps, batch, spec.hidden_size), p, gen, device))


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float,
             step: Optional[int] = None) -> torch.Tensor:
    """x through the keep-mask ``keep`` (of one decode step where ``step`` is
    given); unchanged where there is no mask."""
    if keep is None:
        return x
    return apply_keep_mask(x, keep if step is None else keep[step], rate)


def decode(params, spec: base.ModelSpec, enc_outs: torch.Tensor,
           state1: torch.Tensor, s: Optional[torch.Tensor] = None, rng: Rng = None,
           train: bool = False, teacher_force_prob=1.0, emit: str = "logits",
           noise: Optional[TrainNoise] = None) -> torch.Tensor:
    """-> logits (B, L, vocab) or greedy tokens (B, L) int32."""
    state2 = _prime_state2(params, spec, enc_outs)
    return decode_from_states(params, spec, state1, state2, s, rng=rng, train=train,
                              teacher_force_prob=teacher_force_prob, emit=emit,
                              noise=noise)


def _check_call(s: Optional[torch.Tensor], train: bool, emit: str) -> None:
    if emit not in ("logits", "tokens"):
        raise ValueError(f"emit must be 'logits' or 'tokens', got {emit!r}")
    if train and s is None:
        raise ValueError("the train-time decode needs the teacher tokens s (B, L)")


def decode_from_states(params, spec: base.ModelSpec, state1: torch.Tensor,
                       state2: torch.Tensor, s: Optional[torch.Tensor] = None,
                       rng: Rng = None, train: bool = False, teacher_force_prob=1.0,
                       emit: str = "logits",
                       noise: Optional[TrainNoise] = None) -> torch.Tensor:
    """Decode from the encoder and primed states.
    emit="logits" -> (B, L, padded vocab) float32; "tokens" -> (B, L) int32.

    At train, ``s`` (B, L) holds the teacher tokens; ``noise`` is the call's
    pre-drawn randomness, else it is drawn here from ``rng``."""
    _check_call(s, train, emit)
    b = state1.shape[0]
    cd, p, steps = spec.cdtype, spec.dropout_p, spec.max_len
    rnn1, rnn2 = params["rnn1"], params["rnn2"]
    # GRU1's decode-phase input is a zero frame: its input gates are b_ih
    xg1 = rnn1["b_ih"].expand(b, 3 * spec.hidden_size)
    words = torch.full((b,), spec.sos_id, dtype=torch.int32, device=state1.device)
    if train:
        if noise is None:
            noise = draw_train_noise(generator_for(rng, state1.device), spec, b,
                                     state1.device)
        s_in = torch.cat([words[:, None], s.to(torch.int32)], dim=1)   # (B, L+1)
    else:
        noise = TrainNoise(None, None, None)
    st1, st2, ys = state1, state2, []
    if (train and emit == "logits" and isinstance(teacher_force_prob, (int, float))
            and teacher_force_prob >= 1.0):
        # hoisted: every coin is < 1.0, so the teacher token always wins and
        # the logits never enter the recurrence
        embs = _dropout(embed(params["embedding"], s_in[:, :steps]).transpose(0, 1),
                        noise.emb_keep, p)                              # (L, B, E)
        for t in range(steps):
            st1 = gru_gates(xg1, st1, rnn1, cd)
            xg2 = vdot(torch.cat([st1, embs[t]], dim=-1), rnn2["w_ih"], cd) + rnn2["b_ih"]
            st2 = gru_gates(xg2, st2, rnn2, cd)
            ys.append(st2)
        dropped = _dropout(torch.stack(ys), noise.out_keep, p)          # (L, B, H)
        logits = mask_vocab_pad(dense(params["linear"], dropped, cd), spec.vocab_size)
        return logits.transpose(0, 1)
    for t in range(steps):
        with span("decode.cell"):
            st1 = gru_gates(xg1, st1, rnn1, cd)
            emb = _dropout(embed(params["embedding"], words), noise.emb_keep, p, t)
            xg2 = vdot(torch.cat([st1, emb], dim=-1), rnn2["w_ih"], cd) + rnn2["b_ih"]
            st2 = gru_gates(xg2, st2, rnn2, cd)
            out = _dropout(st2, noise.out_keep, p, t)
            logits = mask_vocab_pad(dense(params["linear"], out, cd), spec.vocab_size)
        with span("decode.pick"):
            words = vocab_argmax(logits)
            ys.append(words if emit == "tokens" else logits)
            if train:
                words = torch.where(noise.coins[t] < teacher_force_prob, s_in[:, t + 1],
                                    words)
    return torch.stack(ys, dim=1)


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          s: Optional[torch.Tensor] = None, s_len: Optional[torch.Tensor] = None,
          rng: Rng = None, train: bool = False, teacher_force_prob=1.0,
          emit: str = "logits") -> torch.Tensor:
    """The full forward: vid_feats (B, N, V) -> logits (B, L, vocab) or
    greedy tokens (B, L). ``s_len`` is unused, as in the JAX package."""
    del s_len
    _check_call(s, train, emit)
    noise = (draw_train_noise(generator_for(rng, vid_feats.device), spec,
                              vid_feats.shape[0], vid_feats.device) if train else None)
    # features enter at the compute precision, as in the JAX package
    with span("encode"):
        vid_feats = vid_feats.to(spec.cdtype)
        enc_outs, state1 = encode(params, spec, vid_feats)
    return decode(params, spec, enc_outs, state1, s, train=train,
                  teacher_force_prob=teacher_force_prob, emit=emit, noise=noise)


base.register("s2vt", init_params, apply)
