"""S2VT with Bahdanau temporal attention: the counterpart of
``vcr_tpu/models/s2vt_att.py`` (the reference's S2VTAttModel).

* encode: one GRU over the frames through kernel B1 (``ops.cuda_gru``, one
  launch, differentiable through ``cuda_gru.GruSequence``) -> (encoder_outs
  (B, N, H), final (B, H)).
* decode: the state starts at the encoder's final state; the keys are
  projected once per sequence; each step attends with the *previous* decoder
  state, feeds [context ; word embedding] to the decoder GRU, then dropout
  and the vocab product. Greedy at eval; at train always teacher-forced:
  this model has no scheduled sampling, so no coin is drawn.

Training runs the recurrence through :class:`AttentionScan`, whose backward
is scheduled by hand as the JAX package's ``_attention_scan`` custom VJP: a
reverse loop recomputes each step's attention and carries only (B, H)
cotangents and parameter-gradient sums; the two (B, N, H) gradients are
rebuilt after it. The vocab product runs once after the recurrence, (L·B, H)
@ (H, V). The plain loop under autograd is the tests' oracle only.

Randomness: the train branch's one draw, the (L, B, H) dropout keep-mask on
the decoder states, comes from a generator on the features' device (an int
seed, or a ``torch.Generator`` the caller has drawn from), before the
encoder runs, where ``dropout_p`` > 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from vcr_tpu_torch.models import base
from vcr_tpu_torch.models.s2vt import Rng, _check_call, generator_for
from vcr_tpu_torch.nn.attention import (bahdanau_attend, bahdanau_context, bahdanau_init,
                                        bahdanau_project_keys, bahdanau_scores)
from vcr_tpu_torch.nn.layers import (apply_keep_mask, dense, dense_init, embed,
                                     embedding_init, keep_mask, mask_vocab_pad,
                                     vocab_argmax, vdot)
from vcr_tpu_torch.nn.rnn import gate_remat_default, gru_gates, gru_init
from vcr_tpu_torch.ops.cuda_gru import gru_sequence_fused
from vcr_tpu_torch.utils.profiling import span


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``."""
    return {
        "encoder": {"rnn": gru_init(gen, spec.vid_feat_size, spec.hidden_size)},
        "decoder": {
            "embedding": embedding_init(glove_vectors, spec.padded_vocab_size),
            "rnn": gru_init(gen, spec.hidden_size + spec.embed_size, spec.hidden_size),
            "attention": bahdanau_init(gen, spec.hidden_size),
            "pred_linear": dense_init(gen, spec.hidden_size, spec.padded_vocab_size),
        },
    }


def encode(params, spec: base.ModelSpec, vid_feats: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vid_feats (B, N, V) -> (encoder_outs (B, N, H), encoder_final (B, H)),
    one B1 launch."""
    outs, final = gru_sequence_fused(params["encoder"]["rnn"], vid_feats.transpose(0, 1),
                                     compute_dtype=spec.cdtype)
    return outs.transpose(0, 1), final


def encode_step(params, spec: base.ModelSpec, vid_feat: torch.Tensor,
                state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One encoder step (B, V), (B, H) -> (h, h): SpatialNet's encoder."""
    rnn = params["encoder"]["rnn"]
    h = gru_gates(vdot(vid_feat, rnn["w_ih"], spec.cdtype) + rnn["b_ih"], state, rnn,
                  spec.cdtype)
    return h, h


# ------------------------------------------------ the teacher-forced scan

_RNN_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _gru_in(rnn, context: torch.Tensor, emb: torch.Tensor, state: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """The decoder GRU's step on [context ; emb]."""
    xg = vdot(torch.cat([context, emb], dim=-1), rnn["w_ih"], compute_dtype) + rnn["b_ih"]
    return gru_gates(xg, state, rnn, compute_dtype)


def _step(qv, rnn, proj_key, values, state, emb, compute_dtype):
    """One teacher-forced step -> (new state, scores, context, alphas)."""
    scores = bahdanau_scores(qv, state, proj_key, compute_dtype)
    context, alphas = bahdanau_context(scores, values, compute_dtype)
    return _gru_in(rnn, context, emb, state, compute_dtype), scores, context, alphas


def attention_scan_plain(qv, rnn, proj_key: torch.Tensor, values: torch.Tensor,
                         h0: torch.Tensor, embs: torch.Tensor,
                         compute_dtype: torch.dtype) -> torch.Tensor:
    """The recurrence as a plain loop -> states (L, B, H): the forward of
    :class:`AttentionScan`, and under autograd the tests' oracle."""
    state, states = h0, []
    for emb in embs:
        state = _step(qv, rnn, proj_key, values, state, emb, compute_dtype)[0]
        states.append(state)
    return torch.stack(states)


class AttentionScan(torch.autograd.Function):
    """The teacher-forced decoder recurrence -> states (L, B, H), with the
    JAX package's hand-scheduled backward (``s2vt_att._attention_scan``).

    Inputs: the compute dtype, then the query and energy weights (H, H) and
    (H, 1), the decoder GRU's w_ih, w_hh, b_ih, b_hh, proj_key (B, N, H),
    values (B, N, H), h0 (B, H) and the word embeddings (L, B, E).

    The forward is the plain loop without a tape: it keeps the inputs and
    the states, no (B, N, H) tensor per step. The backward walks the steps
    in reverse: each recomputes its attention from q_t = state_{t-1} and
    takes the step's gradient by ``torch.autograd.grad`` over the same stage
    functions, with proj_key and values as constants, so it carries only
    (B, H) cotangents and parameter-gradient sums. The two (B, N, H)
    gradients are rebuilt after the loop, one step's slice at a time:
    d_values = Σ_t alphas_t ⊗ d_context_t (both rounded to the compute
    dtype, as the forward rounded them) and d_proj_key = Σ_t (1 - tanh²_t) ·
    d_scores_t · v, with v rounded as the forward rounded it.
    """

    @staticmethod
    def forward(ctx, compute_dtype, w_query, w_energy, w_ih, w_hh, b_ih, b_hh,
                proj_key, values, h0, embs):
        qv = {"query_layer": {"w": w_query}, "energy_layer": {"w": w_energy}}
        rnn = dict(zip(_RNN_KEYS, (w_ih, w_hh, b_ih, b_hh)))
        states = attention_scan_plain(qv, rnn, proj_key, values, h0, embs, compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(w_query, w_energy, w_ih, w_hh, b_ih, b_hh, proj_key,
                              values, h0, embs, states)
        return states

    @staticmethod
    @once_differentiable
    def backward(ctx, d_states):
        cd = ctx.compute_dtype
        (w_query, w_energy, w_ih, w_hh, b_ih, b_hh, proj_key, values, h0, embs,
         states) = ctx.saved_tensors
        weights = (w_query, w_energy, w_ih, w_hh, b_ih, b_hh)
        d_weights = [torch.zeros_like(w) for w in weights]
        d_state = torch.zeros_like(h0)
        d_embs = torch.empty_like(embs)
        d_scores_a, d_ctx_a, alphas_a = ([None] * len(embs) for _ in range(3))
        with torch.enable_grad(), gate_remat_default(False):
            for t in range(len(embs) - 1, -1, -1):
                leaves = [w.detach().requires_grad_(True) for w in weights]
                q = (h0 if t == 0 else states[t - 1]).detach().requires_grad_(True)
                emb = embs[t].detach().requires_grad_(True)
                qv = {"query_layer": {"w": leaves[0]}, "energy_layer": {"w": leaves[1]}}
                rnn = dict(zip(_RNN_KEYS, leaves[2:]))
                new_state, scores, context, alphas = _step(qv, rnn, proj_key, values, q,
                                                           emb, cd)
                *d_leaves, d_emb, d_q, d_scores, d_context = torch.autograd.grad(
                    new_state, leaves + [emb, q, scores, context],
                    d_state + d_states[t])
                d_weights = [a + b for a, b in zip(d_weights, d_leaves)]
                d_state, d_embs[t] = d_q, d_emb
                d_scores_a[t], d_ctx_a[t] = d_scores, d_context
                alphas_a[t] = alphas.detach()
        d_values = d_proj_key = None
        if ctx.needs_input_grad[8]:
            # one contraction over the steps, operands rounded as the forward
            # rounded them, float32 sums
            d_values = torch.einsum("tbn,tbd->bnd",
                                    torch.stack(alphas_a).to(cd).float(),
                                    torch.stack(d_ctx_a).to(cd).float()).to(values.dtype)
        if ctx.needs_input_grad[7]:
            # the energy MLP's tanh'/v pullback, one (B, N, H) slice a step:
            # JAX's one-line form would hold (L, B, N, H) float32 tensors
            v = w_energy[:, 0].to(cd).float()
            qp = dense({"w": w_query}, torch.cat([h0[None], states[:-1]]), cd)  # (L, B, H)
            d_proj_key = torch.zeros_like(proj_key, dtype=torch.float32)
            for t in range(len(embs)):
                tanh = torch.tanh(qp[t][:, None, :] + proj_key)
                d_proj_key += (1.0 - tanh * tanh) * (d_scores_a[t][..., None] * v)
            d_proj_key = d_proj_key.to(proj_key.dtype)
        return (None, *d_weights, d_proj_key, d_values, d_state, d_embs)


def attention_scan(qv, rnn, proj_key: torch.Tensor, values: torch.Tensor,
                   h0: torch.Tensor, embs: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """:class:`AttentionScan` on the parameter dicts -> states (L, B, H)."""
    return AttentionScan.apply(compute_dtype, qv["query_layer"]["w"],
                               qv["energy_layer"]["w"], *(rnn[k] for k in _RNN_KEYS),
                               proj_key, values, h0, embs)


# ---------------------------------------------------------------- decode

def draw_train_noise(gen: torch.Generator, spec: base.ModelSpec, batch: int,
                     device) -> Optional[torch.Tensor]:
    """The train branch's draws: the (L, B, H) keep-mask on the decoder
    states, None where ``dropout_p`` is 0."""
    if spec.dropout_p <= 0.0:
        return None
    return keep_mask((spec.max_len, batch, spec.hidden_size), spec.dropout_p, gen, device)


def decode(params, spec: base.ModelSpec, encoder_outs: torch.Tensor,
           encoder_final: torch.Tensor, s: Optional[torch.Tensor] = None,
           rng: Rng = None, train: bool = False, teacher_force_prob=1.0,
           emit: str = "logits", out_keep: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """-> logits (B, L, padded vocab) float32 or greedy tokens (B, L) int32.

    At train, ``s`` (B, L) holds the teacher tokens and ``out_keep`` the
    states' dropout keep-mask (else drawn here from ``rng``);
    ``teacher_force_prob`` is accepted and unused, as in the JAX package."""
    del teacher_force_prob
    _check_call(s, train, emit)
    if train and emit != "logits":
        raise ValueError("emit='tokens' is eval-only")
    dec, cd = params["decoder"], spec.cdtype
    att = dec["attention"]
    b, device = encoder_outs.shape[0], encoder_outs.device
    proj_key = bahdanau_project_keys(att, encoder_outs, cd)
    words = torch.full((b,), spec.sos_id, dtype=torch.int32, device=device)
    if train:
        if out_keep is None:
            out_keep = draw_train_noise(generator_for(rng, device), spec, b, device)
        s_in = torch.cat([words[:, None], s.to(torch.int32)], dim=1)
        embs = embed(dec["embedding"], s_in[:, :spec.max_len]).transpose(0, 1)  # (L, B, E)
        states = attention_scan(att, dec["rnn"], proj_key, encoder_outs, encoder_final,
                                embs, cd)                                     # (L, B, H)
        if out_keep is not None:
            states = apply_keep_mask(states, out_keep, spec.dropout_p)
        logits = mask_vocab_pad(dense(dec["pred_linear"], states, cd), spec.vocab_size)
        return logits.transpose(0, 1)
    # the values are read only through the context product's rounding, so
    # round them once here: the same bits
    values = encoder_outs.to(cd)
    state, ys = encoder_final, []
    for _ in range(spec.max_len):
        context, _ = bahdanau_attend(att, state, proj_key, values, cd)
        state = _gru_in(dec["rnn"], context, embed(dec["embedding"], words), state, cd)
        logits = mask_vocab_pad(dense(dec["pred_linear"], state, cd), spec.vocab_size)
        words = vocab_argmax(logits)
        ys.append(words if emit == "tokens" else logits)
    return torch.stack(ys, dim=1)


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          s: Optional[torch.Tensor] = None, s_len: Optional[torch.Tensor] = None,
          rng: Rng = None, train: bool = False, teacher_force_prob=1.0,
          emit: str = "logits") -> torch.Tensor:
    """The full forward: vid_feats (B, N, V) -> logits (B, L, vocab) or
    greedy tokens (B, L). ``s_len`` and ``teacher_force_prob`` are unused,
    as in the JAX package."""
    del s_len
    _check_call(s, train, emit)
    out_keep = (draw_train_noise(generator_for(rng, vid_feats.device), spec,
                                 vid_feats.shape[0], vid_feats.device) if train else None)
    # features enter at the compute precision, as in the JAX package
    with span("encode"):
        encoder_outs, encoder_final = encode(params, spec, vid_feats.to(spec.cdtype))
    return decode(params, spec, encoder_outs, encoder_final, s, train=train,
                  teacher_force_prob=teacher_force_prob, emit=emit, out_keep=out_keep)


base.register("s2vt-att", init_params, apply)
