"""On-card checks of the port, one PASS/FAIL row each: the counterpart of
``tpu_checks.py``'s rows on the port's surface.

    python -m vcr_tpu_torch.checks            # on the card
    python -m vcr_tpu_torch.checks --device cpu   # a dry run of the harness

Each row runs the port's card path and holds it against its plain or
reference form at ``tpu_checks.py``'s sizes and bounds:

* the GRU (B1) forward and gradient, the LSTM (B2) both ways and the BiLSTM
  against the plain recurrences, float32;
* the Transformer's lineage bookkeeping against a physical reorder, bit for
  bit (bf16 and int8 caches), and the lineage against the gather stepper in
  lockstep (logit gap < 0.5);
* a serving artifact's replay on the card against the live call;
* the hoisted teacher-forced decode against the general one;
* the slot pool against the batch decodes: the Transformer's greedy,
  S2VT's beam 3, per-request sampling with a cancellation, and bf16
  S2VT-att (all served, >= 3 of 5 rows exact, agreement >= 0.6);
* the quantized modes: the int8 KV-cache pool (served, lockstep envelope
  against bf16 < 0.5), the int8 and int4 batch greedy (envelopes 0.5 and
  2.5), the frozen int8 pool artifact against the live pool, int8 decode
  weights (envelope 0.5; pool = batch within the mode for the Transformer,
  the agreement rule for S2VT);
* training: the bf16 Transformer step against the same step in float32,
  and gate remat against the default step.

The card runs those sizes. ``--device cpu`` runs every row at small widths
through the plain versions: it checks the harness, as the JAX script's
``VCR_CHECKS_FORCE=1`` did, and says nothing of the card. Without a card
and without ``--device cpu`` the script exits 2. It exits 0 only when every
row passes, and 1 otherwise.

Two of ``tpu_checks.py``'s rows have a different counterpart here:

* the int8 KV-cache pool's gap between the masked and the scatter cache
  writes: the port has one write form (``VCR_SLOT_WRITE`` is not ported),
  so the row holds what is left, all served and the envelope;
* the bf16 residual stream against ``VCR_TF_F32_STREAM=1``: the port has no
  float32-stream switch, so the bf16 step is held to the same step in
  float32 within the JAX row's envelope (loss 5e-2 relative, parameters
  5e-3), and gate remat, whose JAX switch is ``VCR_GRU_GATES_REMAT``, runs
  through ``build_step_fns(remat=True)``.
"""

from __future__ import annotations

import argparse
import functools
import sys
import tempfile
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Dims:
    rnn: Tuple[int, int, int, int]  # T, B, I, H of the recurrence rows
    vocab: int
    embed: int
    hidden: int                     # the big models' H
    small_hidden: int               # the pool rows' S2VT H
    feat: int                       # S2VT's feature width
    tf_feat: int                    # the Transformer's
    frames: int
    max_len: int                    # the big Transformer's and S2VT's L
    pool_len: int                   # the pool rows' L
    tf_layers: int                  # the big Transformer's layers
    tf_heads: int
    small_layers: int
    small_heads: int


# tpu_checks.py's sizes, on the card
CARD = Dims(rnn=(12, 256, 64, 512), vocab=512, embed=300, hidden=512, small_hidden=256,
            feat=512, tf_feat=4096, frames=8, max_len=12, pool_len=10, tf_layers=6,
            tf_heads=8, small_layers=2, small_heads=4)
# the dry run's, on the CPU
DRY = Dims(rnn=(5, 6, 8, 16), vocab=40, embed=8, hidden=16, small_hidden=16, feat=12,
           tf_feat=12, frames=4, max_len=5, pool_len=5, tf_layers=1, tf_heads=2,
           small_layers=1, small_heads=2)


def close(got, want, atol: float = 5e-4, rtol: float = 2e-3) -> Tuple[bool, str]:
    """tpu_checks.py's tolerance: float32 sums in other orders."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
    return ok, f"maxdiff={(got - want).abs().max().item():.2e}"


def truncate(row, eos: int) -> np.ndarray:
    row = np.asarray(row)
    hits = np.nonzero(row == eos)[0]
    return row[: hits[0] + 1] if len(hits) else row


def agreement(got: dict, want_rows, eos: int) -> Tuple[int, float, List[str]]:
    """(rows exactly equal, token agreement over each row's common prefix
    length, forensics lines) of a pool's captions against batch rows."""
    exact, n_eq, n_all, notes = 0, 0, 0, []
    for key, row in enumerate(want_rows):
        want, have = truncate(row, eos), np.asarray(got[key])
        n = min(len(have), len(want))
        n_eq += int((have[:n] == want[:n]).sum())
        n_all += n
        if np.array_equal(have, want):
            exact += 1
        else:
            notes.append(f"key {key}: pool={have.tolist()} vs batch={want.tolist()}")
    return exact, n_eq / max(n_all, 1), notes


class Checks:
    """The rows, over models built once and shared between rows."""

    def __init__(self, device: torch.device, dims: Dims):
        self.device, self.d = device, dims
        self.rng = np.random.default_rng(0)

    # ------------------------------------------------------------ models

    def spec(self, arch: str, **kw):
        from vcr_tpu_torch.models import base

        d = self.d
        fields = dict(arch=arch, vocab_size=d.vocab, embed_size=d.embed,
                      hidden_size=d.hidden, vid_feat_size=d.feat, max_len=d.max_len,
                      num_frames=d.frames, dropout_p=0.0, sos_id=d.vocab - 4,
                      compute_dtype="float32")
        fields.update(kw)
        return base.ModelSpec(**fields)

    def params(self, spec, seed: int):
        from vcr_tpu_torch.device import params_to
        from vcr_tpu_torch.models import base

        glove = self.rng.standard_normal((spec.vocab_size, spec.embed_size)).astype(
            np.float32)
        init_fn, _ = base.build_model(spec.arch)
        return params_to(init_fn(torch.Generator().manual_seed(seed), spec, glove),
                         self.device)

    def feats(self, b: int, width: int) -> torch.Tensor:
        return torch.from_numpy(self.rng.standard_normal(
            (b, self.d.frames, width)).astype(np.float32)).to(self.device)

    @property
    def eos(self) -> int:
        return self.d.vocab - 3

    @functools.cached_property
    def big_tf(self):
        """The bf16 Transformer of the lineage and quantized rows, B=8, with
        its encoder outputs."""
        from vcr_tpu_torch.models import transformer as tr

        d = self.d
        spec = self.spec("transformer", vid_feat_size=d.tf_feat, compute_dtype="bfloat16",
                         vocab_pad_to=128, tf_layers=d.tf_layers, tf_heads=d.tf_heads)
        params = self.params(spec, 3)
        x = self.feats(8, d.tf_feat).to(torch.bfloat16)
        with torch.inference_mode():
            e_out = tr.encode(params, spec, x, tr.create_masks_inp(x))
        return spec, params, x, e_out

    @functools.cached_property
    def small_tf(self):
        """The float32 Transformer of the pool rows (tpu_checks.py's cspec),
        six videos."""
        d = self.d
        spec = self.spec("transformer", vid_feat_size=d.tf_feat, max_len=d.pool_len,
                         tf_layers=d.small_layers, tf_heads=d.small_heads)
        return spec, self.params(spec, 7), self.feats(6, d.tf_feat)

    @functools.cached_property
    def small_s2vt(self):
        """The float32 S2VT of the beam and sampling pool rows, five videos."""
        d = self.d
        spec = self.spec("s2vt", hidden_size=d.small_hidden, max_len=d.pool_len)
        return spec, self.params(spec, 8), self.feats(5, d.feat)

    def pool(self, params, spec, **kw):
        from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

        return ContinuousCaptioner(params, spec, eos_id=self.eos, device=self.device,
                                   **kw)

    def tf_pool_rows(self, params, spec, feats, decode_weights=None):
        """The Transformer's batch fast greedy rows of ``feats``."""
        from vcr_tpu_torch.models import transformer as tr

        with torch.inference_mode():
            e_out = tr.encode(params, spec, feats, tr.create_masks_inp(feats))
            return tr.decode_greedy_fast(params, spec, e_out,
                                         decode_weights=decode_weights).cpu().numpy()

    def lockstep_gap(self, step_a, state_a, step_b, state_b, rows: int, length: int,
                     slot: bool = False) -> float:
        """Two steppers fed the same words (the second one's argmax) ->
        the largest |logit difference| over the steps."""
        sos = self.d.vocab - 4
        words = torch.full((rows,), sos, dtype=torch.int32, device=self.device)
        gap = 0.0
        with torch.inference_mode():
            for i in range(length):
                pos = (torch.full((rows,), i, dtype=torch.int64, device=self.device)
                       if slot else i)
                state_a, la = step_a(state_a, words, pos)
                state_b, lb = step_b(state_b, words, pos)
                gap = max(gap, (la.double() - lb.double()).abs().max().item())
                words = lb.argmax(dim=-1).to(torch.int32)
        return gap

    def lineage_beam(self, kv_cache, physical: bool):
        from vcr_tpu_torch import decode
        from vcr_tpu_torch.models import transformer as tr

        spec, params, x, e_out = self.big_tf
        with torch.inference_mode():
            step_fn, init, reorder = tr.make_cached_stepper(
                params, spec, e_out, beam_tile=5, lineage=True, kv_cache=kv_cache)
            if physical:
                identity = init["anc"]

                def reorder(state, flat_src):  # noqa: F811
                    moved = decode.gather_rows(
                        {n: v for n, v in state.items() if n != "anc"}, flat_src)
                    return dict(moved, anc=identity)
            return decode.beam_search(step_fn, init, x.shape[0], 5, spec.max_len,
                                      spec.sos_id, self.eos, reorder_fn=reorder)

    # -------------------------------------------------------------- rows

    def rows(self) -> List[Tuple[str, Callable[[], Tuple[bool, str]]]]:
        return [
            ("gru fwd outs and h_last", self.gru_forward),
            ("gru grad", self.gru_grad),
            ("lstm rev=False outs and c_last", lambda: self.lstm(False)),
            ("lstm rev=True outs and c_last", lambda: self.lstm(True)),
            ("bilstm outs", self.bilstm),
            ("lineage bookkeeping = physical reorder (bf16, bit-exact)",
             lambda: self.bookkeeping(None)),
            ("lineage vs gather stepper envelope (bf16, < 0.5)", self.lineage_envelope),
            ("serving artifact replay on the device", self.artifact_replay),
            ("hoisted decode = general decode", self.hoisted),
            ("continuous serving = fast greedy", self.continuous_greedy),
            ("int8 KV-cache pool (served, bf16 envelope < 0.5)", self.int8_pool),
            ("continuous beam = batch beam", self.continuous_beam),
            ("per-request sampling + cancel", self.sampling_cancel),
            ("bf16 s2vt-att continuous vs batch greedy", self.att_pool),
            ("int8 batch fast greedy (envelope < 0.5)", lambda: self.kv_greedy("int8", 0.5)),
            ("int4 batch fast greedy (envelope < 2.5)", lambda: self.kv_greedy("int4", 2.5)),
            ("int8 lineage bookkeeping = physical reorder (bit-exact)",
             lambda: self.bookkeeping("int8")),
            ("frozen int8 artifact = live int8 pool", self.frozen_int8),
            ("int8 decode weights batch fast greedy (envelope < 0.5)", self.w8_greedy),
            ("int8-weight pool = batch W8 greedy (token-exact)", self.w8_pool),
            ("s2vt int8-weight pool vs batch W8 beam-1", self.w8_s2vt_pool),
            ("bf16 train step vs float32 (loss 5e-2, params 5e-3)", self.bf16_train),
            ("gate remat = default train step", self.gate_remat),
        ]

    def gru_forward(self):
        from vcr_tpu_torch.nn import rnn
        from vcr_tpu_torch.ops import cuda_gru

        t, b, i, h = self.d.rnn
        gp = {k: v.to(self.device) for k, v in
              rnn.gru_init(torch.Generator().manual_seed(0), i, h).items()}
        xs = torch.randn((t, b, i), generator=torch.Generator().manual_seed(1)).to(
            self.device)
        with torch.no_grad():
            got = cuda_gru.gru_sequence_fused(gp, xs, compute_dtype=torch.float32)
            want = rnn.gru_sequence(gp, xs, compute_dtype=torch.float32)
        ok1, d1 = close(got[0], want[0])
        ok2, d2 = close(got[1], want[1])
        return ok1 and ok2, f"outs {d1}, h_last {d2}"

    def gru_grad(self):
        from vcr_tpu_torch.nn import rnn
        from vcr_tpu_torch.ops import cuda_gru

        t, b, i, h = self.d.rnn
        gp = {k: v.to(self.device).requires_grad_(True) for k, v in
              rnn.gru_init(torch.Generator().manual_seed(0), i, h).items()}
        xs = torch.randn((t, b, i), generator=torch.Generator().manual_seed(1)).to(
            self.device)
        names = sorted(gp)

        def grads(seq):
            out = seq(gp, xs, compute_dtype=torch.float32)[0]
            return torch.autograd.grad((out ** 2).sum(), [gp[k] for k in names])

        got, want = grads(cuda_gru.gru_sequence_fused), grads(rnn.gru_sequence)
        res = [close(g, w, atol=5e-2, rtol=5e-3) for g, w in zip(got, want)]
        return all(r[0] for r in res), ", ".join(f"{k} {r[1]}" for k, r in zip(names, res))

    def _lstm_setup(self, bi: bool = False):
        from vcr_tpu_torch.nn import rnn

        t, b, i, h = self.d.rnn
        init = rnn.bilstm_init if bi else rnn.lstm_init
        params = init(torch.Generator().manual_seed(2 if bi else 1), i, h)
        params = ({d: {k: v.to(self.device) for k, v in p.items()}
                   for d, p in params.items()} if bi
                  else {k: v.to(self.device) for k, v in params.items()})
        xs = torch.randn((t, b, i), generator=torch.Generator().manual_seed(1)).to(
            self.device)
        return params, xs

    def lstm(self, reverse: bool):
        from vcr_tpu_torch.nn import rnn
        from vcr_tpu_torch.ops import cuda_lstm

        lp, xs = self._lstm_setup()
        with torch.no_grad():
            p_outs, (_, p_c) = cuda_lstm.lstm_sequence_fused(
                lp, xs, reverse=reverse, compute_dtype=torch.float32)
            r_outs, (_, r_c) = rnn.lstm_sequence(lp, xs, reverse=reverse,
                                                 compute_dtype=torch.float32)
        ok1, d1 = close(p_outs, r_outs)
        ok2, d2 = close(p_c, r_c)
        return ok1 and ok2, f"outs {d1}, c_last {d2}"

    def bilstm(self):
        from vcr_tpu_torch.nn import rnn
        from vcr_tpu_torch.ops import cuda_lstm

        bp, xs = self._lstm_setup(bi=True)
        with torch.no_grad():
            return close(cuda_lstm.bilstm_sequence_fused(bp, xs, compute_dtype=torch.float32),
                         rnn.bilstm_sequence(bp, xs, compute_dtype=torch.float32))

    def bookkeeping(self, kv_cache):
        tok_a, sc_a = self.lineage_beam(kv_cache, physical=False)
        tok_p, sc_p = self.lineage_beam(kv_cache, physical=True)
        ok = bool(torch.equal(tok_a, tok_p) and torch.equal(sc_a, sc_p))
        differ = int((tok_a != tok_p).sum())
        return ok, f"{differ}/{tok_a.numel()} token cells differ"

    def lineage_envelope(self):
        from vcr_tpu_torch import decode
        from vcr_tpu_torch.models import transformer as tr

        spec, params, x, e_out = self.big_tf
        k, b = 5, x.shape[0]
        with torch.inference_mode():
            tok_l, _ = decode.transformer_beam_decode_fast(params, spec, x, k, self.eos,
                                                           lineage=True)
            tok_g, _ = decode.transformer_beam_decode_fast(params, spec, x, k, self.eos)
            step_l, st_l, reorder_l = tr.make_cached_stepper(params, spec, e_out,
                                                             beam_tile=k, lineage=True)
            step_g, st_g = tr.make_cached_stepper(params, spec, e_out, beam_tile=k)
            gen = torch.Generator(device=self.device).manual_seed(42)
            gap = 0.0
            for i in range(spec.max_len):
                words = torch.randint(0, spec.vocab_size, (b * k,), generator=gen,
                                      device=self.device, dtype=torch.int32)
                if i > 0:
                    src = torch.randint(0, k, (b, k), generator=gen, device=self.device)
                    flat = (torch.arange(b, device=self.device)[:, None] * k
                            + src).reshape(-1)
                    st_l, st_g = reorder_l(st_l, flat), decode.gather_rows(st_g, flat)
                st_l, lg_l = step_l(st_l, words, i)
                st_g, lg_g = step_g(st_g, words, i)
                gap = max(gap, (lg_l.double() - lg_g.double()).abs().max().item())
        flips = int((tok_l != tok_g).sum())
        return gap < 0.5, (f"max lockstep logit gap {gap:.3e}; token cells differing "
                           f"{flips}/{tok_l.numel()} (near-tie flips expected)")

    def artifact_replay(self):
        from vcr_tpu_torch import export_serving, serving

        spec = self.spec("s2vt", compute_dtype="bfloat16", vocab_pad_to=128)
        params = self.params(spec, 4)
        x = self.feats(4, self.d.feat)
        with tempfile.TemporaryDirectory() as td:
            export_serving.export_captioner(_to_cpu(params), spec, td, eos_id=self.eos,
                                            device="cpu")
            art = export_serving.load_artifact(td, device=self.device)
            got = art.caption(x)
        live = serving.build_captioner(params, spec, eos_id=self.eos, device=self.device)
        want = live(x)
        same = bool(torch.equal(got.cpu(), want.cpu()))
        return same, f"{int((got.cpu() != want.cpu()).sum())} token cells differ"

    def hoisted(self):
        from vcr_tpu_torch.models import s2vt

        spec = self.spec("s2vt", dropout_p=0.2, vocab_pad_to=128)
        params = self.params(spec, 5)
        x = self.feats(16, self.d.feat)
        s = torch.from_numpy(self.rng.integers(0, spec.vocab_size,
                                               (16, spec.max_len)).astype(np.int32)
                             ).to(self.device)
        with torch.no_grad():
            hoisted = s2vt.apply(params, spec, x, s, rng=6, train=True,
                                 teacher_force_prob=1.0)
            general = s2vt.apply(params, spec, x, s, rng=6, train=True,
                                 teacher_force_prob=torch.tensor(1.0))
        return close(hoisted, general)

    def continuous_greedy(self):
        spec, params, feats = self.small_tf
        want = self.tf_pool_rows(params, spec, feats)
        got = self.pool(params, spec, slots=3, admit_chunk=2, step_chunk=3).caption_all(
            {i: feats[i].cpu().numpy() for i in range(6)})
        exact, _, notes = agreement(got, want, self.eos)
        return exact == 6, "; ".join(notes) or "6/6 rows equal"

    @functools.cached_property
    def int8_captions(self):
        spec, params, feats = self.small_tf
        return self.pool(params, spec, slots=3, admit_chunk=2, step_chunk=3,
                         kv_cache="int8").caption_all(
            {i: feats[i].cpu().numpy() for i in range(6)})

    def int8_pool(self):
        from vcr_tpu_torch.models import transformer as tr

        spec, params, feats = self.small_tf
        got = self.int8_captions
        served = set(got) == set(range(6)) and all(
            1 <= len(t) <= spec.max_len for t in got.values())
        with torch.inference_mode():
            e_out = tr.encode(params, spec, feats, tr.create_masks_inp(feats))
            qstep, qinit, qcross = tr.make_slot_stepper(params, spec, kv_cache="int8")
            fstep, finit, fcross = tr.make_slot_stepper(params, spec)
            gap = self.lockstep_gap(qstep, {**qinit(6), **qcross(e_out)},
                                    fstep, {**finit(6), **fcross(e_out)}, 6, spec.max_len,
                                    slot=True)
        return served and gap < 0.5, f"served {served}, envelope {gap:.3f}"

    def continuous_beam(self):
        from vcr_tpu_torch import decode

        spec, params, feats = self.small_s2vt
        with torch.inference_mode():
            toks, _ = decode.decode_tokens(params, spec, feats, self.eos, beam_size=3)
        got = self.pool(params, spec, slots=2, admit_chunk=1, step_chunk=2,
                        beam_size=3).caption_all({i: feats[i].cpu().numpy()
                                                  for i in range(5)})
        exact, _, notes = agreement(got, toks[:, 0].cpu().numpy(), self.eos)
        return exact == 5, "; ".join(notes) or "5/5 rows equal"

    def sampling_cancel(self):
        from vcr_tpu_torch import decode

        spec, params, feats = self.small_s2vt
        with torch.inference_mode():
            toks, _ = decode.decode_tokens(params, spec, feats, self.eos, beam_size=1)
        rows = toks[:, 0].cpu().numpy()
        pool = self.pool(params, spec, slots=2, admit_chunk=1, step_chunk=2,
                         request_sampling=True, rng=9)
        f = feats.cpu().numpy()

        def requests():
            yield 0, f[0], {"top_k": 1}
            yield 1, f[1], {"top_k": 1}
            yield "hot", f[2], {"temperature": 4.0, "top_p": 0.9}
            yield 3, f[3], {"top_k": 1}

        got = dict(pool.caption_stream(requests(),
                                       poll_cancelled=lambda outstanding: {3} & outstanding))
        cancel_ok = 3 not in got and pool.stats["cancelled"] == 1
        hot_ok = "hot" in got and 1 <= len(got["hot"]) <= spec.max_len
        exact, _, notes = agreement({k: got[k] for k in (0, 1)}, rows[:2], self.eos)
        return (cancel_ok and hot_ok and exact == 2,
                f"cancelled {cancel_ok}, hot row {hot_ok}, greedy rows {exact}/2"
                + ("; " + "; ".join(notes) if notes else ""))

    def att_pool(self):
        from vcr_tpu_torch import decode

        d = self.d
        spec = self.spec("s2vt-att", hidden_size=d.small_hidden, max_len=d.pool_len,
                         compute_dtype="bfloat16")
        params = self.params(spec, 10)
        feats = self.feats(5, d.feat)
        with torch.inference_mode():
            toks, _ = decode.decode_tokens(params, spec, feats, self.eos, beam_size=1)
        got = self.pool(params, spec, slots=2, admit_chunk=2, step_chunk=2).caption_all(
            {i: feats[i].cpu().numpy() for i in range(5)})
        exact, agree, notes = agreement(got, toks[:, 0].cpu().numpy(), self.eos)
        ok = set(got) == set(range(5)) and exact >= 3 and agree >= 0.6
        return ok, f"{exact}/5 rows exact, agreement {agree:.2f}" + (
            "; " + "; ".join(notes) if notes else "")

    def kv_greedy(self, kv_cache: str, bound: float):
        from vcr_tpu_torch.models import transformer as tr

        spec, params, x, e_out = self.big_tf
        with torch.inference_mode():
            q_step, q_state = tr.make_cached_stepper(params, spec, e_out, kv_cache=kv_cache)
            b_step, b_state = tr.make_cached_stepper(params, spec, e_out)
            gap = self.lockstep_gap(q_step, q_state, b_step, b_state, x.shape[0],
                                    spec.max_len)
            toks = tr.decode_greedy_fast(params, spec, e_out, kv_cache=kv_cache)
        ok = (gap < bound and tuple(toks.shape) == (x.shape[0], spec.max_len)
              and bool((toks >= 0).all()))
        return ok, f"lockstep envelope {gap:.3f}"

    def frozen_int8(self):
        from vcr_tpu_torch import export_continuous

        spec, params, feats = self.small_tf
        with tempfile.TemporaryDirectory() as td:
            export_continuous.export_continuous(_to_cpu(params), spec, td, slots=3,
                                                admit_chunk=2, step_chunk=3,
                                                eos_id=self.eos, kv_cache="int8",
                                                device="cpu")
            art = export_continuous.load_continuous(td, device=self.device)
            got = art.caption_all({i: feats[i].cpu().numpy() for i in range(6)})
        live = self.int8_captions
        exact = sum(np.array_equal(got[k], live[k]) for k in live)
        return set(got) == set(live) and exact == len(live), f"{exact}/6 rows equal"

    def w8_greedy(self):
        from vcr_tpu_torch.models import transformer as tr

        spec, params, x, e_out = self.big_tf
        with torch.inference_mode():
            qparams = tr.quantize_decoder_params(params)
            w_step, w_state = tr.make_cached_stepper(qparams, spec, e_out,
                                                     decode_weights="int8")
            b_step, b_state = tr.make_cached_stepper(params, spec, e_out)
            gap = self.lockstep_gap(w_step, w_state, b_step, b_state, x.shape[0],
                                    spec.max_len)
            toks = tr.decode_greedy_fast(qparams, spec, e_out, decode_weights="int8")
        ok = (gap < 0.5 and tuple(toks.shape) == (x.shape[0], spec.max_len)
              and bool((toks >= 0).all()))
        return ok, f"lockstep envelope {gap:.3f}"

    def w8_pool(self):
        from vcr_tpu_torch.models import transformer as tr

        spec, params, feats = self.small_tf
        got = self.pool(params, spec, slots=3, admit_chunk=2, step_chunk=3,
                        decode_weights="int8").caption_all(
            {i: feats[i].cpu().numpy() for i in range(6)})
        want = self.tf_pool_rows(tr.quantize_decoder_params(params), spec, feats,
                                 decode_weights="int8")
        exact, _, notes = agreement(got, want, self.eos)
        return exact == 6, "; ".join(notes) or "6/6 rows equal"

    def w8_s2vt_pool(self):
        from vcr_tpu_torch import decode

        d = self.d
        spec = self.spec("s2vt", hidden_size=d.small_hidden, max_len=d.pool_len,
                         compute_dtype="bfloat16")
        params = self.params(spec, 13)
        feats = self.feats(5, d.feat)
        with torch.inference_mode():
            toks, _ = decode.decode_tokens(params, spec, feats, self.eos, beam_size=1,
                                           decode_weights="int8")
        got = self.pool(params, spec, slots=2, admit_chunk=2, step_chunk=2,
                        decode_weights="int8").caption_all(
            {i: feats[i].cpu().numpy() for i in range(5)})
        exact, agree, notes = agreement(got, toks[:, 0].cpu().numpy(), self.eos)
        ok = set(got) == set(range(5)) and exact >= 3 and agree >= 0.6
        return ok, f"{exact}/5 rows exact, agreement {agree:.2f}" + (
            "; " + "; ".join(notes) if notes else "")

    def _train_step(self, spec, params, batch, remat=False):
        from vcr_tpu_torch.device import params_to
        from vcr_tpu_torch.train import optim, step

        opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
        params = params_to({k: _clone(v) for k, v in params.items()}, self.device)
        state = opt.init(params)
        train, _ = step.build_step_fns(spec.arch, spec, opt, remat=remat, static_tf=1.0,
                                       device=self.device)
        params, _, metrics, _ = train(params, state, batch, 12, 1.0)
        return params, float(metrics["loss"])

    def _batch(self, b: int, width: int, length: int):
        return {"vid_feats": self.feats(b, width),
                "sent": torch.from_numpy(self.rng.integers(
                    0, self.d.vocab, (b, length)).astype(np.int32)).to(self.device),
                "sent_len": torch.full((b,), min(6, length), dtype=torch.int32,
                                       device=self.device),
                "valid": torch.ones((b,), device=self.device)}

    def bf16_train(self):
        d = self.d
        kw = dict(vid_feat_size=d.tf_feat, max_len=d.pool_len, dropout_p=0.2,
                  tf_layers=d.small_layers, tf_heads=d.small_heads)
        spec16 = self.spec("transformer", compute_dtype="bfloat16", **kw)
        spec32 = self.spec("transformer", **kw)
        params = self.params(spec16, 11)
        batch = self._batch(8, d.tf_feat, d.pool_len)
        p16, l16 = self._train_step(spec16, params, batch)
        p32, l32 = self._train_step(spec32, params, batch)
        gap = max((a - b).abs().max().item() for a, b in zip(_leaves(p16), _leaves(p32)))
        ok = (np.isfinite(l16) and np.isfinite(l32)
              and abs(l16 - l32) / max(abs(l32), 1e-6) < 0.05 and gap < 5e-3)
        return ok, f"loss {l16:.4f} vs {l32:.4f}, max param delta {gap:.2e}"

    def gate_remat(self):
        d = self.d
        spec = self.spec("s2vt", dropout_p=0.2, compute_dtype="bfloat16",
                         max_len=d.pool_len)
        params = self.params(spec, 13)
        batch = self._batch(16, d.feat, d.pool_len)
        p0, l0 = self._train_step(spec, params, batch)
        p1, l1 = self._train_step(spec, params, batch, remat=True)
        pairs = list(zip(_leaves(p0), _leaves(p1)))
        bitwise = l0 == l1 and all(torch.equal(a, b) for a, b in pairs)
        gap = max((a - b).abs().max().item() for a, b in pairs)
        return bitwise or gap < 1e-5, f"bitwise={bitwise}, max param delta {gap:.2e}"


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree.detach()]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def run(device, dims: Dims) -> int:
    """Run every row, printing one line each -> 0 if all pass, else 1."""
    checks = Checks(torch.device(device), dims)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ok = True
    try:
        for name, row in checks.rows():
            passed, detail = row()
            print(f"{'PASS' if passed else 'FAIL'}  {name}  {detail}", flush=True)
            ok &= passed
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    print("ALL PASS" if ok else "FAILURES", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the card, at tpu_checks.py's sizes; cpu: a dry "
                        "run of the harness at small widths")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("checks: no CUDA device; these checks run on the card (--device cpu "
                  "is a dry run of the harness)", file=sys.stderr)
            return 2
        return run("cuda", CARD)
    return run("cpu", DRY)


if __name__ == "__main__":
    sys.exit(main())
