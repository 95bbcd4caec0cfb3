"""Benchmark all five captioner families on one card, one JSON line a row.

Counterpart of the JAX package's ``bench_all.py``: the same rows, in its
order and under its metric names (``plan``), each with its MFU (the
products' FLOPs by ``benchutil.flops``, which counts B1-B4 by their
formulas, over the best call, over the card's bf16 peak). The headline
bench stays ``bench`` (the flagship); this gives per-family numbers.

    python -m vcr_tpu_torch.bench_all [--iters 10] [--scale 1] [--tr_batch 512]
        [--sp_batch 64] [--tag T] [--upload_chunk_mb MB]

Rows (``plan``; the batches at ``--scale 1``):

1. S2VT greedy on MSVD-VGG 4096-d features, B=2048, and its serving
   artifact (``export_serving``: a ``torch.export`` program, exported on
   the CPU and replayed on the card; the name keeps JAX's "exported
   StableHLO"; its MFU numerator is the live tokens call's, as the JAX
   row's ``mfu_like``);
2. S2VT-att greedy (MSVD ResNet 512-d), B=1024;
3. the Transformer (MSR-VTT 4096-d): the parity greedy at B=128, the
   KV-cached fast greedy at B=512, beam 5 at B=128 in lineage form and with
   gathered caches, the continuous slot decode at R=512
   (``models.transformer.make_slot_stepper``: one token per row per tick,
   ``iters`` x L ticks) in bf16 and in five quantized (K/V cache, decode
   weights) pairs; S2VT-att's continuous beam 5 at R=64 and the S2VT pool
   in bf16 and int8 weights at R=512 (``iters`` x 10 ticks), the
   Transformer's continuous beam 5 in bf16 and int8 K/V at R=64 (``iters``
   ticks); then the parity beam 5 at B=32;
4. RationaleNet over S2VT, B=1024, and SpatialNet over S2VT on YOLO grid
   features (1024 x 13 x 13), B=64.

A greedy row argmaxes the logits of ``apply(train=False)``. A pool row
calls the pool's own tick (``ContinuousCaptioner.step``: ``step_chunk`` of
``_step_once`` or ``_step_once_beam``) back to back and holds every slot
live between ticks, as the JAX rows do; host admission is not timed. On
the card S2VT, its artifact, S2VT-att, SpatialNet and the S2VT pool's
admissions launch B1, RationaleNet B2 and B1, through their
``torch.library`` ops; no switch turns a kernel off, and each row prints
the launches of its best timed call, read around it.

The quantized rows: the JAX file passes int8 state between programs, but
keeps int4 state inside one program, because its backend cannot pass int4
arrays across a program boundary, and times those two rows by the
difference of a short and a five times longer run, which cancels making
the state. Here int4 codes are packed two to a ``uint8``
(``ops/kvquant.pack_int4``), plain tensors that cross calls as the int8
ones do (the pool passes them from tick to tick), so the int4 rows are
timed as the int8 rows are: the state made once before the timed calls and
passed in, one timing, no difference. They keep JAX's names, ", in-program
state" included, so that a reader finds the JAX row they stand beside.

Timing: each row's ``iters`` calls (or ticks) issued back to back from
Python between two CUDA events, best of 3 after a warm-up call
(``benchutil.time_chained``). The JAX file chains them inside one jit and
perturbs the input per call so that XLA cannot fold them into one; eager
PyTorch recomputes every call, so the input is not perturbed. A row
includes the host's launch time wherever the host cannot stay ahead of the
card (981 launches per flagship call, 12,145 per KV-cached Transformer
greedy call: ``PERF.md`` §5); capturing the calls in CUDA graphs (ROADMAP
A19) is what would remove it.

Every row prints ``metric``, ``value``, ``unit`` (and ``captions_equiv_per_s``
where JAX does), ``mfu``, then ``median``, ``loadavg``, ``iters``, ``flops``
and ``launches`` as ``bench`` prints them. The flags are the JAX file's
environment knobs: ``VCR_BENCH_ITERS``, ``VCR_BENCH_SCALE`` (every batch
divided by it, at least 4), ``VCR_BENCH_TR_BATCH``, ``VCR_BENCH_SP_BATCH``,
``VCR_BENCH_TAG`` and ``VCR_UPLOAD_CHUNK_MB``; nothing here reads the
environment. A failed probe prints one JSON failure line and exits 1;
``--device cpu``, or no card at all, raises before anything is built.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vcr_tpu_torch import entry
from vcr_tpu_torch.bench import Row, measure, normal_feats, probe_or_exit, row_fields
from vcr_tpu_torch.utils import benchutil


STEP_CHUNK = 4     # the pools' tokens per tick


@dataclasses.dataclass(frozen=True)
class Widths:
    """The widths of the JAX benches' specs (``bench_all.py``'s ``spec_for``,
    ``bench_train.py``'s spec) and feature shapes."""

    vocab_size: int
    embed_size: int
    hidden_size: int
    max_len: int
    num_frames: int
    vgg_feat: int      # S2VT, RationaleNet, the Transformer
    resnet_feat: int   # S2VT-att and the S2VT pool
    yolo_feat: int     # SpatialNet's grid features (F, K, K)
    grid: int
    tf_layers: int
    tf_heads: int
    compute_dtype: str
    vocab_pad_to: int

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 3


# the full widths: ``entry``'s configurations, bf16 products, vocab padded to 128
FULL = Widths(
    vocab_size=entry.FLAGSHIP["vocab_size"], embed_size=entry.FLAGSHIP["embed_size"],
    hidden_size=entry.FLAGSHIP["hidden"], max_len=entry.FLAGSHIP["max_len"],
    num_frames=entry.FLAGSHIP["num_frames"], vgg_feat=entry.FLAGSHIP["vid_feat"],
    resnet_feat=entry.S2VT_ATT["vid_feat"], yolo_feat=entry.SPATIAL["vid_feat"],
    grid=entry.SPATIAL["grid_size"], tf_layers=entry.TRANSFORMER["tf_layers"],
    tf_heads=entry.TRANSFORMER["tf_heads"], compute_dtype="bfloat16", vocab_pad_to=128)


def spec_for(w: Widths, arch: str, vid_feat: int, **kw):
    """The JAX benches' spec of ``arch`` at widths ``w`` and feature width
    ``vid_feat``."""
    from vcr_tpu_torch.models import base

    return base.ModelSpec(
        arch=arch, vocab_size=w.vocab_size, embed_size=w.embed_size,
        hidden_size=w.hidden_size, vid_feat_size=vid_feat, max_len=w.max_len,
        num_frames=w.num_frames, dropout_p=0.2, sos_id=w.vocab_size - 4,
        compute_dtype=w.compute_dtype, vocab_pad_to=w.vocab_pad_to,
        tf_layers=w.tf_layers, tf_heads=w.tf_heads, **kw)


def caption_metric(name: str, batch: int) -> str:
    return f"{name} captions/sec/chip (B={batch}, bf16)"


def slot_metric(rows: int, label: str) -> str:
    return f"Transformer continuous slot decode tokens/sec/chip (R={rows}, {label})"


def slot_label(kv: str, weights: str) -> str:
    """The slot-decode row's mode in its name; JAX's int4 rows, timed there
    with their state inside the program, say so."""
    if (kv, weights) == ("bf16", "bf16"):
        return "bf16"
    label = f"{kv} KV cache" + (f", {weights} weights" if weights != "bf16" else "")
    return label + (", in-program state" if kv == "int4" else "")


# ------------------------------------------------------------------ the rows

def calls_row(name: str, fn: Callable, args: tuple, batch: int, iters: int,
              counted: Optional[tuple] = None) -> Row:
    """``iters`` calls of ``fn(*args)`` -> the last call's tokens: the JAX
    file's ``time_fn``. ``counted`` (fn, args): the call whose products
    stand for one of these (default: one of these)."""

    def one(*a):
        with torch.inference_mode():
            return fn(*a)

    def run_n(*a):
        for _ in range(iters):
            out = one(*a)
        return out

    unit_fn, unit_args = counted or (one, args)
    return Row(run_n, args, batch * iters, caption_metric(name, batch),
               (unit_fn, unit_args, iters))


def greedy_row(name: str, spec, params, x: torch.Tensor, iters: int) -> Row:
    """The JAX file's ``run_config`` row: the argmax of the logits of
    ``apply(train=False)``."""
    from vcr_tpu_torch.models import base

    _, apply = base.build_model(spec.arch)

    def fwd(p, xi):
        out = apply(p, spec, xi, train=False)
        return (out[0] if isinstance(out, tuple) else out).argmax(dim=-1).to(torch.int32)

    return calls_row(f"{name} greedy", fwd, (params, x), x.shape[0], iters)


def artifact_row(spec, params, x: torch.Tensor, iters: int, eos_id: int, device) -> Row:
    """S2VT's serving artifact, exported on the CPU (as a serving host gets
    it) and loaded on ``device``, replayed on float32 features; its FLOPs
    stand for those of the live tokens call on the same features."""
    from vcr_tpu_torch import export_serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import s2vt

    with tempfile.TemporaryDirectory() as td:
        export_serving.export_captioner(params_to(params, "cpu"), spec, td, eos_id=eos_id,
                                        device="cpu")
        art = export_serving.load_artifact(td, device=device)
    x32 = x.float()

    def live(p, xi):
        with torch.inference_mode():
            return s2vt.apply(p, spec, xi, emit="tokens")

    return calls_row("S2VT serving-artifact replay (exported StableHLO)",
                     art, (x32,), x.shape[0], iters, counted=(live, (params, x32)))


def tr_fast_greedy_row(spec, params, x: torch.Tensor, iters: int) -> Row:
    from vcr_tpu_torch.models import transformer as tr

    def fwd(p, xi):
        eo = tr.encode(p, spec, xi, tr.create_masks_inp(xi))
        return tr.decode_greedy_fast(p, spec, eo)

    return calls_row("Transformer fast greedy (KV-cache)", fwd, (params, x), x.shape[0],
                     iters)


def tr_beam_row(spec, params, x: torch.Tensor, iters: int, eos_id: int,
                form: str) -> Row:
    """Beam 5: ``form`` "lineage" or "gather" (the KV-cached beam, its caches
    in place or gathered each step) or "parity" (the parity beam)."""
    from vcr_tpu_torch import decode

    if form == "parity":
        def fwd(p, xi):
            return decode.transformer_beam_decode(p, spec, xi, 5, eos_id)[0]
        name = "Transformer parity beam-5"
    else:
        def fwd(p, xi):
            return decode.transformer_beam_decode_fast(p, spec, xi, 5, eos_id,
                                                       lineage=form == "lineage")[0]
        name = ("Transformer fast beam-5 (KV-cache, lineage)" if form == "lineage"
                else "Transformer fast beam-5 (KV-cache, gather reorder)")
    return calls_row(name, fwd, (params, x), x.shape[0], iters)


def slot_state0(spec, params, x: torch.Tensor, kv: str, weights: str) -> dict:
    """The slot stepper's state with every row admitted at once: the
    encoder's cross K/V, empty self caches, <sos>, position 0."""
    from vcr_tpu_torch.models import transformer as tr

    with torch.inference_mode():
        eo = tr.encode(params, spec, x, tr.create_masks_inp(x))
        _, init_self, cross_state = tr.make_slot_stepper(params, spec, kv_cache=kv,
                                                         decode_weights=weights)
        b = x.shape[0]
        return {"dec": {**init_self(b), **cross_state(eo)},
                "last": torch.full((b,), spec.sos_id, dtype=torch.int32, device=x.device),
                "i": torch.zeros((b,), dtype=torch.int32, device=x.device)}


def slot_ticks(spec, params, kv: str, weights: str) -> Callable:
    """-> run(st, n): n ticks of the slot stepper from ``st``, each row's
    argmax fed back -> the last tokens (rows,) int32."""
    from vcr_tpu_torch.models import transformer as tr

    step_fn, _, _ = tr.make_slot_stepper(params, spec, kv_cache=kv, decode_weights=weights)

    def run(st, n: int):
        with torch.inference_mode():
            for _ in range(n):
                dec, logits = step_fn(st["dec"], st["last"], st["i"])
                st = {"dec": dec, "last": logits.argmax(dim=-1).to(torch.int32),
                      "i": (st["i"] + 1).clamp(max=spec.max_len - 1)}
        return st["last"]

    return run


def slot_decode_row(spec, params, x: torch.Tensor, iters: int, kv: str = "bf16",
                    weights: str = "bf16") -> Row:
    """The continuous slot decode with its state made before the timed
    calls and passed in: ``iters`` x L ticks of every row. ``params`` are
    the decoder's quantized weights already under ``weights="int8"``
    (``models.transformer.quantize_decoder_params``), as the pool holds
    them. An int4 row keeps the JAX row's name (``slot_label``)."""
    run = slot_ticks(spec, params, kv, weights)
    n = iters * spec.max_len
    st0 = slot_state0(spec, params, x, kv, weights)
    return Row(lambda st: run(st, n), (st0,), x.shape[0] * n,
               slot_metric(x.shape[0], slot_label(kv, weights)),
               (lambda st: run(st, 1), (st0,), n), unit="tokens/s",
               per_caption=spec.max_len)


def pool_row(pool, ticks: int, metric: str) -> Row:
    """``ticks`` of the pool's own tick on its current state, every slot
    held live between ticks -> the last tokens."""
    def tick(st):
        with torch.inference_mode():
            st = pool.step(pool._step_params, st)
            return dict(st, active=torch.ones_like(st["active"]))

    def run_n(st):
        for _ in range(ticks):
            st = tick(st)
        return st["last"]

    return Row(run_n, (pool.state,), pool.slots * pool.step_chunk * ticks, metric,
               (tick, (pool.state,), ticks), unit="tokens/s")


def admitted_pool(params, spec, slots: int, admit: int, feats: np.ndarray, device,
                  **kw):
    """A pool of ``slots`` with ``feats`` admitted ``admit`` at a time."""
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    pool = ContinuousCaptioner(params, spec, slots=slots, admit_chunk=admit,
                               step_chunk=STEP_CHUNK, device=device, **kw)
    for lo in range(0, slots, admit):
        hi = min(lo + admit, slots)
        pool.encode_admit(feats[lo:hi], np.arange(lo, hi, dtype=np.int32),
                          np.ones((hi - lo,), bool))
    return pool


# ----------------------------------------------------------------- the plan

def plan(w: Widths = FULL, iters: int = 10, scale: int = 1, tr_batch: int = 512,
         sp_batch: int = 64, device="cuda", limit_mb: Optional[float] = None
         ) -> List[Tuple[str, Callable]]:
    """-> [(metric, build)], one per row of the JAX file, in its order.
    ``build()`` makes the row's model and inputs and returns its ``Row``.
    The builds share models and
    draw features from one generator, so they run in this order; the
    metrics need no build."""
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import base
    from vcr_tpu_torch.models import transformer as tr

    rng = np.random.default_rng(0)
    glove = rng.standard_normal((w.vocab_size, w.embed_size)).astype(np.float32)
    frames = w.num_frames
    ctx = {}

    def scaled(b):
        return max(4, b // scale)

    def init(spec, seed):
        init_fn, _ = base.build_model(spec.arch)
        return params_to(init_fn(torch.Generator().manual_seed(seed), spec, glove), device)

    def feats(*shape):
        return normal_feats(rng, shape, device, limit_mb)

    def host_feats(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    specs = {"s2vt": spec_for(w, "s2vt", w.vgg_feat),
             "s2vt-att": spec_for(w, "s2vt-att", w.resnet_feat),
             "transformer": spec_for(w, "transformer", w.vgg_feat),
             "rationale": spec_for(w, "rationale", w.vgg_feat, base_arch="s2vt"),
             "spatial": spec_for(w, "spatial", w.yolo_feat, base_arch="s2vt",
                                 grid_size=w.grid),
             "pool_s2vt": spec_for(w, "s2vt", w.resnet_feat)}
    s2vt_b, tr_b = scaled(2048), scaled(tr_batch)
    beam_b = tr_b // 4
    parity_beam_b = min(scaled(32), beam_b)
    att_r, s2_r, tb_r = scaled(64), scaled(512), scaled(64)
    tf = specs["transformer"]
    rows: List[Tuple[str, Callable]] = []

    def run_config(name, arch, batch, shape, seed=0, keep=None):
        def build():
            spec = specs[arch]
            params = init(spec, seed)
            x = feats(batch, frames, *shape)
            if keep:
                ctx[keep] = (params, x)
            return greedy_row(name, spec, params, x, iters)
        rows.append((caption_metric(f"{name} greedy", batch), build))

    run_config("S2VT (MSVD-VGG 4096-d)", "s2vt", s2vt_b, (w.vgg_feat,), keep="s2vt")
    rows.append((caption_metric("S2VT serving-artifact replay (exported StableHLO)",
                                s2vt_b),
                 lambda: artifact_row(specs["s2vt"], *ctx["s2vt"], iters, w.eos_id,
                                      device)))
    run_config("S2VT-att (MSVD resnet 512-d)", "s2vt-att", scaled(1024), (w.resnet_feat,))
    run_config("Transformer (MSR-VTT 4096-d) parity", "transformer", scaled(128),
               (w.vgg_feat,), keep="tr")

    def tr_x():
        if "tr_x" not in ctx:
            ctx["tr_x"] = feats(tr_b, frames, w.vgg_feat)
        return ctx["tr_x"]

    rows.append((caption_metric("Transformer fast greedy (KV-cache)", tr_b),
                 lambda: tr_fast_greedy_row(tf, ctx["tr"][0], tr_x(), iters)))
    for form, name in (("lineage", "Transformer fast beam-5 (KV-cache, lineage)"),
                       ("gather", "Transformer fast beam-5 (KV-cache, gather reorder)")):
        rows.append((caption_metric(name, beam_b),
                     lambda form=form: tr_beam_row(tf, ctx["tr"][0], tr_x()[:beam_b], iters,
                                                   w.eos_id, form)))
    for kv, wt in (("bf16", "bf16"), ("int8", "bf16"), ("int4", "bf16"), ("bf16", "int8"),
                   ("int8", "int8"), ("int4", "int8")):
        def slot(kv=kv, wt=wt):
            params = ctx["tr"][0]
            if wt == "int8":
                params = tr.quantize_decoder_params(params)
            return slot_decode_row(tf, params, tr_x(), iters, kv, wt)
        rows.append((slot_metric(tr_b, slot_label(kv, wt)), slot))

    att_metric = (f"S2VT-att continuous BEAM-5 slot decode tokens/sec/chip "
                  f"(R={att_r}, h-only reorder, bf16)")

    def att_beam():
        spec = specs["s2vt-att"]
        pool = admitted_pool(init(spec, 1), spec, att_r, att_r,
                             host_feats(att_r, frames, w.resnet_feat), device,
                             eos_id=w.eos_id, beam_size=5)
        return pool_row(pool, iters * 10, att_metric)
    rows.append((att_metric, att_beam))
    for wt in ("bf16", "int8"):
        metric = f"S2VT continuous slot decode tokens/sec/chip (R={s2_r}, {wt} weights)"

        def s2_pool(wt=wt, metric=metric):
            spec = specs["pool_s2vt"]
            if "pool_s2vt" not in ctx:
                ctx["pool_s2vt"] = init(spec, 3)
            pool = admitted_pool(ctx["pool_s2vt"], spec, s2_r, min(s2_r, 64),
                                 host_feats(s2_r, frames, w.resnet_feat), device,
                                 eos_id=w.eos_id,
                                 decode_weights=None if wt == "bf16" else wt)
            return pool_row(pool, iters * 10, metric)
        rows.append((metric, s2_pool))
    for kv, kv_label in ((None, "bf16"), ("int8", "int8 KV cache")):
        metric = (f"Transformer continuous BEAM-5 slot decode tokens/sec/chip "
                  f"(R={tb_r}, lineage, {kv_label})")

        def tr_beam_pool(kv=kv, metric=metric):
            pool = admitted_pool(ctx["tr"][0], tf, tb_r, tb_r,
                                 host_feats(tb_r, frames, w.vgg_feat), device,
                                 eos_id=w.eos_id, beam_size=5, kv_cache=kv)
            return pool_row(pool, iters, metric)
        rows.append((metric, tr_beam_pool))
    rows.append((caption_metric("Transformer parity beam-5", parity_beam_b),
                 lambda: tr_beam_row(tf, ctx["tr"][0], tr_x()[:parity_beam_b], iters,
                                     w.eos_id, "parity")))
    run_config("RationaleNet (S2VT base)", "rationale", scaled(1024), (w.vgg_feat,))
    run_config("SpatialNet (YOLO 1024x13x13)", "spatial", scaled(sp_batch),
               (w.yolo_feat, w.grid, w.grid))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--scale", type=int, default=1,
                   help="divide every batch by this (at least 4)")
    p.add_argument("--tr_batch", type=int, default=512,
                   help="the Transformer's fast greedy and slot decode rows")
    p.add_argument("--sp_batch", type=int, default=64, help="SpatialNet's batch")
    p.add_argument("--tag", default=None,
                   help="marks a variant's rows: each metric becomes '<metric> [<tag>]'")
    p.add_argument("--upload_chunk_mb", type=float, default=None,
                   help="copy the features to the card in slices of at most this many MB")
    p.add_argument("--device", default="cuda",
                   help="the card (a CPU time is not a device measurement: cpu raises)")
    args = p.parse_args(argv)
    device = benchutil.require_card(args.device)
    rc = probe_or_exit("per-family greedy captions/sec/chip", "captions/s")
    if rc is not None:
        return rc
    for metric, build in plan(FULL, args.iters, args.scale, args.tr_batch, args.sp_batch,
                              device, args.upload_chunk_mb):
        t0 = time.perf_counter()
        row = build()
        t1 = time.perf_counter()
        out = row_fields(row, measure(row, device), args.iters)
        print(f"[bench_all] {metric}: built in {t1 - t0:.1f} s, measured in "
              f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
        benchutil.emit_row(out, tag=args.tag)
        del row
    return 0


if __name__ == "__main__":
    sys.exit(main())
