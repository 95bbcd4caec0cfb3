"""The port's bench harness (``vcr_tpu_torch.bench``, ``bench_all``,
``bench_train``) against the JAX package's on the CPU, at small widths (H=32,
vocab 64, N=4, L=5, B=4, 2 Transformer layers), from one JAX parameter tree
per family: the program each JAX bench row builds and the port's function for
that row take the same seeded numpy inputs. Tokens are equal in float32 (the
flagship row and a slot-decode row); the products' FLOPs of a timed call
(``benchutil.flops``) equal ``vcr_tpu.utils.benchutil.jaxpr_flops`` of the
JAX row's program, the train steps up to a difference that is stated; the
port's metric names are the JAX files' format strings filled in. The timing
itself needs the card: on the CPU it raises."""

import ast
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.models import base as jbase
from vcr_tpu.models import transformer as jtr
from vcr_tpu.train import optim as joptim
from vcr_tpu.train import step as jstep
from vcr_tpu.utils import benchutil as jbench
from vcr_tpu_torch import bench, bench_all, bench_train, bridge, serving
from vcr_tpu_torch.utils import benchutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = bench_all.Widths(vocab_size=64, embed_size=16, hidden_size=32, max_len=5,
                     num_frames=4, vgg_feat=16, resnet_feat=8, yolo_feat=6, grid=3,
                     tf_layers=2, tf_heads=2, compute_dtype="float32", vocab_pad_to=8)
B, ITERS = 4, 2
# family -> (arch, feature width, spec kwargs, per-frame feature shape)
FAMILIES = {
    "s2vt": ("s2vt", W.vgg_feat, {}, (W.vgg_feat,)),
    "s2vt-att": ("s2vt-att", W.resnet_feat, {}, (W.resnet_feat,)),
    "transformer": ("transformer", W.vgg_feat, {}, (W.vgg_feat,)),
    "rationale": ("rationale", W.vgg_feat, {"base_arch": "s2vt"}, (W.vgg_feat,)),
    "spatial": ("spatial", W.yolo_feat, {"base_arch": "s2vt", "grid_size": W.grid},
                (W.yolo_feat, W.grid, W.grid)),
}


def _jspec(arch, feat, **kw):
    """The JAX files' ``spec_for`` at the test widths (plain recurrences:
    the arithmetic of the Pallas kernels, which the walker cannot see)."""
    return jbase.ModelSpec(
        arch=arch, vocab_size=W.vocab_size, embed_size=W.embed_size,
        hidden_size=W.hidden_size, vid_feat_size=feat, max_len=W.max_len,
        num_frames=W.num_frames, dropout_p=0.2, sos_id=W.vocab_size - 4,
        compute_dtype=W.compute_dtype, vocab_pad_to=W.vocab_pad_to,
        tf_layers=W.tf_layers, tf_heads=W.tf_heads, **kw)


def _models(family):
    """(JAX spec, JAX params, port spec, port params, features (B, N, ...)):
    one parameter tree, initialised as the JAX bench does, and features
    drawn after its GloVe stand-in from one seeded generator."""
    arch, feat, kw, shape = FAMILIES[family]
    rng = np.random.default_rng(0)
    glove = rng.standard_normal((W.vocab_size, W.embed_size)).astype(np.float32)
    jspec = _jspec(arch, feat, **kw)
    init, _ = jbase.build_model(arch)
    jparams = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jspec, glove))
    x = rng.standard_normal((B, W.num_frames, *shape)).astype(np.float32)
    return (jspec, jparams, bench_all.spec_for(W, arch, feat, **kw),
            bridge.from_jax_params(jparams, "cpu"), x)


def _jax_chained(fn, iters=ITERS):
    """The JAX benches' timed program: ``iters`` calls chained in one scan,
    the input perturbed per call (bench.py:68-76, bench_all.py:67-75)."""
    def run_n(params, x):
        def body(c, _):
            xi = (x * (1.0 + c * 1e-9)).astype(x.dtype)
            out = fn(params, xi)
            return out.astype(jnp.float32).ravel()[0] * 1e-12, None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=iters)
        return c
    return run_n


def _jax_greedy(jspec):
    """bench_all.py's ``run_config`` forward: the argmax of eval logits."""
    _, apply = jbase.build_model(jspec.arch)

    def fwd(params, xi):
        out = apply(params, jspec, xi, train=False)
        logits = out[0] if isinstance(out, tuple) else out
        return jnp.argmax(logits, axis=-1).astype(jnp.float32)
    return fwd


def _jax_tokens(jspec):
    """bench.py's forward: the flagship's greedy tokens."""
    from vcr_tpu.models import s2vt

    return lambda params, xi: s2vt.apply(params, jspec, xi, train=False, emit="tokens")


def _jax_slot(jspec, jparams, x, n, kv="bf16", weights="bf16"):
    """bench_all.py's continuous slot decode (``cc_state0``, ``cc_run_n``
    and their quantized forms): (the program, its arguments), the program
    running n ticks and returning the last tokens. The int4 rows make their
    state inside the program (``make_run``), the others take it made by
    its own program."""
    if weights == "int8":
        jparams = jtr.quantize_decoder_params(jparams)

    def state0(params, xi):
        eo = jtr.encode(params, jspec, xi, jtr.create_masks_inp(xi), jax.random.PRNGKey(0),
                        train=False)
        _, init_self, cross_state = jtr.make_slot_stepper(params, jspec, kv_cache=kv,
                                                          decode_weights=weights)
        return {"dec": {**init_self(xi.shape[0]), **cross_state(eo)},
                "last": jnp.full((xi.shape[0],), jspec.sos_id, jnp.int32),
                "i": jnp.zeros((xi.shape[0],), jnp.int32)}

    def run_n(params, st0):
        step_fn, _, _ = jtr.make_slot_stepper(params, jspec, kv_cache=kv,
                                              decode_weights=weights)

        def body(st, _):
            dec, logits = step_fn(st["dec"], st["last"], st["i"])
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return {"dec": dec, "last": nxt,
                    "i": jnp.minimum(st["i"] + 1, jspec.max_len - 1)}, None
        st, _ = jax.lax.scan(body, st0, None, length=n)
        return st["last"]
    if kv == "int4":
        return (lambda params, xi: run_n(params, state0(params, xi))), (jparams, x)
    return run_n, (jparams, jax.jit(state0)(jparams, x))


def test_flagship_tokens_equal_jax_and_build_captioner():
    jspec, jparams, tspec, tparams, x = _models("s2vt")
    row = bench.flagship_row(tspec, tparams, torch.from_numpy(x), ITERS, device="cpu")
    assert row.metric == bench.METRIC % B and row.rows_per_call == B * ITERS
    got = row.run_n(*row.args)
    want = np.asarray(jax.jit(_jax_tokens(jspec))(jparams, x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, serving.build_captioner(tparams, tspec, device="cpu")(x))


@pytest.mark.parametrize("kv,weights", [("bf16", "bf16"), ("int8", "bf16"), ("int4", "bf16"),
                                        ("bf16", "int8"), ("int8", "int8"), ("int4", "int8")])
def test_slot_decode_tokens_equal_jax(kv, weights):
    """Every slot-decode row, its state made once and passed in (the int4
    rows too, which JAX makes inside its program), against the JAX row's
    program: the same tokens in float32, and the JAX row's name."""
    from vcr_tpu_torch.models import transformer as ttr

    jspec, jparams, tspec, tparams, x = _models("transformer")
    if weights == "int8":
        tparams = ttr.quantize_decoder_params(tparams)
    row = bench_all.slot_decode_row(tspec, tparams, torch.from_numpy(x), ITERS, kv, weights)
    n = ITERS * W.max_len
    assert row.rows_per_call == B * n and row.unit == "tokens/s"
    assert row.metric.endswith(", in-program state)") == (kv == "int4")
    run_n, jargs = _jax_slot(jspec, jparams, x, n, kv, weights)
    want = np.asarray(jax.jit(run_n)(*jargs))
    np.testing.assert_array_equal(row.run_n(*row.args).numpy(), want)
    # the state is made before the timed calls: each call starts from it
    np.testing.assert_array_equal(row.run_n(*row.args).numpy(), want)


def _row_and_jax(case):
    """(the port's Row, the JAX row's program, its arguments) of ``case``."""
    if case == "flagship":
        jspec, jparams, tspec, tparams, x = _models("s2vt")
        return (bench.flagship_row(tspec, tparams, torch.from_numpy(x), ITERS, "cpu"),
                _jax_chained(_jax_tokens(jspec)), (jparams, x))
    if case == "tr_fast_greedy":
        jspec, jparams, tspec, tparams, x = _models("transformer")

        def fast(params, xi):
            eo = jtr.encode(params, jspec, xi, jtr.create_masks_inp(xi),
                            jax.random.PRNGKey(0), train=False)
            return jtr.decode_greedy_fast(params, jspec, eo).astype(jnp.float32)
        return (bench_all.tr_fast_greedy_row(tspec, tparams, torch.from_numpy(x), ITERS),
                _jax_chained(fast), (jparams, x))
    if case == "slot_decode":
        jspec, jparams, tspec, tparams, x = _models("transformer")
        run_n, jargs = _jax_slot(jspec, jparams, x, ITERS * W.max_len)
        return (bench_all.slot_decode_row(tspec, tparams, torch.from_numpy(x), ITERS),
                run_n, jargs)
    jspec, jparams, tspec, tparams, x = _models(case)
    return (bench_all.greedy_row("n", tspec, tparams, torch.from_numpy(x), ITERS),
            _jax_chained(_jax_greedy(jspec)), (jparams, x))


@pytest.mark.parametrize("case", ["flagship", "s2vt", "s2vt-att", "transformer",
                                  "rationale", "spatial", "tr_fast_greedy",
                                  "slot_decode"])
def test_row_flops_equal_the_jax_walker(case):
    """One timed call's products: FlopCounterMode with B1's and B2's formulas
    against the JAX walker on the row's program (plain recurrences,
    ``use_pallas=False``, the arithmetic of the Pallas kernels)."""
    row, jax_run_n, jax_args = _row_and_jax(case)
    want = jbench.jaxpr_flops(jax_run_n, *jax_args)
    assert want and benchutil.flops(row.run_n, *row.args) == want


def _recompute_extra(family):
    """FLOPs that one port train step does beyond the JAX bench's step, from
    the shapes. The JAX bench trains its plain scans (VCR_BENCH_PALLAS=0);
    the port launches B1 and B2, whose gradients rerun the whole sequence
    under autograd, as the JAX package's Pallas backward does
    (vcr_tpu/ops/pallas_gru.py:132-167, 414-423): per sequence, the input
    projection and the T recurrent products once more. Torch's autograd
    leaves out the recurrence's first dh product (its h0 is a constant
    zero), which JAX's scan transpose forms. S2VT's step remats the GRU
    gates in both packages (its T recurrent products again in JAX's plain
    scans), which the port's sequence recompute stands in for."""
    t, b, h, v = W.num_frames, B, W.hidden_size, W.vgg_feat

    def seq(i, gates):
        step = 2 * b * h * gates * h
        return t * step + 2 * t * b * i * gates * h - step

    gru = seq(v, 3) + seq(h, 3)      # the encoder and the prime pass (W_ih[:H])
    if family == "s2vt":
        return gru - 2 * t * 2 * b * h * 3 * h
    return gru + 2 * seq(v, 4)       # RationaleNet: the BiLSTM, one B2 a direction


@pytest.mark.parametrize("family", ["s2vt", "rationale"])
def test_train_step_flops_against_the_jax_walker(family):
    """bench_train.py's program (build_step_fns, Adam with the clip, static
    teacher forcing, ``iters`` steps in one scan) against the port's row:
    equal up to B1's and B2's sequence recompute (``_recompute_extra``)."""
    jspec, jparams, tspec, tparams, _ = _models(family)
    r = np.random.default_rng(1)
    feats = r.standard_normal((B, W.num_frames, W.vgg_feat)).astype(np.float32)
    batch = {"vid_feats": feats,
             "sent": r.integers(0, W.vocab_size, (B, W.max_len)).astype(np.int32),
             "sent_len": np.full((B,), 3, np.int32), "valid": np.ones((B,), np.float32)}
    jopt = joptim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    jtrain, _ = jstep.build_step_fns(family, jspec, jopt, static_tf=1.0)

    def run_n(params, opt_state, bdata, key):
        def body(carry, i):
            p, o = carry
            p, o, _m, _pred = jtrain(p, o, bdata, jax.random.fold_in(key, i), 1.0)
            return (p, o), None
        (p, _), _ = jax.lax.scan(body, (params, opt_state), jnp.arange(ITERS))
        return jax.tree_util.tree_leaves(p)[0].astype(jnp.float32).ravel()[0]

    want = jbench.jaxpr_flops(run_n, jparams, jopt.init(jparams),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(1, impl="rbg"))
    row = bench_train.train_row(family, tspec, tparams,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                ITERS, device="cpu")
    (template,) = _templates(os.path.join(REPO, "bench_train.py"))
    assert row.metric == template.format(name=family, batch=B)
    got = benchutil.flops(row.run_n, *row.args)
    assert want and got == want + ITERS * _recompute_extra(family)
    assert 1.0 < got / want < 1.2


def _templates(path):
    """The format strings of a JAX bench file's metrics, in source order:
    f-strings with their fields as ``{name}``, and %-format literals."""
    with open(path) as f:
        tree = ast.parse(f.read())
    parts = {id(v) for node in ast.walk(tree) if isinstance(node, ast.JoinedStr)
             for v in node.values}
    out = []
    for node in ast.walk(tree):
        if id(node) in parts:
            continue
        if isinstance(node, ast.JoinedStr):
            text = "".join(v.value if isinstance(v, ast.Constant)
                           else "{" + ast.unparse(v.value) + "}" for v in node.values)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        else:
            continue
        if "/sec/chip (" in text:
            out.append((node.lineno, node.col_offset, text))
    return [text for _, _, text in sorted(out)]


def test_metric_names_are_the_jax_format_strings():
    (flagship,) = _templates(os.path.join(REPO, "bench.py"))
    assert bench.METRIC == flagship
    # bench_train.py's, filled in by test_train_step_flops_against_the_jax_walker
    assert _templates(os.path.join(REPO, "bench_train.py")) == [
        "{name} train step videos/sec/chip (B={batch}, bf16)"]
    time_fn, cc, ccq, in_prog, att, s2, tcb = _templates(os.path.join(REPO, "bench_all.py"))

    def label(kv, w):
        return f"{kv} KV cache" + (f", {w} weights" if w != "bf16" else "")
    quant = [(ccq if kv != "int4" else in_prog).format(slot_rows=512, label=label(kv, w))
             for kv, w in (("int8", "bf16"), ("int4", "bf16"), ("bf16", "int8"),
                           ("int8", "int8"), ("int4", "int8"))]
    want = [time_fn.format(name="S2VT (MSVD-VGG 4096-d) greedy", batch=2048),
            time_fn.format(name="S2VT serving-artifact replay (exported StableHLO)",
                           batch=2048),
            time_fn.format(name="S2VT-att (MSVD resnet 512-d) greedy", batch=1024),
            time_fn.format(name="Transformer (MSR-VTT 4096-d) parity greedy", batch=128),
            time_fn.format(name="Transformer fast greedy (KV-cache)", batch=512),
            time_fn.format(name="Transformer fast beam-5 (KV-cache, lineage)", batch=128),
            time_fn.format(name="Transformer fast beam-5 (KV-cache, gather reorder)",
                           batch=128),
            cc.format(slot_rows=512), *quant, att.format(att_r=64),
            s2.format(s2_r=512, wmode="bf16"), s2.format(s2_r=512, wmode="int8"),
            tcb.format(tb_r=64, kv_label="bf16"),
            tcb.format(tb_r=64, kv_label="int8 KV cache"),
            time_fn.format(name="Transformer parity beam-5", batch=32),
            time_fn.format(name="RationaleNet (S2VT base) greedy", batch=1024),
            time_fn.format(name="SpatialNet (YOLO 1024x13x13) greedy", batch=64)]
    with open(os.path.join(REPO, "bench_all.py")) as f:
        src = f.read()
    for name in ("S2VT (MSVD-VGG 4096-d)", "S2VT-att (MSVD resnet 512-d)",
                 "Transformer (MSR-VTT 4096-d) parity", "Transformer parity beam-5",
                 "RationaleNet (S2VT base)", "SpatialNet (YOLO 1024x13x13)"):
        assert f'"{name}"' in src
    assert [m for m, _ in bench_all.plan(device="cpu")] == want
    # --scale divides every batch, at least 4, as VCR_BENCH_SCALE does; the beams
    # take a quarter of the Transformer's batch after that
    scaled = [m for m, _ in bench_all.plan(scale=64, tr_batch=512, device="cpu")]
    assert re.search(r"\(B=32, bf16\)$", scaled[0]) and "(R=8, bf16)" in scaled[7]
    assert scaled[5].endswith("(B=2, bf16)") and "(R=4, h-only" in scaled[13]


def test_every_row_runs_on_the_cpu_at_small_widths():
    """The whole plan at the test widths: every row builds and its timed
    call runs; its products (the JAX walker's, above) are ``times`` times
    those of its one counted call, the artifact's those of the live tokens
    call, whose tokens it replays. The timing raises on the CPU."""
    rows = bench_all.plan(W, iters=1, scale=512, device="cpu")
    assert len(rows) == 21
    for metric, build in rows:
        row = build()
        assert isinstance(row, bench.Row) and row.metric == metric
        out = row.run_n(*row.args)
        assert out.dtype == torch.int32 and out.numel() > 0
        count = bench.unit_flops(row)
        assert count == benchutil.flops(row.run_n, *row.args) > 0
        if "artifact" in metric:
            live, args = row.call[:2]
            assert torch.equal(out, live(*args))
    with pytest.raises(RuntimeError, match="a CPU time is not a device measurement"):
        bench.measure(row, "cpu")
