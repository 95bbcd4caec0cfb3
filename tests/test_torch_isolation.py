"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points never fall back to the CPU unasked, and on a card its kernels
agree with their plain versions.

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest --noconftest tests/test_torch_isolation.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcr_tpu_torch import cli, entry, serving, serving_continuous
from vcr_tpu_torch.device import params_to
from vcr_tpu_torch import decode
from vcr_tpu_torch.models import s2vt_att, spatial, transformer
from vcr_tpu_torch.nn import attention, layers, rnn
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm, kvquant
from vcr_tpu_torch.train import optim, step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from util_corpus import build_corpus  # noqa: E402

_IMPORT_ALL = """
import json, pkgutil, sys
import chip_smoke
import vcr_tpu_torch
for m in pkgutil.walk_packages(vcr_tpu_torch.__path__, "vcr_tpu_torch."):
    __import__(m.name)
print(json.dumps(sorted(sys.modules)))
"""


def test_port_imports_no_jax_and_nothing_of_vcr_tpu():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter: neither JAX nor the JAX package comes with them."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])
    for name in ("serving", "ops.cuda_gru", "ops.cuda_lstm", "models.rationale",
                 "train", "train.losses", "train.optim", "train.schedule", "train.step",
                 "cli", "config", "decode", "tools", "vocab", "train.loop",
                 "train.checkpoint", "evals.metrics", "evals.porter", "data.captions",
                 "data.pipeline", "utils.logging", "utils.profiling", "utils.sampler",
                 "nn.attention", "models.s2vt_att", "convert", "models.spatial",
                 "models.transformer", "serving_continuous", "server", "multiserver",
                 "client", "ops.kvquant", "ops.wquant", "data.native", "ops.library",
                 "export_serving", "export_continuous", "scheduler", "models.vgg",
                 "models.resnet", "models.darknet", "data.prep.frames",
                 "data.prep.captions", "data.prep.glove", "data.prep.video_feats",
                 "data.prep.bbox_feats", "evals.attention_export", "utils.benchutil",
                 "utils.backend_probe", "sweep", "tune_serving", "checks", "parallel",
                 "parallel.mesh", "parallel.launch", "bench", "bench_all", "bench_train"):
        assert f"vcr_tpu_torch.{name}" in mods
    assert "chip_smoke" in mods
    # nor what the JAX package's counterparts of the command line need:
    # nltk (tokenizer, stemmer), orbax (checkpoints), optax and flax
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "vcr_tpu", "nltk", "orbax", "optax",
                                  "flax")]
    assert bad == []


def test_serving_host_imports_only_the_op_library():
    """A host that runs an exported program imports ops.library and what it
    needs (chip_smoke.HOST_MODULES, which phase 13 holds on the card), not
    the models, the training code or the mesh."""
    import chip_smoke

    out = subprocess.run(
        [sys.executable, "-c", "import json, sys; import vcr_tpu_torch.ops.library; "
         "print(json.dumps(sorted(m for m in sys.modules "
         "if m.startswith('vcr_tpu_torch'))))"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout
    assert set(json.loads(out.strip().splitlines()[-1])) <= chip_smoke.HOST_MODULES


def test_native_code_reads_no_environment_variable():
    """The kernels', the op library's, the loader's and the artifacts' Python
    read no environment variable: the modes and routes are arguments."""
    pkg = os.path.join(ROOT, "vcr_tpu_torch")
    paths = [os.path.join(pkg, "ops", f) for f in os.listdir(os.path.join(pkg, "ops"))
             if f.endswith(".py")] + [os.path.join(pkg, "data", "native.py"),
                                      os.path.join(pkg, "export_serving.py"),
                                      os.path.join(pkg, "export_continuous.py")]
    for path in paths:
        with open(path) as f:
            assert "os.environ" not in f.read(), path


def test_harnesses_read_no_environment_variable():
    """The bench helpers, the probe, the sweep, the tuner, the checks, the
    mesh and the benches take their knobs as arguments and flags (the JAX
    modules' VCR_BENCH_*, VCR_PROBE_*, VCR_SKIP_PROBE, VCR_UPLOAD_CHUNK_MB,
    VCR_CHECKS_FORCE and VCR_COMPILE_CACHE)."""
    pkg = os.path.join(ROOT, "vcr_tpu_torch")
    for rel in ("utils/benchutil.py", "utils/backend_probe.py", "sweep.py",
                "tune_serving.py", "checks.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/launch.py", "bench.py", "bench_all.py",
                "bench_train.py"):
        with open(os.path.join(pkg, rel)) as f:
            text = f.read()
        assert "os.environ" not in text and "getenv" not in text, rel


@pytest.mark.parametrize("rel", ["serving_continuous.py", "tools.py", "server.py",
                                 "multiserver.py", "train/step.py", "nn/layers.py"])
def test_multi_device_serving_reads_no_environment_variable(rel):
    """The sharded pool, its command channel's callers, the daemons, the
    decode and SpatialNet's dp statistics take their layout from the mesh
    and the flags, not from the environment."""
    with open(os.path.join(ROOT, "vcr_tpu_torch", rel)) as f:
        text = f.read()
    assert "os.environ" not in text and "getenv" not in text, rel


def test_entry_points_raise_without_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims = dict(vocab_size=11, embed_size=4, hidden=8, vid_feat=6, max_len=3,
                num_frames=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.make_spec_and_params(**dims)
    spec, params = entry.make_spec_and_params(**dims, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_captioner(params, spec)
    tokens = serving.build_captioner(params, spec, device="cpu")(
        torch.zeros((2, 2, 6)))
    assert tokens.shape == (2, 3) and tokens.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_continuous.ContinuousCaptioner(params, spec, slots=2, admit_chunk=1)
    pool = serving_continuous.ContinuousCaptioner(params, spec, slots=2, admit_chunk=1,
                                                  device="cpu")
    assert all(1 <= len(t) <= 3 for t in pool.caption_all(
        {i: torch.randn((2, 6)).numpy() for i in range(3)}).values())
    spec, params = entry.make_spec_and_params(**dims, arch="rationale", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_captioner(params, spec)
    tokens = serving.build_captioner(params, spec, device="cpu")(
        torch.randn((2, 2, 6)))
    assert tokens.shape == (2, 3) and tokens.device.type == "cpu"
    opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step.build_step_fns("rationale", spec, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step.device_batch({"vid_feats": torch.zeros((2, 2, 6)),
                           "sent": torch.zeros((2, 3), dtype=torch.int32),
                           "sent_len": torch.ones((2,), dtype=torch.int32),
                           "valid": torch.ones((2,))})
    train, _ = step.build_step_fns("rationale", spec, opt, device="cpu")
    batch = step.device_batch({"vid_feats": torch.randn((2, 2, 6)),
                               "sent": torch.zeros((2, 3), dtype=torch.int32),
                               "sent_len": torch.ones((2,), dtype=torch.int32),
                               "valid": torch.ones((2,))}, "cpu")
    _, _, metrics, pred = train(params, opt.init(params), batch, 0, 1.0)
    assert metrics["loss"].device.type == "cpu" and pred.shape == (2, 3)
    # the benches: a row runs on the CPU when asked, and the timing and
    # every main refuse the CPU and a missing card before anything is built
    from vcr_tpu_torch import bench, bench_all, bench_train

    spec, params = entry.make_spec_and_params(**dims, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.flagship_row(spec, params, torch.zeros((2, 2, 6)), 2)
    row = bench.flagship_row(spec, params, torch.zeros((2, 2, 6)), 2, device="cpu")
    assert row.run_n(*row.args).shape == (2, 3)
    for main in (bench.main, bench_all.main, bench_train.main):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            main([])
        with pytest.raises(RuntimeError, match="a CPU time is not a device measurement"):
            main(["--device", "cpu"])


def test_featurizer_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The fused featurizers, the prep modes that run a backbone and
    eval_attention default to the card: without one they raise before any
    file is touched, and run on the CPU when asked."""
    from vcr_tpu_torch.config import Config
    from vcr_tpu_torch.data.prep import bbox_feats, video_feats
    from vcr_tpu_torch.evals import attention_export
    from vcr_tpu_torch.models import resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims = dict(vocab_size=11, embed_size=4, hidden=8, vid_feat=512, max_len=3,
                num_frames=2)
    spec, params = entry.make_spec_and_params(**dims, arch="s2vt-att", device="cpu")
    fp = resnet.init_params(torch.Generator().manual_seed(0), "resnet18")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_captioner(params, spec, "resnet", fp)
    tokens = serving.build_captioner(params, spec, "resnet", fp, device="cpu")(
        torch.zeros((1, 2, 3, 32, 32)))
    assert tokens.shape == (1, 3)
    (tmp_path / "msvd" / "clips").mkdir(parents=True)
    cfg = Config(data_dir=str(tmp_path), corpus="msvd", vision_arch="resnet18",
                 img_size=64, spatial_net_file=str(tmp_path / "none"))
    for run in (video_feats.extract_video_feats, bbox_feats.extract_bbox_feats,
                attention_export.run_export):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(cfg)
    assert os.listdir(tmp_path / "msvd") == ["clips"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _gru_case(g, cuda, t, b, hidden, dtype, batch_major=False):
    shape = (b, t, 3 * hidden) if batch_major else (t, b, 3 * hidden)
    x_gates = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w_hh = (torch.randn((hidden, 3 * hidden), generator=g, device=cuda)
            * (2.0 / (4 * hidden)) ** 0.5).to(dtype)
    b_hh = torch.randn((3 * hidden,), generator=g, device=cuda)
    h0 = torch.randn((b, hidden), generator=g, device=cuda)
    return x_gates, w_hh, b_hh, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
def test_gru_kernel_matches_plain_on_the_card(cuda, monkeypatch, dtype, tol):
    """B1 against its plain version; bf16 runs the tensor-core body (its
    counter moves), float32 the scalar body (it does not)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(0)
    for t, hidden, batches in ((7, 128, (1, 3, 8, 17)), (30, 512, (1, 17, 256))):
        for b in batches:
            args = _gru_case(g, cuda, t, b, hidden, dtype)
            before, tc_before = cuda_gru.launches, cuda_gru.launches_tc
            got = cuda_gru.gru_recurrence(*args, dtype)
            assert cuda_gru.launches == before + 1
            assert cuda_gru.launches_tc == tc_before + int(dtype == torch.bfloat16)
            want = cuda_gru.gru_recurrence_plain(*args, dtype)
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bt", "dma"])
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)])
def test_gru_variant_kernels_match_plain_on_the_card(cuda, monkeypatch, dtype, tol, variant):
    """B3 (batch-major) and B4 (copy pipeline) against their plain versions;
    each launch moves its own counter and not B1's. bf16 B3 runs B1's
    tensor-core body (launches_tc moves) and bf16 B4 its own (launches_dma_tc
    moves), and both equal B1 bit for bit there; B=2048 gives B4's warps
    several chunks each, so its copy rings wrap within a step. float32 runs
    the scalar bodies."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(0)
    wrapper, plain, counter = {
        "bt": (cuda_gru.gru_recurrence_bt, cuda_gru.gru_recurrence_bt_plain,
               "launches_bt"),
        "dma": (cuda_gru.gru_recurrence_dma, cuda_gru.gru_recurrence_plain,
                "launches_dma"),
    }[variant]
    bf16 = dtype == torch.bfloat16
    for t, hidden, batches in ((7, 128, (1, 3, 8, 17)), (30, 512, (1, 17, 256, 2048))):
        for b in batches:
            args = _gru_case(g, cuda, t, b, hidden, dtype, batch_major=variant == "bt")
            before, b1_before = getattr(cuda_gru, counter), cuda_gru.launches
            tc_before, dma_tc_before = cuda_gru.launches_tc, cuda_gru.launches_dma_tc
            got = wrapper(*args, dtype)
            assert getattr(cuda_gru, counter) == before + 1
            assert cuda_gru.launches == b1_before
            assert cuda_gru.launches_tc == tc_before + int(variant == "bt" and bf16)
            assert cuda_gru.launches_dma_tc == dma_tc_before + int(variant == "dma" and bf16)
            want = plain(*args, dtype)
            torch.cuda.synchronize()
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= tol
            if variant == "bt":
                b1 = cuda_gru.gru_recurrence(args[0].transpose(0, 1).contiguous(),
                                             *args[1:], dtype)
                assert torch.equal(got, b1.transpose(0, 1))
            elif bf16:
                assert torch.equal(got, cuda_gru.gru_recurrence(*args, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 1e-3), (torch.float32, 1e-4)])
def test_lstm_kernel_matches_plain_on_the_card(cuda, monkeypatch, dtype, tol, reverse):
    """B2 against its plain version; bf16 runs the tensor-core body (its
    counter moves), float32 the scalar body (it does not). H=512 at B=1024
    is one direction of RationaleNet's serving call; H=640, the widest the
    tensor-core body takes, runs it with fewer warps."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(0)
    for t, hidden, batches in ((7, 128, (1, 3, 8, 17)), (30, 512, (1024,)), (7, 640, (17,))):
        for b in batches:
            x_gates = torch.randn((t, b, 4 * hidden), generator=g, device=cuda).to(dtype)
            w_hh = (torch.randn((hidden, 4 * hidden), generator=g, device=cuda)
                    * (2.0 / (5 * hidden)) ** 0.5).to(dtype)
            b_hh = torch.randn((4 * hidden,), generator=g, device=cuda)
            h0 = torch.randn((b, hidden), generator=g, device=cuda)
            c0 = torch.randn((b, hidden), generator=g, device=cuda)
            before, tc_before = cuda_lstm.launches, cuda_lstm.launches_tc
            got = cuda_lstm.lstm_recurrence(x_gates, w_hh, b_hh, h0, c0, dtype, reverse)
            assert cuda_lstm.launches == before + 1
            assert cuda_lstm.launches_tc == tc_before + int(dtype == torch.bfloat16)
            want = cuda_lstm.lstm_recurrence_plain(x_gates, w_hh, b_hh, h0, c0, dtype,
                                                   reverse)
            torch.cuda.synchronize()
            for x, y in zip(got, want):  # outs, c_last
                assert (x - y).abs().max().item() <= tol


def _grads_both(cuda, fn, params, args, cot, dtype):
    """Gradients of sum(fn(...)[0] * cot) for every leaf of ``params`` and
    every tensor of ``args``, on the CPU and on the card."""
    out = []
    for device in ("cpu", cuda):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        a = [x.to(device).requires_grad_(True) for x in args]
        y = fn(p, *a, compute_dtype=dtype)[0]
        leaves = list(p.values()) + a
        out.append([g.cpu() for g in torch.autograd.grad((y * cot.to(device)).sum(),
                                                         leaves)])
    return out


# gradient leaves card vs CPU, relative to max(1, max|g|): float32 sums in
# other orders (TF32 off); in bf16 a sum that lands across a rounding step
# moves a product input by 2^-8, so one such step at the largest gradient
GRAD_TOLS = [(torch.bfloat16, 4e-3), (torch.float32, 1e-4)]


def _assert_grads_close(got, want, tol):
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", GRAD_TOLS)
def test_gru_sequence_gradient_on_the_card_matches_cpu(cuda, monkeypatch, dtype, tol):
    """B1's Function: one B1 launch in the forward, none in the backward
    (the plain recompute), and the CPU's gradients for w_ih, b_ih, w_hh,
    b_hh, xs and h0."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    t, b, i, hidden = 7, 17, 64, 128
    params = rnn.gru_init(g, i, hidden)
    xs, h0 = torch.randn((t, b, i), generator=g), torch.randn((b, hidden), generator=g)
    cot = torch.randn((t, b, hidden), generator=g)
    before = cuda_gru.launches
    want, got = _grads_both(cuda, cuda_gru.gru_sequence_fused, params, [xs, h0], cot,
                            dtype)
    torch.cuda.synchronize()
    assert cuda_gru.launches == before + 1
    _assert_grads_close(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype, tol", GRAD_TOLS)
def test_lstm_sequence_gradient_on_the_card_matches_cpu(cuda, monkeypatch, dtype, tol, reverse):
    """B2's Function in either direction: one B2 launch, and the CPU's
    gradients for every input."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(1)
    t, b, i, hidden = 7, 17, 64, 128
    params = rnn.lstm_init(g, i, hidden)
    xs = torch.randn((t, b, i), generator=g)
    h0, c0 = torch.randn((b, hidden), generator=g), torch.randn((b, hidden), generator=g)
    cot = torch.randn((t, b, hidden), generator=g)

    def fn(p, x, h, c, compute_dtype):
        return cuda_lstm.lstm_sequence_fused(p, x, (h, c), reverse, compute_dtype)

    before = cuda_lstm.launches
    want, got = _grads_both(cuda, fn, params, [xs, h0, c0], cot, dtype)
    torch.cuda.synchronize()
    assert cuda_lstm.launches == before + 1
    _assert_grads_close(got, want, tol)


@pytest.mark.cuda
def test_bf16_vdot_gradient_on_the_card_equals_cpu(cuda):
    """The card's product (``_MatmulF32``) against the CPU branch, on values
    whose float32 products and sums are exact: equal bit for bit."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-8, 9, (64, 96), generator=g) / 4
    w = torch.randint(-8, 9, (96, 40), generator=g) / 4
    cot = torch.randint(-16, 17, (64, 40), generator=g) / 8
    out = []
    for device in ("cpu", cuda):
        a, b = x.to(device).requires_grad_(True), w.to(device).requires_grad_(True)
        y = layers.vdot(a, b, torch.bfloat16)
        out.append([y.cpu()] + [t.cpu() for t in torch.autograd.grad(
            y, (a, b), cot.to(device))])
    for want, got in zip(*out):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bmm_f32_on_the_card_equals_cpu(cuda, monkeypatch, dtype):
    """The batched product with a float32 result (``_BmmF32``, cuBLAS's
    float32-output bmm, in bf16) against the CPU branch, forward and
    gradients, on values whose products and sums are exact: equal bit for
    bit."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(6)
    a = torch.randint(-8, 9, (2, 3, 5, 64), generator=g) / 4
    b = torch.randint(-8, 9, (2, 3, 64, 20), generator=g) / 4
    cot = torch.randint(-16, 17, (2, 3, 5, 20), generator=g) / 8
    out = []
    for device in ("cpu", cuda):
        x, w = a.to(device).requires_grad_(True), b.to(device).requires_grad_(True)
        y = layers.bmm_f32(x, w, dtype)
        assert y.dtype == torch.float32
        out.append([y.detach().cpu()] + [t.cpu() for t in torch.autograd.grad(
            y, (x, w), cot.to(device))])
    for want, got in zip(*out):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_transformer_on_the_card_equals_cpu(cuda, monkeypatch):
    """The Transformer in float32 (TF32 off), no kernel of the port launched:
    the parity greedy's logits and tokens, the KV-cached greedy's and the
    lineage beam's tokens on the card equal the CPU's; a train step's loss
    and every gradient leaf (dropouts at 0) agree with the CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(transformer, "INTERNAL_DROPOUT", 0.0)
    dims = dict(vocab_size=40, embed_size=16, hidden=32, vid_feat=64, max_len=7,
                num_frames=6)
    spec, params = entry.make_spec_and_params(**dims, arch="transformer", tf_layers=2,
                                              tf_heads=4, compute_dtype="float32",
                                              device="cpu")
    g = torch.Generator().manual_seed(3)
    feats = torch.randn((5, 6, 64), generator=g)
    before = (cuda_gru.launches, cuda_lstm.launches)
    for kw in ({}, {"beam_size": 3}):
        want = serving.build_captioner(params, spec, device="cpu", **kw)(feats)
        assert torch.equal(serving.build_captioner(params, spec, **kw)(feats).cpu(), want)
    with torch.no_grad():
        logits = [transformer.apply(params_to(params, d), spec, feats.to(d)).cpu()
                  for d in ("cpu", cuda)]
        lineage = [decode.transformer_beam_decode_fast(
            params_to(params, d), spec, feats.to(d), 3, spec.sos_id + 1,
            lineage=True)[0].cpu() for d in ("cpu", cuda)]
    assert (logits[0] - logits[1]).abs().max().item() <= 1e-4
    assert torch.equal(logits[0].argmax(-1), logits[1].argmax(-1))
    assert torch.equal(lineage[0], lineage[1])
    s, s_len = torch.randint(0, 40, (5, 7), generator=g), torch.tensor([7, 3, 5, 1, 6])
    results = []
    for device in ("cpu", cuda):
        p = params_to(params, device)
        leaves = optim.trainable_leaves(p)[1]
        for x in leaves:
            x.requires_grad_(True)
        logits = transformer.apply(p, spec.with_(dropout_p=0.0), feats.to(device),
                                   s.to(device), s_len.to(device), train=True)
        loss = logits[..., :40].logsumexp(-1).mean()
        results.append((loss.item(), [x.cpu() for x in torch.autograd.grad(loss, leaves)]))
    torch.cuda.synchronize()
    assert (cuda_gru.launches, cuda_lstm.launches) == before
    assert abs(results[0][0] - results[1][0]) <= 1e-5
    _assert_grads_close(results[1][1], results[0][1], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, beam", [("s2vt", 1), ("s2vt", 3), ("rationale", 1),
                                        ("transformer", 1), ("transformer", 3)])
def test_slot_pool_on_the_card_equals_cpu(cuda, monkeypatch, arch, beam):
    """The continuous pool in float32 (TF32 off) on the card and on the CPU,
    the same requests in the same order: the same harvested tokens, and on
    the card the kernels launched at admission (S2VT: B1 twice per chunk;
    RationaleNet: B2 twice and B1 twice; the Transformer: none)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dims = dict(vocab_size=40, embed_size=16, hidden=32, vid_feat=64, max_len=7,
                num_frames=6)
    kw = {"tf_layers": 2, "tf_heads": 4} if arch == "transformer" else {}
    spec, params = entry.make_spec_and_params(**dims, arch=arch, compute_dtype="float32",
                                              device="cpu", **kw)
    feats = torch.randn((9, 6, 64), generator=torch.Generator().manual_seed(4)).numpy()
    noise = (lambda c: torch.zeros((2, 6, 2))) if arch == "rationale" else None
    out, launches = [], []
    for device in ("cpu", cuda):
        pool = serving_continuous.ContinuousCaptioner(
            params, spec, slots=4, admit_chunk=2, beam_size=beam, select_noise=noise,
            device=device)
        before = (cuda_gru.launches, cuda_lstm.launches)
        out.append(pool.caption_all(dict(enumerate(feats))))
        torch.cuda.synchronize()
        launches.append((cuda_gru.launches - before[0], cuda_lstm.launches - before[1],
                         pool.stats["admit_chunks"]))
    assert sorted(out[0]) == sorted(out[1]) == list(range(9))
    assert all((out[0][k] == out[1][k]).all() and len(out[0][k]) == len(out[1][k])
               for k in out[0])
    b1, b2, chunks = launches[1]
    assert (b1, b2) == {"s2vt": (2 * chunks, 0), "rationale": (2 * chunks, 2 * chunks),
                        "transformer": (0, 0)}[arch]


@pytest.mark.cuda
def test_command_line_on_the_card(cuda, tmp_path):
    """train -> eval -> decode (beam and greedy) through cli.main on the card,
    on the tiny corpus: B1 twice per train step, per greedy eval step and per
    beam or greedy decode call; B2, B3 and B4 never."""
    build_corpus(str(tmp_path / "data"))
    io = ["--data_dir", str(tmp_path / "data"), "--corpus", "msvd_vgg",
          "--glove_emb_file", "glove_tiny.txt", "--save_path", str(tmp_path / "models")]
    train = io + ["--mode", "train", "--num_frames", "4", "--vid_feat_size", "12",
                  "--max_len", "6", "--hidden_size", "16", "--bsize", "4", "--epochs", "2",
                  "--log_dir", "", "--beam_size", "3"]
    # 6 train videos in batches of 4: 2 steps an epoch; 3 val videos: 1 batch,
    # its greedy eval step and its beam search
    runs = [(train, 2 * (2 * 2 + 2 + 2)), (io + ["--mode", "eval", "--beam_size", "3"],
                                          2 + 2),
            (io + ["--mode", "decode", "--beam_size", "3"], 2),
            (io + ["--mode", "decode"], 2)]
    for argv, b1 in runs:
        cuda_gru.launches = cuda_gru.launches_bt = cuda_gru.launches_dma = 0
        cuda_lstm.launches = 0
        out = cli.main(argv)
        torch.cuda.synchronize()
        assert (cuda_gru.launches, cuda_gru.launches_bt, cuda_gru.launches_dma,
                cuda_lstm.launches) == (b1, 0, 0, 0), argv
    assert len(out) == 3 and all(len(r["tokens"]) == 6 for r in out)
    with open(tmp_path / "models" / "captions.json") as f:
        assert json.load(f) == out


@pytest.mark.cuda
def test_s2vt_att_on_the_card_equals_cpu(cuda, monkeypatch):
    """S2VT-att in float32 (TF32 off): greedy tokens on the card equal the
    CPU's and logits agree, with one B1 launch per call; AttentionScan's
    gradient for every input on the card equals the CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dims = dict(vocab_size=40, embed_size=16, hidden=128, vid_feat=64, max_len=7,
                num_frames=6)
    spec, params = entry.make_spec_and_params(**dims, arch="s2vt-att",
                                              compute_dtype="float32", device="cpu")
    feats = torch.randn((5, 6, 64), generator=torch.Generator().manual_seed(3))
    want = serving.build_captioner(params, spec, device="cpu")(feats)
    before = cuda_gru.launches
    got = serving.build_captioner(params, spec)(feats)
    torch.cuda.synchronize()
    assert cuda_gru.launches == before + 1
    assert torch.equal(got.cpu(), want)
    with torch.no_grad():
        logits = [s2vt_att.apply(params_to(params, d), spec, feats.to(d)).cpu()
                  for d in ("cpu", cuda)]
    assert (logits[0] - logits[1]).abs().max().item() <= 1e-4
    g = torch.Generator().manual_seed(4)
    hidden, emb = 128, 16
    qv = attention.bahdanau_init(g, hidden)
    gru = rnn.gru_init(g, hidden + emb, hidden)
    args = [torch.randn(s, generator=g) for s in ((5, 6, hidden), (5, 6, hidden),
                                                 (5, hidden), (7, 5, emb))]
    cot = torch.randn((7, 5, hidden), generator=g)
    out = []
    for device in ("cpu", cuda):
        leaves = ([x.to(device).requires_grad_(True) for x in
                   (qv["query_layer"]["w"], qv["energy_layer"]["w"])]
                  + [gru[k].to(device).requires_grad_(True)
                     for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
                  + [a.to(device).requires_grad_(True) for a in args])
        states = s2vt_att.AttentionScan.apply(torch.float32, *leaves)
        out.append([x.cpu() for x in torch.autograd.grad(states, leaves, cot.to(device))])
    _assert_grads_close(out[1], out[0], 1e-4)


@pytest.mark.cuda
def test_spatial_on_the_card_equals_cpu(cuda, monkeypatch):
    """SpatialNet over S2VT in float32, TF32 off for cuBLAS and cuDNN: greedy
    tokens on the card equal the CPU's, logits and attention maps agree, one
    B1 launch per call; a train step's loss, BN running stats and every
    gradient leaf on the card agree with the CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    dims = dict(vocab_size=40, embed_size=16, hidden=128, vid_feat=64, max_len=7,
                num_frames=6)
    spec, params = entry.make_spec_and_params(**dims, arch="spatial", grid_size=5,
                                              compute_dtype="float32", device="cpu")
    g = torch.Generator().manual_seed(3)
    feats = torch.randn((4, 6, 64, 5, 5), generator=g)
    want = serving.build_captioner(params, spec, device="cpu")(feats)
    before = cuda_gru.launches
    got = serving.build_captioner(params, spec)(feats)
    torch.cuda.synchronize()
    assert cuda_gru.launches == before + 1
    assert torch.equal(got.cpu(), want)
    with torch.no_grad():
        out = [spatial.apply(params_to(params, d), spec, feats.to(d)) for d in ("cpu", cuda)]
    assert (out[0][0] - out[1][0].cpu()).abs().max().item() <= 1e-4
    assert (out[0][1] - out[1][1].cpu()).abs().max().item() <= 1e-5
    s = torch.randint(0, 40, (4, 7), generator=g)
    results = []
    for device in ("cpu", cuda):
        p = params_to(params, device)
        leaves = optim.trainable_leaves(p)[1]
        for x in leaves:
            x.requires_grad_(True)
        logits, _, bn = spatial.apply(p, spec.with_(dropout_p=0.0), feats.to(device),
                                      s.to(device), train=True)
        loss = logits.logsumexp(-1).mean()
        results.append((loss.item(), [x.cpu() for x in torch.autograd.grad(loss, leaves)],
                        bn["bn2"]["var"].detach().cpu()))
    assert abs(results[0][0] - results[1][0]) <= 1e-5
    assert (results[0][2] - results[1][2]).abs().max().item() <= 1e-5
    _assert_grads_close(results[1][1], results[0][1], 1e-4)


@pytest.mark.cuda
def test_conv2d_float32_on_the_card_ignores_cudnn_tf32(cuda, monkeypatch):
    """A float32 conv and its gradients are float32 on the card even where
    the caller leaves cuDNN's TF32 on (PyTorch's default): they agree with
    the CPU's float32 conv to 1e-4, where TF32 (a 10-bit mantissa) is off by
    about 1e-3 at these widths. The caller's flag is left as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    g = torch.Generator().manual_seed(5)
    params = layers.conv2d_init(g, 256, 64, 3)
    x = torch.randn((2, 256, 13, 13), generator=g)
    cot = torch.randn((2, 64, 13, 13), generator=g)
    out = []
    for device in ("cpu", cuda):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        xd = x.to(device).requires_grad_(True)
        y = layers.conv2d(p, xd, torch.float32)
        grads = torch.autograd.grad((y * cot.to(device)).sum(), (p["w"], xd))
        out.append([y.detach().cpu()] + [t.cpu() for t in grads])
    assert torch.backends.cudnn.allow_tf32
    _assert_grads_close(out[1], out[0], 1e-4)


@pytest.mark.cuda
def test_strided_conv_float32_on_the_card_ignores_cudnn_tf32(cuda, monkeypatch):
    """The backbones' conv (``layers.conv2d_f32``) in float32 at each
    stride and padding they use is float32 on the card with cuDNN's TF32
    left on by the caller: within 1e-5 of the CPU's relative to the largest
    output, where TF32 is off by about 1e-3. The flag is left as it was."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    g = torch.Generator().manual_seed(6)
    for k, stride, pad in ((3, 1, 1), (7, 2, 3), (3, 2, 1), (1, 2, 0), (1, 1, 0)):
        x = torch.randn((2, 128, 27, 27), generator=g)
        w = torch.randn((96, 128, k, k), generator=g) * (2.0 / (128 * k * k)) ** 0.5
        want = layers.conv2d_f32(x, w, stride, pad, torch.float32)
        got = layers.conv2d_f32(x.to(cuda), w.to(cuda), stride, pad, torch.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max(), (k, stride)
    assert torch.backends.cudnn.allow_tf32


# bf16 features, card against CPU, relative to the largest |feature|
# (ROADMAP §C): each layer's bf16 activations round apart where a float32
# sum differs in its last bit, and the card's cuDNN also rounds each conv's
# output to bf16, where the CPU (and the JAX package) keep it float32
CARD_BF16_FEATURE_GAP = {"vgg16": 0.03, "resnet34": 0.03, "darknet": 0.03}


def _card_backbone(name, gen):
    """(featurize(params, frames), params, frames) of a backbone at a small
    input: VGG16's 13 convs at 64x64 with fc6/fc7 of (2048, 256) and (256,
    256), ResNet-34 at 64x64, Darknet-53 and YOLOv3's first head at 64x64."""
    from vcr_tpu_torch.models import darknet, resnet, vgg

    if name == "vgg16":
        params = vgg.init_params(torch.Generator().manual_seed(0))
        params["fc6"] = {"w": 0.02 * torch.randn((2048, 256), generator=gen),
                         "b": torch.zeros((256,))}
        params["fc7"] = {"w": 0.05 * torch.randn((256, 256), generator=gen),
                         "b": torch.zeros((256,))}
        return vgg.extract_fc7, params, 64
    if name == "resnet34":
        return resnet.extract_features, resnet.init_params(gen, "resnet34"), 64
    blocks = darknet.parse_cfg_text(darknet.yolov3_first_head_cfg(64))
    net = darknet.Darknet.from_blocks(blocks, darknet.init_params(gen, blocks),
                                      np.zeros(5, dtype=np.int32))
    return (lambda p, x, cd: net.get_feats(x, cd, params=p)), net.params, 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_BF16_FEATURE_GAP))
def test_backbone_bf16_on_the_card_within_its_envelope(cuda, name):
    """Each backbone in bf16 on the card against the port on the CPU (which
    equals the JAX package, tests/test_torch_backbones.py): features within
    the measured envelope; in float32 (TF32 off) within 1e-5."""
    featurize, params, size = _card_backbone(name, torch.Generator().manual_seed(7))
    x = torch.randn((3, 3, size, size), generator=torch.Generator().manual_seed(8))
    on_card = params_to(params, cuda)
    for dtype, bound in ((torch.bfloat16, CARD_BF16_FEATURE_GAP[name]),
                         (torch.float32, 1e-5)):
        with torch.inference_mode():
            want = featurize(params, x, dtype)
            got = featurize(on_card, x.to(cuda), dtype).cpu()
        gap = ((got - want).abs().max() / want.abs().max()).item()
        print(f"{name} {dtype}: card against CPU {gap:.3e} (bound {bound})")
        assert got.dtype == torch.float32 and gap <= bound


# ResNet-34 -> S2VT-att, bf16, over chip_smoke.py phase 14's 16 videos: the
# card's tokens against the CPU's (JAX's arithmetic). Read 0.7125 (228 of 320
# tokens, 7 of 16 rows) under the package's route (cuDNN's bf16 conv, whose
# output is rounded to bf16), against 0.684 (9 rows) under a TF32 conv of
# the bf16-rounded operands, whose features are closer (5.7e-3 against
# 1.70e-2 of the largest feature) at 1.13x the backbone's ms
# (scripts/featurizer_token_agreement.py). Neither reaches 0.98: on random
# weights the logits are flat (std 0.087 over the vocabulary, the median
# step's top-1 margin 0.015, a tenth of the steps below 0.003), so the
# features' bf16 rounding flips some steps, and greedy decoding carries a
# flip on to the end of its row. The bound holds the measured figure, less
# four tokens.
RESNET_TOKEN_AGREEMENT = 0.70


@pytest.mark.cuda
def test_resnet34_s2vt_att_tokens_on_the_card_against_cpu(cuda):
    from vcr_tpu_torch.models import resnet

    spec, params = entry.make_spec_and_params(**entry.S2VT_ATT, device=cuda)
    fp_cpu = resnet.init_params(torch.Generator().manual_seed(0), "resnet34")
    g = torch.Generator(device=cuda).manual_seed(14)
    frames = torch.randn((16, spec.num_frames, 3, 224, 224), generator=g,
                         device=cuda).to(torch.bfloat16)
    card = serving.build_captioner(params, spec, "resnet", params_to(fp_cpu, cuda),
                                   device=cuda)(frames).cpu()
    cpu = serving.build_captioner(params_to(params, "cpu"), spec, "resnet", fp_cpu,
                                  device="cpu")(frames.float().cpu())
    agreement = (card == cpu).float().mean().item()
    print(f"ResNet-34 -> S2VT-att token agreement {agreement:.4f} "
          f"(bound {RESNET_TOKEN_AGREEMENT})")
    assert agreement >= RESNET_TOKEN_AGREEMENT


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quantized_stepper_on_the_card_equals_cpu(cuda, monkeypatch, kv):
    """The Transformer's KV-cached stepper under a quantized cache and int8
    weights, in float32 (TF32 off), the lineage form: the card's logits
    agree with the CPU's to 1e-4 and its cache codes equal theirs but for
    rare codes one step apart."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dims = dict(vocab_size=40, embed_size=16, hidden=32, vid_feat=64, max_len=6,
                num_frames=5)
    spec, params = entry.make_spec_and_params(**dims, arch="transformer", tf_layers=2,
                                              tf_heads=4, compute_dtype="float32",
                                              device="cpu")
    feats = torch.randn((3, 5, 64), generator=torch.Generator().manual_seed(3))
    words = torch.randint(0, 40, (6, 6), generator=torch.Generator().manual_seed(4),
                          dtype=torch.int32)
    runs = []
    for device in ("cpu", cuda):
        p = params_to(params, device)
        x = feats.to(device)
        eo = transformer.encode(p, spec, x, transformer.create_masks_inp(x))
        step, st, _ = transformer.make_cached_stepper(
            p, spec, eo, beam_tile=2, lineage=True, kv_cache=kv, decode_weights="int8")
        logits = []
        for i in range(spec.max_len):
            st, lg = step(st, words[i].to(device), i)
            logits.append(lg.cpu())
        runs.append((logits, [t.cpu() for t in st["c1"]]))
    for got, want in zip(runs[1][0], runs[0][0]):
        assert (got - want).abs().max().item() <= 1e-4
    # a code on a rounding tie may move by one where the card's float32 sums
    # differ from the CPU's in the last bit: rare, never more than one step
    for j in (0, 2):                                      # k and v codes
        gap = (kvquant.unpack(runs[1][1][j]).int() - kvquant.unpack(runs[0][1][j]).int())
        assert gap.abs().max().item() <= 1 and (gap != 0).float().mean().item() <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["s2vt", "rationale"])
def test_artifact_exported_on_the_cpu_runs_the_kernels_on_the_card(cuda, monkeypatch,
                                                                   tmp_path, arch):
    """An artifact exported on the CPU and loaded on the card launches B1
    (and B2) there, and its float32 tokens (TF32 off) equal the CPU's; the
    frozen pool likewise, with B1 twice per admission chunk."""
    from vcr_tpu_torch import export_continuous, export_serving

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dims = dict(vocab_size=40, embed_size=16, hidden=32, vid_feat=64, max_len=7,
                num_frames=6)
    spec, params = entry.make_spec_and_params(**dims, arch=arch, compute_dtype="float32",
                                              device="cpu")
    feats = torch.randn((5, 6, 64), generator=torch.Generator().manual_seed(6))
    out = export_serving.export_captioner(params, spec, str(tmp_path / "a"), device="cpu")
    want = export_serving.load_artifact(out, device="cpu")(feats)
    art = export_serving.load_artifact(out, device=cuda)
    before = (cuda_gru.launches, cuda_lstm.launches)
    got = art(feats)
    torch.cuda.synchronize()
    assert (cuda_gru.launches - before[0], cuda_lstm.launches - before[1]) == (
        2, 2 if arch == "rationale" else 0)
    # RationaleNet's noise is drawn on each device from its own generator:
    # the card's stream is not the CPU's, so the CPU's noise is fed to both
    if arch == "rationale":
        noise = art.noise(5)
        cpu_art = export_serving.load_artifact(out, device="cpu")
        with torch.no_grad():
            want = cpu_art._module(cpu_art.leaves, feats, [noise[0].cpu()])
            got = art._module(art.leaves, feats.to(cuda), noise)
    assert torch.equal(got.cpu(), want)
    if arch == "s2vt":
        pool_dir = export_continuous.export_continuous(params, spec, str(tmp_path / "p"),
                                                       slots=4, admit_chunk=2,
                                                       device="cpu")
        reqs = dict(enumerate(feats.numpy()))
        on_cpu = export_continuous.load_continuous(pool_dir, device="cpu").caption_all(reqs)
        pool = export_continuous.load_continuous(pool_dir, device=cuda)
        before = cuda_gru.launches
        on_card = pool.caption_all(reqs)
        torch.cuda.synchronize()
        assert cuda_gru.launches - before == 2 * pool.stats["admit_chunks"]
        assert all(np.array_equal(on_card[k], on_cpu[k]) for k in reqs)


@pytest.mark.cuda
def test_sharded_flagship_pool_on_the_card(cuda):
    """Two processes on the one card over gloo, the flagship pool sharded
    dp=2 (R=64, A=16, a burst of 64): at least 98% of the tokens equal the
    one-process pool's (bf16 near-ties may flip), and each rank launches B1
    twice per admission chunk, on the tensor-core body."""
    import chip_smoke

    pool = dict(slots=64, admit=16, step=4, requests=64, seed=31)
    ranks = chip_smoke.run_mesh_workers({"flagship": pool})
    one = chip_smoke.one_process_pool("FLAGSHIP", pool)
    lead = ranks[0]["flagship"]
    assert chip_smoke.token_agreement(lead["tokens"], one["tokens"]) >= 0.98
    chunks = lead["admit_chunks"]
    for r in ranks:
        assert r["flagship"]["launches"] == {"gru_seq": 2 * chunks, "gru_seq_tc": 2 * chunks,
                                             "lstm_seq": 0, "lstm_seq_tc": 0}


@pytest.mark.cuda
def test_flagship_bench_row_on_the_card(cuda):
    """The flagship bench's row on the card: its tokens are
    build_captioner's on the same features, each captioner call launches B1
    twice, and the timing returns a positive time and an MFU."""
    from vcr_tpu_torch import bench
    from vcr_tpu_torch.utils import benchutil

    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device=cuda)
    feats = bench.normal_feats(np.random.default_rng(0),
                               (64, spec.num_frames, spec.vid_feat_size), cuda)
    row = bench.flagship_row(spec, params, feats, 2, cuda)
    assert torch.equal(row.run_n(*row.args), serving.build_captioner(params, spec)(feats))
    timed = bench.measure(row, cuda)
    assert timed["best_s"] > 0 and timed["median_s"] >= timed["best_s"]
    assert timed["flops"] > 0 and timed["launches"]["gru_seq"] == 4
    assert timed["launches"]["gru_seq_tc"] == 4 and timed["launches"]["lstm_seq"] == 0
    assert benchutil.mfu(timed["flops"], timed["best_s"], cuda) == timed["mfu"]


@pytest.mark.cuda
def test_bench_row_launches_come_from_its_timed_call(cuda):
    """A row's launches are read around its own timed call: a row whose
    timed call launches no kernel reads none, though the call its products
    are counted on launches B1 twice; the S2VT artifact's row reads the
    exported program's own launches, B1 twice per call."""
    from vcr_tpu_torch import bench, bench_all

    dims = dict(vocab_size=40, embed_size=16, hidden=32, vid_feat=64, max_len=7,
                num_frames=6)
    spec, params = entry.make_spec_and_params(**dims, device=cuda)
    feats = torch.randn((5, 6, 64), generator=torch.Generator().manual_seed(6)).to(cuda)
    caption = serving.build_captioner(params, spec)
    row = bench.Row(lambda x: x + 1, (feats,), 5, "no kernel", (caption, (feats,), 1))
    timed = bench.measure(row, cuda)
    assert timed["flops"] > 0 and not any(timed["launches"].values())
    art = bench_all.artifact_row(spec, params, feats.bfloat16(), 3, dims["vocab_size"] - 3,
                                 cuda)
    timed = bench.measure(art, cuda)
    assert timed["launches"]["gru_seq"] == 6 and timed["launches"]["lstm_seq"] == 0

