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

import pytest
import torch

from vcr_tpu_torch import cli, entry, serving
from vcr_tpu_torch.nn import layers, rnn
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm
from vcr_tpu_torch.train import optim, step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from util_corpus import build_corpus  # noqa: E402

_IMPORT_ALL = """
import json, pkgutil, sys
import vcr_tpu_torch
for m in pkgutil.walk_packages(vcr_tpu_torch.__path__, "vcr_tpu_torch."):
    __import__(m.name)
print(json.dumps(sorted(sys.modules)))
"""


def test_port_imports_no_jax_and_nothing_of_vcr_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])
    for name in ("serving", "ops.cuda_gru", "ops.cuda_lstm", "models.rationale",
                 "train", "train.losses", "train.optim", "train.schedule", "train.step",
                 "cli", "config", "decode", "tools", "vocab", "train.loop",
                 "train.checkpoint", "evals.metrics", "evals.porter", "data.captions",
                 "data.pipeline", "utils.logging", "utils.profiling", "utils.sampler"):
        assert f"vcr_tpu_torch.{name}" in mods
    # nor what the JAX package's counterparts of the command line need:
    # nltk (tokenizer, stemmer), orbax (checkpoints), optax and flax
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "vcr_tpu", "nltk", "orbax", "optax",
                                  "flax")]
    assert bad == []


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
def test_gru_kernel_matches_plain_on_the_card(cuda, dtype, tol):
    """B1 against its plain version; bf16 runs the tensor-core body (its
    counter moves), float32 the scalar body (it does not)."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_gru_variant_kernels_match_plain_on_the_card(cuda, dtype, tol, variant):
    """B3 (batch-major) and B4 (copy pipeline) against their plain versions;
    each launch moves its own counter and not B1's. bf16 B3 runs B1's
    tensor-core body (launches_tc moves) and bf16 B4 its own (launches_dma_tc
    moves), and both equal B1 bit for bit there; B=2048 gives B4's warps
    several chunks each, so its copy rings wrap within a step. float32 runs
    the scalar bodies."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_lstm_kernel_matches_plain_on_the_card(cuda, dtype, tol, reverse):
    """B2 against its plain version; bf16 runs the tensor-core body (its
    counter moves), float32 the scalar body (it does not). H=512 at B=1024
    is one direction of RationaleNet's serving call; H=640, the widest the
    tensor-core body takes, runs it with fewer warps."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_gru_sequence_gradient_on_the_card_matches_cpu(cuda, dtype, tol):
    """B1's Function: one B1 launch in the forward, none in the backward
    (the plain recompute), and the CPU's gradients for w_ih, b_ih, w_hh,
    b_hh, xs and h0."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_lstm_sequence_gradient_on_the_card_matches_cpu(cuda, dtype, tol, reverse):
    """B2's Function in either direction: one B2 launch, and the CPU's
    gradients for every input."""
    torch.backends.cuda.matmul.allow_tf32 = False
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
