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

from vcr_tpu_torch import entry, serving
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    for name in ("serving", "ops.cuda_gru", "ops.cuda_lstm", "models.rationale"):
        assert f"vcr_tpu_torch.{name}" in mods
    bad = [m for m in mods
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "vcr_tpu" or m.startswith("vcr_tpu.")]
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
