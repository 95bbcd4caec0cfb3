"""The port's bench helpers (``vcr_tpu_torch.utils.benchutil``) against the
JAX package's on the CPU: the FLOP count of one eval forward equals
``vcr_tpu.utils.benchutil.jaxpr_flops`` of the same model and weights, the
custom ops' formulas equal their plain versions' counts, the MFU and peak
refusals, the gather bytes of a beam reorder, and the chunked copy."""

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import __graft_entry__ as graft
from vcr_tpu.models import base as jbase
from vcr_tpu.utils import benchutil as jbench
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch.decode import gather_rows
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm
from vcr_tpu_torch.utils import benchutil

DIMS = dict(vocab_size=128, embed_size=16, hidden=64, vid_feat=12, max_len=5,
            num_frames=6)
B = 4


@pytest.mark.parametrize("arch, extra", [("s2vt", {}),
                                         ("rationale", {"base_arch": "s2vt"}),
                                         ("s2vt-att", {})])
def test_eval_forward_flops_equal_the_jax_walker(arch, extra):
    """The same weights through both packages' eval forward (greedy logits):
    the JAX walker counts every dot_general of the plain recurrences
    (use_pallas=False), the port's FlopCounterMode the aten products plus
    the formulas of B1 and B2, whose ops it cannot see into. Both packages
    compute the same products (the primed GRU2's row-sliced W_ih in each:
    vcr_tpu/models/s2vt.py and vcr_tpu_torch/models/s2vt.py, _prime_state2),
    so nothing is added by formula."""
    kw = dict(DIMS, arch=arch, compute_dtype="float32", **extra)
    jspec, jparams = graft._make_spec_and_params(**kw, use_pallas=False)
    tspec, _ = entry.make_spec_and_params(**kw, device="cpu")
    tparams = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    feats = np.random.default_rng(0).standard_normal(
        (B, DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32)
    _, japply = jbase.build_model(arch)
    _, tapply = tbase.build_model(arch)
    want = jbench.jaxpr_flops(
        lambda p, x: japply(p, jspec, x, train=False, rng=jax.random.PRNGKey(0)),
        jparams, feats)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tapply(tparams, tspec, torch.from_numpy(feats), rng=0, train=False)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert by_op.get("vcr_tpu_torch.gru_recurrence", 0) > 0
    assert (by_op.get("vcr_tpu_torch.lstm_recurrence", 0) > 0) == (arch == "rationale")
    got = benchutil.flops(
        lambda: tapply(tparams, tspec, torch.from_numpy(feats), rng=0, train=False))
    assert got == counter.get_total_flops() == want


def _plain_flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("t, b, hidden", [(5, 3, 8), (2, 7, 16)])
def test_op_formulas_equal_their_plain_versions(t, b, hidden):
    g = torch.Generator().manual_seed(0)
    ops = torch.ops.vcr_tpu_torch
    f32 = torch.float32
    xg = torch.randn((t, b, 3 * hidden), generator=g)
    gru = (xg, torch.randn((hidden, 3 * hidden), generator=g),
           torch.randn((3 * hidden,), generator=g), torch.randn((b, hidden), generator=g))
    want = _plain_flops(cuda_gru.gru_recurrence_plain, *gru, f32)
    assert want == t * 2 * b * hidden * 3 * hidden
    assert benchutil.flops(ops.gru_recurrence, *gru, f32) == want
    assert benchutil.flops(ops.gru_recurrence_dma, *gru, f32) == want
    bt = (xg.transpose(0, 1).contiguous(), *gru[1:])
    assert benchutil.flops(ops.gru_recurrence_bt, *bt, f32) == \
        _plain_flops(cuda_gru.gru_recurrence_bt_plain, *bt, f32) == want
    lstm = (torch.randn((t, b, 4 * hidden), generator=g),
            torch.randn((hidden, 4 * hidden), generator=g),
            torch.randn((4 * hidden,), generator=g), torch.randn((b, hidden), generator=g),
            torch.randn((b, hidden), generator=g))
    for reverse in (False, True):
        want = _plain_flops(cuda_lstm.lstm_recurrence_plain, *lstm, f32, reverse)
        assert want == t * 2 * b * hidden * 4 * hidden
        assert benchutil.flops(ops.lstm_recurrence, *lstm, f32, reverse) == want
    # the product ops count as the aten products they stand for
    x, w = torch.randn((2, b, hidden)), torch.randn((hidden, 5))
    assert benchutil.flops(ops.mm_f32, x, w) == _plain_flops(torch.matmul, x, w)
    a, c = torch.randn((3, 2, b, hidden)), torch.randn((3, 2, hidden, 4))
    assert benchutil.flops(ops.bmm_f32, a, c) == _plain_flops(torch.matmul, a, c)
    img, k = torch.randn((2, 3, 9, 9)), torch.randn((4, 3, 3, 3))
    assert benchutil.flops(ops.conv2d_same, img, k) == _plain_flops(
        lambda u, v: torch.nn.functional.conv2d(u, v, padding=1), img, k)
    assert benchutil.flops(ops.conv2d_f32out, img, k, [2, 2], [1, 1]) == _plain_flops(
        lambda u, v: torch.nn.functional.conv2d(u, v, stride=2, padding=1), img, k)


def test_float32_output_products_count():
    """The card's float32-output bf16 products (``torch.mm``/``torch.bmm``
    with ``out_dtype``, ``nn.layers.vdot``/``bmm_f32``), on meta tensors
    since the CPU has no such kernel: 2 * M * K * N each."""
    a = torch.empty((3, 4, 5), device="meta", dtype=torch.bfloat16)
    b = torch.empty((3, 5, 6), device="meta", dtype=torch.bfloat16)
    assert benchutil.flops(torch.bmm, a, b, out_dtype=torch.float32) == 3 * 2 * 4 * 5 * 6
    assert benchutil.flops(torch.bmm, a, b) == 3 * 2 * 4 * 5 * 6
    assert benchutil.flops(torch.mm, a[0], b[0], out_dtype=torch.float32) == 2 * 4 * 5 * 6


def test_mfu_and_peaks(monkeypatch):
    assert benchutil.peak_bf16_flops("cpu") is None
    assert benchutil.mfu(1e9, 1.0, torch.device("cpu")) is None
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: next(names))
    assert benchutil.mfu(989e12, 1.0, "cuda:0") == pytest.approx(1.0)
    assert benchutil.mfu(989e12, 1.0, "cuda:0") is None      # not in the table
    assert benchutil.mfu(None, 1.0, "cpu") is None
    assert benchutil.card_peaks("cpu") is None
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchutil.time_chained(lambda: None, (), "cpu")


def test_emit_row_tags_the_metric(capsys):
    benchutil.emit_row({"metric": "captions/s", "value": 1.0}, tag="remat")
    benchutil.emit_row({"metric": "captions/s", "value": 2.0})
    lines = capsys.readouterr().out.splitlines()
    assert '"captions/s [remat]"' in lines[0] and '"captions/s"' in lines[1]


def test_gather_bytes_of_a_beam_reorder():
    """A beam's reorder of a GRU state and a cache: one row gather of every
    tensor, (B*K) rows of each, plus an index_select and an embedding."""
    rows, hidden, length = 6, 8, 5
    state = {"h": torch.zeros((rows, hidden)),
             "cache": (torch.zeros((rows, length, hidden), dtype=torch.bfloat16),
                       torch.zeros((rows, length), dtype=torch.int32))}
    idx = torch.tensor([0, 0, 2, 3, 3, 5])
    table = torch.zeros((11, 4))

    def step():
        gather_rows(state, idx)
        state["h"].index_select(0, idx)
        torch.nn.functional.embedding(idx, table)
        state["h"].sum()            # not a gather

    want = (rows * hidden * 4 + rows * length * hidden * 2 + rows * length * 4
            + rows * hidden * 4 + rows * 4 * 4)
    assert benchutil.gather_bytes(step) == want
    assert benchutil.gather_bytes(lambda: torch.gather(
        state["h"], 1, torch.zeros((rows, 2), dtype=torch.int64))) == rows * 2 * 4


def test_chunked_to_equals_one_copy():
    arr = np.random.default_rng(3).standard_normal((17, 5)).astype(np.float32)
    # a row is 20 bytes; 50e-6 MB is 2 rows a copy: 9 uneven slices
    for limit in (50e-6, 0, None, 10):
        out = benchutil.chunked_to(arr, "cpu", limit_mb=limit)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), arr)
    assert float(benchutil.chunked_to(torch.tensor(4.0), "cpu", 1e-9)) == 4.0


def test_bounds():
    peaks = benchutil.CARD_PEAKS["NVIDIA H100 80GB HBM3"]
    ms, by = benchutil.gru_bound_ms(30, 2048, 512, peaks)
    assert by == "operations" and ms == pytest.approx(
        (2 * 30 * 2048 * 512 * 1536 / 989e12 + 14 * 30 * 2048 * 512 / 67e12) * 1e3)
    assert benchutil.lstm_bound_ms(30, 8, 512, peaks)[1] == "bytes"
    assert benchutil.backbone_bound_ms(989e9, 0, 0, peaks) == (1.0, "operations")
    assert benchutil.conv_bound_ms(30, 1024, 512, 13, peaks)[0] > 0
