"""Launch geometry and body choice of kernel B2 (ops.cuda_lstm), on the CPU:
the tensor-core body's plan is pure Python, so the split of a batch over
thread-block clusters is checked here without a card."""

import pytest
import torch

from vcr_tpu_torch.ops import cuda_gru, cuda_lstm

BATCHES = (1, 3, 17, 256, 1024)
MAX_CLUSTERS = (1, 7, 8, 14)


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", BATCHES)
def test_tc_plan_puts_every_row_in_one_cluster(batch, max_clusters):
    cluster, clusters, rows, chunk = cuda_lstm.tc_plan(batch, 512, torch.bfloat16,
                                                       max_clusters)
    assert cluster == cuda_lstm.TC_CLUSTER == 16 and chunk == cuda_lstm.TC_CHUNK == 16
    assert rows % chunk == 0 and rows >= chunk
    # the grid never exceeds what the card holds at once
    assert 1 <= clusters <= max_clusters
    # cluster k owns rows [k * rows, (k + 1) * rows): each batch row falls in
    # exactly one, and no cluster is left without a row
    owners = [b // rows for b in range(batch)]
    assert set(owners) == set(range(clusters))
    assert clusters * rows >= batch > (clusters - 1) * rows
    # one split for both recurrences: B1's plan cuts the batch the same way
    assert cuda_gru.tc_plan(batch, 512, torch.bfloat16, max_clusters)[1:3] == (
        clusters, rows)


def test_tc_plan_at_the_serving_batch():
    # RationaleNet's B=1024 on 7 clusters (one CTA per SM): 160 rows, 10
    # chunks of 16 per cluster
    assert cuda_lstm.tc_plan(1024, 512, torch.bfloat16, 7) == (16, 7, 160, 16)


@pytest.mark.parametrize("dtype, hidden, takes", [
    (torch.bfloat16, 128, True),    # the card tests' width
    (torch.bfloat16, 256, True),
    (torch.bfloat16, 384, True),
    (torch.bfloat16, 512, True),    # RationaleNet's generator
    (torch.bfloat16, 640, True),    # the largest W_hh slice that fits: 200 KB
    (torch.bfloat16, 768, False),   # slice of 288 KB > 227 KB
    (torch.bfloat16, 520, False),   # H % 128 != 0
    (torch.bfloat16, 64, False),
    (torch.float32, 128, False),    # float32 keeps the scalar body
    (torch.float32, 512, False),
])
def test_body_is_chosen_by_dtype_and_shape(dtype, hidden, takes):
    assert cuda_lstm.tc_takes(hidden, dtype) is takes
    plan = cuda_lstm.tc_plan(64, hidden, dtype, 7)
    assert (plan is not None) is takes
    assert (cuda_lstm.tc_smem_bytes(hidden) <= cuda_lstm.TC_SMEM_LIMIT) is (
        hidden <= 640)


@pytest.mark.parametrize("hidden", [128, 512, 640])
def test_tc_smem_is_the_w_hh_slice(hidden):
    # H x (4H / 16) bf16 values: H*H/2 bytes, 128 KB at H=512
    assert cuda_lstm.tc_smem_bytes(hidden) == hidden * (4 * hidden // 16) * 2
    assert cuda_lstm.tc_smem_bytes(hidden) == hidden * hidden // 2
    assert cuda_lstm.tc_smem_bytes(512) == 131072


def test_tc_plan_refuses_a_card_without_room_for_a_cluster():
    with pytest.raises(ValueError, match="no cluster of 16 CTAs of the tensor-core LSTM"):
        cuda_lstm.tc_plan(1024, 512, torch.bfloat16, 0)
    # where the body does not apply there is nothing to refuse
    assert cuda_lstm.tc_plan(1024, 512, torch.float32, 0) is None


def _args(hidden=512, b=3, t=4, dtype=torch.bfloat16):
    return [torch.zeros((t, b, 4 * hidden), dtype=dtype),
            torch.zeros((hidden, 4 * hidden), dtype=dtype),
            torch.zeros((4 * hidden,)), torch.zeros((b, hidden)), torch.zeros((b, hidden))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("fault, error, message", [
    ("hidden", ValueError, "multiple of 4"),
    ("dtype", ValueError, "unsupported compute dtype"),
    ("x_gates_rank", ValueError, r"x_gates must be \(T, B, 4H\)"),
    ("w_hh_dtype", ValueError, "w_hh must be a contiguous"),
    ("b_hh_shape", ValueError, "b_hh must be a contiguous"),
    ("c0_shape", ValueError, "c0 must be a contiguous"),
    ("h0_strided", ValueError, "h0 must be a contiguous"),
    # the id keeps this case's name from when the message named ROADMAP A5;
    # it now names the differentiable entry, lstm_sequence_fused
    pytest.param("grad", NotImplementedError, "forward only; lstm_sequence_fused",
                 id="grad-NotImplementedError-ROADMAP A5"),
    ("unaligned", ValueError, "4-byte boundary"),
    ("none", ValueError, "CUDA tensors"),
])
def test_b2_refuses_what_neither_body_takes_before_the_device(fault, error, message,
                                                              reverse):
    """Shapes, dtypes, gradients and a misaligned bf16 x_gates are refused on
    any device, before the CUDA-tensor check; a valid input on the CPU
    reaches that check. Nothing is counted as launched."""
    args = _args(hidden=6 if fault == "hidden" else 512)
    dtype = torch.bfloat16
    if fault == "dtype":
        dtype = torch.float16
    elif fault == "x_gates_rank":
        args[0] = args[0][0]
    elif fault == "w_hh_dtype":
        args[1] = args[1].float()
    elif fault == "b_hh_shape":
        args[2] = torch.zeros((512,))
    elif fault == "c0_shape":
        args[4] = torch.zeros((2, 512))
    elif fault == "h0_strided":
        args[3] = torch.zeros((512, 3)).t()
    elif fault == "grad":
        args[1].requires_grad_(True)
    elif fault == "unaligned":
        # a contiguous view two bytes into its storage: one bf16 off a pair
        flat = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16)
        args[0] = flat[1:].view(args[0].shape)
        assert args[0].data_ptr() % 4 == 2
    launches = (cuda_lstm.launches, cuda_lstm.launches_tc)
    with pytest.raises(error, match=message):
        cuda_lstm.lstm_recurrence_cuda(*args, dtype, reverse)
    assert (cuda_lstm.launches, cuda_lstm.launches_tc) == launches


def test_unaligned_x_gates_is_refused_only_where_the_tensor_core_body_runs():
    """The scalar body reads x_gates one element at a time: float32 and
    untaken bf16 widths go on to the device check."""
    for dtype, hidden in ((torch.float32, 512), (torch.bfloat16, 520)):
        args = _args(hidden=hidden, dtype=dtype)
        flat = torch.zeros(args[0].numel() + 1, dtype=dtype)
        args[0] = flat[1:].view(args[0].shape)
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_lstm.lstm_recurrence_cuda(*args, dtype)
