"""Launch geometry and body choice of kernels B1 and B3 (ops.cuda_gru), on
the CPU: the tensor-core body's plan is pure Python, so the split of a batch
over thread-block clusters is checked here without a card."""

import pytest
import torch

from vcr_tpu_torch.ops import cuda_gru

BATCHES = (1, 3, 17, 256, 1024, 2048)
MAX_CLUSTERS = (7, 8)


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", BATCHES)
def test_tc_plan_puts_every_row_in_one_cluster(batch, max_clusters):
    cluster, clusters, rows, chunk = cuda_gru.tc_plan(batch, 512, torch.bfloat16,
                                                      max_clusters)
    assert cluster == cuda_gru.TC_CLUSTER == 16 and chunk == cuda_gru.TC_CHUNK == 16
    assert rows % chunk == 0 and rows >= chunk
    # the grid never exceeds what the card holds at once
    assert 1 <= clusters <= max_clusters
    assert clusters * cluster <= max_clusters * cluster
    # cluster k owns rows [k * rows, (k + 1) * rows): each batch row falls in
    # exactly one, and no cluster is left without a row
    owners = [b // rows for b in range(batch)]
    assert set(owners) == set(range(clusters))
    assert clusters * rows >= batch > (clusters - 1) * rows


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", [1024, 2048])
def test_tc_plan_fills_the_card_at_serving_batches(batch, max_clusters):
    _, clusters, _, _ = cuda_gru.tc_plan(batch, 512, torch.bfloat16, max_clusters)
    assert clusters == max_clusters


@pytest.mark.parametrize("dtype, hidden, takes", [
    (torch.bfloat16, 128, True),    # the card tests' width
    (torch.bfloat16, 256, True),
    (torch.bfloat16, 384, True),
    (torch.bfloat16, 512, True),    # flagship, RationaleNet's caption net
    (torch.bfloat16, 768, True),    # the largest W_hh slice that fits
    (torch.bfloat16, 896, False),   # slice of 294 KB > 227 KB
    (torch.bfloat16, 64, False),    # H % 128 != 0
    (torch.bfloat16, 192, False),
    (torch.bfloat16, 500, False),
    (torch.float32, 128, False),    # float32 keeps the scalar body
    (torch.float32, 512, False),
])
def test_body_is_chosen_by_dtype_and_shape(dtype, hidden, takes):
    assert cuda_gru.tc_takes(hidden, dtype) is takes
    plan = cuda_gru.tc_plan(64, hidden, dtype, 8)
    assert (plan is not None) is takes
    assert (cuda_gru.tc_smem_bytes(hidden) <= cuda_gru.TC_SMEM_LIMIT) is (
        hidden <= 768)


def test_tc_smem_is_the_w_hh_slice():
    # 512 x (3 * 512 / 16) bf16 values: 96 KB of a CTA's 227 KB
    assert cuda_gru.tc_smem_bytes(512) == 512 * 96 * 2 == 98304


def test_tc_plan_refuses_a_card_without_room_for_a_cluster():
    with pytest.raises(ValueError, match="no cluster of 16"):
        cuda_gru.tc_plan(2048, 512, torch.bfloat16, 0)
    # where the body does not apply there is nothing to refuse
    assert cuda_gru.tc_plan(2048, 512, torch.float32, 0) is None


def _args(batch_major, hidden=512, b=3, t=4, dtype=torch.bfloat16):
    shape = (b, t, 3 * hidden) if batch_major else (t, b, 3 * hidden)
    return [torch.zeros(shape, dtype=dtype), torch.zeros((hidden, 3 * hidden), dtype=dtype),
            torch.zeros((3 * hidden,)), torch.zeros((b, hidden))]


WRAPPERS = [(cuda_gru.gru_recurrence_cuda, False), (cuda_gru.gru_recurrence_bt_cuda, True)]


@pytest.mark.parametrize("wrapper, batch_major", WRAPPERS)
@pytest.mark.parametrize("fault, error, message", [
    ("hidden", ValueError, "multiple of 4"),
    ("w_hh_dtype", ValueError, "w_hh must be a contiguous"),
    ("h0_shape", ValueError, "h0 must be a contiguous"),
    ("grad", NotImplementedError, "forward only"),
    ("none", ValueError, "CUDA tensors"),
])
def test_b1_b3_refuse_what_neither_body_takes_before_the_device(
        wrapper, batch_major, fault, error, message):
    """Shapes and dtypes neither body takes are refused on any device, before
    the CUDA-tensor check; a valid shape on the CPU reaches that check."""
    args = _args(batch_major, hidden=6 if fault == "hidden" else 512)
    if fault == "w_hh_dtype":
        args[1] = args[1].float()
    elif fault == "h0_shape":
        args[3] = torch.zeros((2, 512))
    elif fault == "grad":
        args[1].requires_grad_(True)
    launches = (cuda_gru.launches, cuda_gru.launches_bt, cuda_gru.launches_tc)
    with pytest.raises(error, match=message):
        wrapper(*args, torch.bfloat16)
    assert (cuda_gru.launches, cuda_gru.launches_bt, cuda_gru.launches_tc) == launches
