"""Launch geometry and body choice of kernel B4 (ops.cuda_gru), on the CPU:
its tensor-core body's plan is pure Python, so the split of a batch over
thread-block clusters and the shared-memory budget of its copy rings are
checked here without a card, and so are the wrapper's refusals."""

import pytest
import torch

from vcr_tpu_torch.ops import cuda_gru

BATCHES = (1, 3, 17, 256, 1024, 2048)
MAX_CLUSTERS = (7, 8)
BF16 = torch.bfloat16


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", BATCHES)
def test_dma_tc_plan_puts_every_row_in_one_cluster(batch, max_clusters):
    cluster, clusters, rows, chunk, warps, slots = cuda_gru.dma_tc_plan(
        batch, 512, BF16, max_clusters)
    assert cluster == cuda_gru.TC_CLUSTER == 16 and chunk == cuda_gru.TC_CHUNK == 16
    assert (warps, slots) == (cuda_gru.DMA_TC_WARPS, cuda_gru.DMA_TC_SLOTS)
    assert rows % chunk == 0 and rows >= chunk
    assert 1 <= clusters <= max_clusters
    # cluster k owns rows [k * rows, (k + 1) * rows): each batch row falls in
    # exactly one, and no cluster is left without a row
    owners = [b // rows for b in range(batch)]
    assert set(owners) == set(range(clusters))
    assert clusters * rows >= batch > (clusters - 1) * rows
    # the same split of the batch as B1's tensor-core body
    assert (clusters, rows) == cuda_gru.tc_plan(batch, 512, BF16, max_clusters)[1:3]


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", BATCHES)
def test_dma_tc_plan_stays_within_a_ctas_shared_memory(batch, max_clusters):
    _, _, rows, chunk, warps, slots = cuda_gru.dma_tc_plan(batch, 512, BF16, max_clusters)
    assert cuda_gru.dma_tc_smem_bytes(512, rows // chunk, warps, slots) <= 232448


@pytest.mark.parametrize("max_clusters", MAX_CLUSTERS)
@pytest.mark.parametrize("batch", [1024, 2048])
def test_dma_tc_plan_fills_the_card_at_serving_batches(batch, max_clusters):
    _, clusters, _, _, _, _ = cuda_gru.dma_tc_plan(batch, 512, BF16, max_clusters)
    assert clusters == max_clusters


def test_dma_tc_smem_budget_at_the_timing_batch():
    # B=2048 on 7 clusters: 304 rows, 19 chunks a CTA. W_hh slice + one
    # float32 tile per chunk + 10 warps x 2 slots of x_gates, an mbarrier each
    assert cuda_gru.dma_tc_plan(2048, 512, BF16, 7)[2] == 304
    assert cuda_gru.dma_tc_smem_bytes(512, 19) == (
        98304 + 19 * 16 * 32 * 4 + 10 * 2 * (16 * 3 * 32 * 2 + 8)) == 198816


def test_dma_tc_plan_refuses_a_batch_past_the_budget():
    # 35 chunks a CTA fit at H=512, 36 do not: 7 clusters take 7 x 560 rows
    assert (cuda_gru.dma_tc_smem_bytes(512, 35) <= cuda_gru.TC_SMEM_LIMIT
            < cuda_gru.dma_tc_smem_bytes(512, 36))
    assert cuda_gru.dma_tc_plan(3920, 512, BF16, 7)[2] == 560
    assert cuda_gru.dma_tc_plan(3921, 512, BF16, 7) is None
    assert cuda_gru.dma_tc_plan(8192, 512, BF16, 8) is None


@pytest.mark.parametrize("dtype, hidden, takes", [
    (BF16, 128, True),     # the card tests' width
    (BF16, 256, True),
    (BF16, 384, True),
    (BF16, 512, True),     # the flagship encoder's width
    (BF16, 640, False),    # slice 150 KB + rings 75 KB + one tile: 512 B too many
    (BF16, 768, False),    # slice 216 KB leaves less than one warp's ring
    (BF16, 896, False),
    (BF16, 64, False),     # H % 128 != 0
    (BF16, 500, False),
    (torch.float32, 128, False),  # float32 keeps the scalar body
    (torch.float32, 512, False),
])
def test_dma_body_is_chosen_by_dtype_and_shape(dtype, hidden, takes):
    assert cuda_gru.dma_tc_takes(hidden, dtype) is takes
    plan = cuda_gru.dma_tc_plan(64, hidden, dtype, 8)
    assert (plan is not None) is takes
    assert (cuda_gru.dma_tc_smem_bytes(hidden, 1) <= cuda_gru.TC_SMEM_LIMIT) is (
        hidden <= 512)


def test_dma_tc_plan_refuses_a_card_without_room_for_a_cluster():
    with pytest.raises(ValueError, match="no cluster of 16"):
        cuda_gru.dma_tc_plan(2048, 512, BF16, 0)
    # where the body does not apply there is nothing to refuse
    assert cuda_gru.dma_tc_plan(2048, 512, torch.float32, 0) is None
    assert cuda_gru.dma_tc_plan(2048, 768, BF16, 0) is None


def _args(hidden=512, b=3, t=4, dtype=BF16):
    return [torch.zeros((t, b, 3 * hidden), dtype=dtype),
            torch.zeros((hidden, 3 * hidden), dtype=dtype),
            torch.zeros((3 * hidden,)), torch.zeros((b, hidden))]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("fault, error, message", [
    ("unaligned", ValueError, "16-byte boundary"),
    ("hidden", ValueError, "multiple of 8"),
    ("x_gates_dtype", ValueError, "x_gates must be a contiguous"),
    ("w_hh_dtype", ValueError, "w_hh must be a contiguous"),
    ("b_hh_dtype", ValueError, "b_hh must be a contiguous"),
    ("h0_shape", ValueError, "h0 must be a contiguous"),
    ("grad", NotImplementedError, "forward only"),
    ("none", ValueError, "CUDA tensors"),
])
def test_b4_refuses_what_neither_body_takes_before_the_device(dtype, fault, error,
                                                                message):
    """Alignment, shapes, dtypes and gradients are refused on any device,
    before the CUDA-tensor check; valid inputs on the CPU reach that check."""
    args = _args(hidden=12 if fault == "hidden" else 512, dtype=dtype)
    if fault == "unaligned":
        # a contiguous view one element past a 64-byte-aligned allocation
        flat = torch.zeros(args[0].numel() + 1, dtype=dtype)
        args[0] = flat[1:].view(args[0].shape)
        assert args[0].is_contiguous() and args[0].data_ptr() % 16
    elif fault == "x_gates_dtype":
        args[0] = args[0].to(torch.float16)
    elif fault == "w_hh_dtype":
        args[1] = args[1].to(torch.float16)
    elif fault == "b_hh_dtype":
        args[2] = args[2].double()
    elif fault == "h0_shape":
        args[3] = torch.zeros((2, 512))
    elif fault == "grad":
        args[3].requires_grad_(True)
    counts = (cuda_gru.launches_dma, cuda_gru.launches_dma_tc)
    with pytest.raises(error, match=message):
        cuda_gru.gru_recurrence_dma_cuda(*args, dtype)
    assert (cuda_gru.launches_dma, cuda_gru.launches_dma_tc) == counts
