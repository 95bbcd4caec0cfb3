"""The batch-major (B3) and manually pipelined (B4) GRU sequences of the port
(their plain versions, on CPU tensors) against the JAX package's Pallas
kernels run in interpret mode, and the wrappers' refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.nn import rnn as jrnn
from vcr_tpu.ops.pallas_gru import gru_sequence_pallas_bt, gru_sequence_pallas_dma
from vcr_tpu_torch import bridge
from vcr_tpu_torch.ops import cuda_gru

T, I, H = 5, 12, 128

VARIANTS = {
    # name: (JAX drop-in, port drop-in, batch-major)
    "bt": (gru_sequence_pallas_bt, cuda_gru.gru_sequence_fused_bt, True),
    "dma": (gru_sequence_pallas_dma, cuda_gru.gru_sequence_fused_dma, False),
}


def _counts():
    return cuda_gru.launches, cuda_gru.launches_bt, cuda_gru.launches_dma


def _run_both(rng, variant, b, jd, td, with_h0):
    jax_fn, port_fn, batch_major = VARIANTS[variant]
    jparams = jrnn.gru_init(jax.random.PRNGKey(b), I, H)
    tparams = bridge.from_jax_params(jparams, "cpu")
    xs = rng.standard_normal((b, T, I) if batch_major else (T, b, I)).astype(np.float32)
    h0 = rng.standard_normal((b, H)).astype(np.float32) if with_h0 else None
    want_outs, want_h = jax_fn(jparams, jnp.asarray(xs),
                               None if h0 is None else jnp.asarray(h0),
                               compute_dtype=jd, interpret=True)
    before = _counts()
    outs, h_last = port_fn(tparams, torch.from_numpy(xs),
                           None if h0 is None else torch.from_numpy(h0),
                           compute_dtype=td)
    assert _counts() == before  # CPU tensors never reach a kernel
    assert outs.dtype == torch.float32
    assert outs.shape == ((b, T, H) if batch_major else (T, b, H))
    return outs.numpy(), h_last.numpy(), np.asarray(want_outs), np.asarray(want_h)


def _batches(variant):
    return [1, 3, 8] if variant == "bt" else [1, 3, 16]


CASES = [(v, b, with_h0) for v in VARIANTS for b in _batches(v)
         for with_h0 in (False, True)]


@pytest.mark.parametrize("variant, b, with_h0", CASES)
def test_variant_matches_pallas_f32(rng, variant, b, with_h0):
    outs, h_last, want_outs, want_h = _run_both(rng, variant, b, jnp.float32,
                                                torch.float32, with_h0)
    np.testing.assert_allclose(outs, want_outs, atol=1e-5)
    np.testing.assert_allclose(h_last, want_h, atol=1e-5)


@pytest.mark.parametrize("variant, b, with_h0", CASES)
def test_variant_matches_pallas_bf16(rng, variant, b, with_h0):
    # the envelope of B1's bf16 test: x_gates and h rounded to bf16 on both
    # sides, float32 products summed in other orders
    outs, h_last, want_outs, want_h = _run_both(rng, variant, b, jnp.bfloat16,
                                                torch.bfloat16, with_h0)
    np.testing.assert_allclose(outs, want_outs, atol=2e-2)
    np.testing.assert_allclose(h_last, want_h, atol=2e-2)
    assert np.abs(outs - want_outs).mean() < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sequences_agree_exactly(rng, dtype):
    """B1's, B3's and B4's plain versions are one function."""
    b = 3
    x_gates = torch.from_numpy(rng.standard_normal((T, b, 3 * H)).astype(np.float32))
    x_gates = x_gates.to(dtype)
    w_hh = torch.from_numpy(rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.05)
    w_hh = w_hh.to(dtype)
    b_hh = torch.from_numpy(rng.standard_normal(3 * H).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, H)).astype(np.float32))
    before = _counts()
    tm = cuda_gru.gru_recurrence(x_gates, w_hh, b_hh, h0, dtype)
    bt = cuda_gru.gru_recurrence_bt(x_gates.transpose(0, 1).contiguous(), w_hh, b_hh,
                                    h0, dtype)
    dma = cuda_gru.gru_recurrence_dma(x_gates, w_hh, b_hh, h0, dtype)
    assert _counts() == before
    assert torch.equal(bt.transpose(0, 1), tm)
    assert torch.equal(dma, tm)


def _args(t=T, b=2, hidden=H, batch_major=False):
    shape = (b, t, 3 * hidden) if batch_major else (t, b, 3 * hidden)
    return (torch.zeros(shape), torch.zeros((hidden, 3 * hidden)),
            torch.zeros((3 * hidden,)), torch.zeros((b, hidden)))


@pytest.mark.parametrize("wrapper, batch_major", [
    (cuda_gru.gru_recurrence_bt_cuda, True),
    (cuda_gru.gru_recurrence_dma_cuda, False),
])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, batch_major):
    """No silent fallback: a CPU tensor handed to a CUDA wrapper raises."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*_args(batch_major=batch_major), torch.float32)
    dispatch = (cuda_gru.gru_recurrence_bt if batch_major
                else cuda_gru.gru_recurrence_dma)
    with pytest.raises(ValueError, match="no GRU recurrence"):
        dispatch(*(a.to("meta") for a in _args(batch_major=batch_major)), torch.float32)


def test_dma_wrapper_refuses_hidden_not_multiple_of_8():
    # bulk copies move 16-byte rows: a bf16 row of x_gates is 6H bytes
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gru.gru_recurrence_dma_cuda(*_args(hidden=12), torch.float32)


@pytest.mark.parametrize("wrapper, batch_major", [
    (cuda_gru.gru_recurrence_bt_cuda, True),
    (cuda_gru.gru_recurrence_dma_cuda, False),
])
def test_kernel_wrappers_refuse_grad(wrapper, batch_major):
    args = list(_args(batch_major=batch_major))
    args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient either"):
        wrapper(*args, torch.float32)
