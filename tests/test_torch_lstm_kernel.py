"""The fused LSTM sequence of the port (its plain version, on CPU tensors)
against the JAX package's Pallas kernel run in interpret mode, and the port's
plain LSTM cells against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.nn import rnn as jrnn
from vcr_tpu.ops.pallas_gru import bilstm_sequence_pallas, lstm_sequence_pallas
from vcr_tpu_torch import bridge
from vcr_tpu_torch.nn import rnn as trnn
from vcr_tpu_torch.ops import cuda_lstm

T, I, H = 6, 16, 128


def _hc0(rng, b):
    return tuple(rng.standard_normal((b, H)).astype(np.float32) for _ in range(2))


def _run_both(rng, b, jd, td, reverse, with_hc0):
    jparams = jrnn.lstm_init(jax.random.PRNGKey(b), I, H)
    tparams = bridge.from_jax_params(jparams, "cpu")
    xs = rng.standard_normal((T, b, I)).astype(np.float32)
    hc0 = _hc0(rng, b) if with_hc0 else None
    want_outs, (want_h, want_c) = lstm_sequence_pallas(
        jparams, jnp.asarray(xs),
        None if hc0 is None else tuple(map(jnp.asarray, hc0)),
        reverse=reverse, compute_dtype=jd, interpret=True)
    launches = cuda_lstm.launches
    outs, (h_last, c_last) = cuda_lstm.lstm_sequence_fused(
        tparams, torch.from_numpy(xs),
        None if hc0 is None else tuple(map(torch.from_numpy, hc0)),
        reverse=reverse, compute_dtype=td)
    assert cuda_lstm.launches == launches  # CPU tensors never reach the kernel
    assert outs.dtype == torch.float32 and outs.shape == (T, b, H)
    got = (outs.numpy(), h_last.numpy(), c_last.numpy())
    want = (np.asarray(want_outs), np.asarray(want_h), np.asarray(want_c))
    return got, want


@pytest.mark.parametrize("with_hc0", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_fused_lstm_matches_pallas_f32(rng, b, reverse, with_hc0):
    got, want = _run_both(rng, b, jnp.float32, torch.float32, reverse, with_hc0)
    for g, w in zip(got, want):  # outs, h_last, c_last
        np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstm_matches_pallas_bf16(rng, reverse):
    # Both round x_gates and h to bf16; float32 products summed in another
    # order can put a value on the other side of a bf16 rounding step (one
    # bf16 ulp is 2^-8 relative), which later steps carry on. The envelope
    # allows a few such flips over T steps of |h| < 1 (c is unbounded but
    # stays O(1) here).
    got, want = _run_both(rng, 8, jnp.bfloat16, torch.bfloat16, reverse, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-2)
        assert np.abs(g - w).mean() < 1e-4


def test_fused_bilstm_matches_pallas(rng):
    b = 3
    jparams = jrnn.bilstm_init(jax.random.PRNGKey(5), I, H)
    tparams = bridge.from_jax_params(jparams, "cpu")
    xs = rng.standard_normal((T, b, I)).astype(np.float32)
    want = bilstm_sequence_pallas(jparams, jnp.asarray(xs), compute_dtype=jnp.float32,
                                  interpret=True)
    got = cuda_lstm.bilstm_sequence_fused(tparams, torch.from_numpy(xs),
                                          compute_dtype=torch.float32)
    assert got.shape == (T, b, 2 * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_lstm_sequence_matches_jax(rng, reverse):
    b, hidden = 4, 16
    jparams = jrnn.lstm_init(jax.random.PRNGKey(3), I, hidden)
    tparams = bridge.from_jax_params(jparams, "cpu")
    xs = rng.standard_normal((T, b, I)).astype(np.float32)
    hc0 = tuple(rng.standard_normal((b, hidden)).astype(np.float32) for _ in range(2))
    want_outs, (want_h, want_c) = jrnn.lstm_sequence(
        jparams, jnp.asarray(xs), tuple(map(jnp.asarray, hc0)), reverse=reverse,
        compute_dtype=jnp.float32)
    outs, (h_last, c_last) = trnn.lstm_sequence(
        tparams, torch.from_numpy(xs), tuple(map(torch.from_numpy, hc0)),
        reverse=reverse, compute_dtype=torch.float32)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(c_last.numpy(), np.asarray(want_c), atol=1e-5)


def test_plain_bilstm_sequence_matches_jax(rng):
    jparams = jrnn.bilstm_init(jax.random.PRNGKey(4), I, 16)
    tparams = bridge.from_jax_params(jparams, "cpu")
    xs = rng.standard_normal((T, 2, I)).astype(np.float32)
    want = jrnn.bilstm_sequence(jparams, jnp.asarray(xs), compute_dtype=jnp.float32)
    got = trnn.bilstm_sequence(tparams, torch.from_numpy(xs), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_recurrence_is_the_kernel_function(rng):
    """lstm_recurrence on CPU tensors is the plain version, step by step,
    walking backwards when reversed."""
    b = 3
    x_gates = torch.from_numpy(rng.standard_normal((T, b, 4 * H)).astype(np.float32))
    w_hh = torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32) * 0.05)
    b_hh = torch.from_numpy(rng.standard_normal(4 * H).astype(np.float32))
    h0, c0 = map(torch.from_numpy, _hc0(rng, b))
    outs, c_last = cuda_lstm.lstm_recurrence(x_gates, w_hh, b_hh, h0, c0,
                                             torch.float32, reverse=True)
    h, c = h0, c0
    for t in reversed(range(T)):
        hg = h @ w_hh + b_hh
        gates = [x_gates[t, :, k * H:(k + 1) * H] + hg[:, k * H:(k + 1) * H]
                 for k in range(4)]
        c = torch.sigmoid(gates[1]) * c + torch.sigmoid(gates[0]) * torch.tanh(gates[2])
        h = torch.sigmoid(gates[3]) * torch.tanh(c)
        np.testing.assert_allclose(outs[t].numpy(), h.numpy(), atol=1e-5)
    np.testing.assert_allclose(c_last.numpy(), c.numpy(), atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises on what it cannot launch: no silent fallback."""
    args = (torch.zeros((T, 2, 4 * H)), torch.zeros((H, 4 * H)),
            torch.zeros((4 * H,)), torch.zeros((2, H)), torch.zeros((2, H)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_recurrence_cuda(*args, torch.float32)
    with pytest.raises(ValueError, match="no LSTM recurrence"):
        cuda_lstm.lstm_recurrence(*(a.to("meta") for a in args), torch.float32)
