"""Gradients of the port's differentiable kernel sequences (B1's
``gru_sequence_fused``, B2's ``lstm_sequence_fused``) against ``jax.grad``
through the JAX package's Pallas drop-ins in interpret mode, on the CPU.

Both backwards recompute the plain recurrence on float32 ``x_gates``, so in
float32 they agree to the order of float32 sums. In bf16 the operands of
every product are rounded to bf16 on both sides, and a float32 sum that
lands on the other side of a bf16 rounding step moves one product input by
2^-8 relative: the bound below allows a few such flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.models import s2vt as js2vt
from vcr_tpu.nn import rnn as jrnn
from vcr_tpu.ops.pallas_gru import gru_sequence_pallas, lstm_sequence_pallas
from vcr_tpu_torch import bridge
from vcr_tpu_torch.models import s2vt as ts2vt
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm

T, B, I = 5, 8, 12
F32_TOL = 1e-5
# bf16 at H=128, relative to max(1, max|g|) of the leaf (gradients up to
# ~15): the largest differences read were 1.1e-4 (GRU) and 4.7e-4 (LSTM), in
# w_hh, whose gradient is rounded to bf16 (one bf16 step at |g| ~ 4 is
# 2e-3); float32 read <= 1.9e-6
BF16_REL_TOL = 1e-3

CASES = [pytest.param(32, jnp.float32, torch.float32, id="f32"),
         pytest.param(128, jnp.bfloat16, torch.bfloat16, id="bf16")]


def _close(got, want, jd):
    want = np.asarray(want)
    if jd == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= BF16_REL_TOL * scale


def _inputs(rng, hidden, gates, with_c=False):
    xs = rng.standard_normal((T, B, I)).astype(np.float32)
    state = [rng.standard_normal((B, hidden)).astype(np.float32)
             for _ in range(2 if with_c else 1)]
    cot = rng.standard_normal((T, B, hidden)).astype(np.float32)
    cot_last = [rng.standard_normal((B, hidden)).astype(np.float32)
                for _ in range(2 if with_c else 1)]
    return xs, state, cot, cot_last


def _torch_leaves(params):
    return {k: v.clone().requires_grad_(True) for k, v in params.items()}


@pytest.mark.parametrize("hidden, jd, td", CASES)
def test_gru_sequence_gradients_match_jax(rng, hidden, jd, td):
    """All of w_ih, b_ih, w_hh, b_hh, xs and h0, through the outputs and
    the last state."""
    jparams = jrnn.gru_init(jax.random.PRNGKey(1), I, hidden)
    xs, (h0,), cot, (cot_h,) = _inputs(rng, hidden, 3)

    def jloss(p, x, h):
        outs, last = gru_sequence_pallas(p, x, h, compute_dtype=jd, interpret=True)
        return jnp.sum(outs * cot) + jnp.sum(last * cot_h)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jparams, jnp.asarray(xs),
                                                       jnp.asarray(h0))
    tparams = _torch_leaves(bridge.from_jax_params(jparams, "cpu"))
    txs = torch.from_numpy(xs).requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    launches = cuda_gru.launches
    outs, last = cuda_gru.gru_sequence_fused(tparams, txs, th0, compute_dtype=td)
    loss = (outs * torch.from_numpy(cot)).sum() + (last * torch.from_numpy(cot_h)).sum()
    names = ["w_ih", "b_ih", "w_hh", "b_hh"]
    got = torch.autograd.grad(loss, [tparams[k] for k in names] + [txs, th0])
    assert cuda_gru.launches == launches  # CPU tensors never reach the kernel
    for k, g in zip(names, got):
        _close(g.numpy(), want[0][k], jd)
    _close(got[4].numpy(), want[1], jd)
    _close(got[5].numpy(), want[2], jd)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden, jd, td", CASES)
def test_lstm_sequence_gradients_match_jax(rng, hidden, jd, td, reverse):
    """All of w_ih, b_ih, w_hh, b_hh, xs, h0 and c0, through the outputs,
    h_last and c_last, in both directions."""
    jparams = jrnn.lstm_init(jax.random.PRNGKey(2), I, hidden)
    xs, (h0, c0), cot, (cot_h, cot_c) = _inputs(rng, hidden, 4, with_c=True)

    def jloss(p, x, hc):
        outs, (h_last, c_last) = lstm_sequence_pallas(p, x, hc, reverse=reverse,
                                                      compute_dtype=jd, interpret=True)
        return jnp.sum(outs * cot) + jnp.sum(h_last * cot_h) + jnp.sum(c_last * cot_c)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jparams, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    tparams = _torch_leaves(bridge.from_jax_params(jparams, "cpu"))
    txs, th0, tc0 = (torch.from_numpy(a).requires_grad_(True) for a in (xs, h0, c0))
    outs, (h_last, c_last) = cuda_lstm.lstm_sequence_fused(tparams, txs, (th0, tc0),
                                                           reverse, compute_dtype=td)
    loss = ((outs * torch.from_numpy(cot)).sum() + (h_last * torch.from_numpy(cot_h)).sum()
            + (c_last * torch.from_numpy(cot_c)).sum())
    names = ["w_ih", "b_ih", "w_hh", "b_hh"]
    got = torch.autograd.grad(loss, [tparams[k] for k in names] + [txs, th0, tc0])
    for k, g in zip(names, got):
        _close(g.numpy(), want[0][k], jd)
    for g, w in zip(got[4:], (want[1],) + tuple(want[2])):
        _close(g.numpy(), w, jd)


def test_lstm_gradient_without_c_last(rng):
    """c_last unused: its incoming gradient is None, and the rest is the
    plain recurrence's gradient."""
    jparams = jrnn.lstm_init(jax.random.PRNGKey(3), I, 32)
    xs, _, cot, _ = _inputs(rng, 32, 4)
    tparams = _torch_leaves(bridge.from_jax_params(jparams, "cpu"))
    outs, _ = cuda_lstm.lstm_sequence_fused(tparams, torch.from_numpy(xs),
                                            compute_dtype=torch.float32)
    got = torch.autograd.grad((outs * torch.from_numpy(cot)).sum(), tparams["w_hh"])[0]

    def jloss(p):
        return jnp.sum(jrnn.lstm_sequence(p, jnp.asarray(xs),
                                          compute_dtype=jnp.float32)[0] * cot)

    _close(got.numpy(), jax.jit(jax.grad(jloss))(jparams)["w_hh"], jnp.float32)


def test_prime_slice_gradient_reaches_the_full_w_ih(rng):
    """The prime runs GRU2 on w_ih[:H], a view: its gradient lands in the
    first H rows of rnn2.w_ih, as JAX's, and the rows past H get zero."""
    import __graft_entry__ as graft
    from vcr_tpu_torch import entry

    dims = dict(vocab_size=21, embed_size=16, hidden=32, vid_feat=12, max_len=6,
                num_frames=5)
    jspec, jparams = graft._make_spec_and_params(**dims, compute_dtype="float32",
                                                 vocab_pad_to=8, use_pallas=True)
    tspec, _ = entry.make_spec_and_params(**dims, compute_dtype="float32",
                                          vocab_pad_to=8, device="cpu")
    enc = rng.standard_normal((5, B, 32)).astype(np.float32)
    cot = rng.standard_normal((B, 32)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        js2vt._prime_state2(p, jspec, jnp.asarray(enc)) * cot)))(jparams)["rnn2"]["w_ih"]
    rnn2 = _torch_leaves(bridge.from_jax_params(jparams["rnn2"], "cpu"))
    state2 = ts2vt._prime_state2({"rnn2": rnn2}, tspec, torch.from_numpy(enc))
    got = torch.autograd.grad((state2 * torch.from_numpy(cot)).sum(), rnn2["w_ih"])[0]
    assert got.shape == (32 + 16, 96)
    assert torch.count_nonzero(got[32:]) == 0 and torch.count_nonzero(got[:32]) > 0
    _close(got.numpy(), want, jnp.float32)


def _gru_args(hidden=512, b=3, t=4):
    return [torch.zeros((t, b, 3 * hidden), dtype=torch.bfloat16),
            torch.zeros((hidden, 3 * hidden), dtype=torch.bfloat16),
            torch.zeros((3 * hidden,)), torch.zeros((b, hidden))]


@pytest.mark.parametrize("launcher", ["gru_recurrence_cuda", "gru_recurrence_bt_cuda",
                                      "gru_recurrence_dma_cuda", "lstm_recurrence_cuda"])
def test_raw_launchers_still_refuse_grad_inputs(launcher):
    """Only the sequence Functions differentiate; a raw launcher given a
    tensor that requires grad raises, before the device check."""
    if launcher == "lstm_recurrence_cuda":
        args = _gru_args()
        args[0] = torch.zeros((4, 3, 4 * 512), dtype=torch.bfloat16)
        args[1] = torch.zeros((512, 4 * 512), dtype=torch.bfloat16)
        args[2] = torch.zeros((4 * 512,))
        args.append(torch.zeros((3, 512)))
        module = cuda_lstm
    else:
        args = _gru_args()
        if launcher == "gru_recurrence_bt_cuda":
            args[0] = args[0].transpose(0, 1).contiguous()
        module = cuda_gru
    args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        getattr(module, launcher)(*args, torch.bfloat16)
    with torch.no_grad():  # without grad mode the same input reaches the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(module, launcher)(*args, torch.bfloat16)
