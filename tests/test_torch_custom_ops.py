"""Kernels B1-B4 as ``torch.library`` custom ops (``vcr_tpu_torch/ops/
library.py``), on the CPU: each op's CPU implementation is its kernel's
plain version bit for bit, its fake implementation gives the output shapes
and dtypes without data, ``torch.library.opcheck`` passes, every path
reaches the kernels through the dispatcher, the differentiable sequences
keep their gradients (against ``jax.grad`` of the JAX package's plain
recurrences), and a backward through the forward-only ops raises. Also the
device-neutral product ops an exported program holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from vcr_tpu.nn import rnn as jrnn
from vcr_tpu_torch import bridge, entry, serving
from vcr_tpu_torch.nn import layers
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm, library

T, B, H, I = 5, 3, 8, 12
GRAD_TOL = 1e-5      # float32 gradients, sums in other orders


def _gru_args(seed, dtype, batch_major=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, 3 * H) if batch_major else (T, B, 3 * H), generator=g)
    w = torch.randn((H, 3 * H), generator=g) * 0.2
    return (x.to(dtype), w.to(dtype), torch.randn((3 * H,), generator=g),
            torch.randn((B, H), generator=g), dtype)


def _lstm_args(seed, dtype, reverse):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, B, 4 * H), generator=g)
    w = torch.randn((H, 4 * H), generator=g) * 0.2
    return (x.to(dtype), w.to(dtype), torch.randn((4 * H,), generator=g),
            torch.randn((B, H), generator=g), torch.randn((B, H), generator=g), dtype,
            reverse)


OPS = [
    pytest.param(library.gru_recurrence, cuda_gru.gru_recurrence_plain, False, id="B1"),
    pytest.param(library.gru_recurrence_bt, cuda_gru.gru_recurrence_bt_plain, True,
                 id="B3"),
    pytest.param(library.gru_recurrence_dma, cuda_gru.gru_recurrence_plain, False,
                 id="B4"),
]
DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op, plain, batch_major", OPS)
def test_gru_ops_cpu_is_the_plain_version(op, plain, batch_major, dtype):
    args = _gru_args(1, dtype, batch_major)
    assert torch.equal(op(*args), plain(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_op_cpu_is_the_plain_version(reverse, dtype):
    args = _lstm_args(2, dtype, reverse)
    got, want = library.lstm_recurrence(*args), cuda_lstm.lstm_recurrence_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("op, plain, batch_major", OPS)
def test_gru_ops_fake_shapes(op, plain, batch_major):
    with FakeTensorMode() as mode:
        args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                     for a in _gru_args(3, torch.bfloat16, batch_major))
        out = op(*args)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == ((B, T, H) if batch_major else (T, B, H))


def test_lstm_op_fake_shapes():
    with FakeTensorMode() as mode:
        args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                     for a in _lstm_args(4, torch.bfloat16, True))
        outs, c_last = library.lstm_recurrence(*args)
    assert (tuple(outs.shape), outs.dtype) == ((T, B, H), torch.float32)
    assert (tuple(c_last.shape), c_last.dtype) == ((B, H), torch.float32)


@pytest.mark.parametrize("op, args", [
    pytest.param(library.gru_recurrence, _gru_args(5, torch.float32), id="B1"),
    pytest.param(library.gru_recurrence_bt, _gru_args(5, torch.bfloat16, True), id="B3"),
    pytest.param(library.gru_recurrence_dma, _gru_args(5, torch.bfloat16), id="B4"),
    pytest.param(library.lstm_recurrence, _lstm_args(5, torch.float32, True), id="B2"),
])
def test_opcheck(op, args):
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name, args", [
    pytest.param("mm_f32", (torch.randn(2, 3, 8).bfloat16(), torch.randn(8, 5).bfloat16()),
                 id="mm_f32"),
    pytest.param("bmm_f32", (torch.randn(2, 4, 8).bfloat16(),
                             torch.randn(2, 8, 5).bfloat16()), id="bmm_f32"),
    pytest.param("conv2d_same", (torch.randn(2, 4, 5, 5).bfloat16(),
                                 torch.randn(3, 4, 3, 3).bfloat16()), id="conv2d_same"),
])
def test_product_ops_are_the_cpu_forms(name, args):
    """The product ops an exported program holds compute on the CPU what the
    layers compute there, and pass opcheck's schema and fake checks."""
    op = getattr(torch.ops.vcr_tpu_torch, name).default
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    want = {"mm_f32": lambda x, w: layers.vdot(x, w),
            "bmm_f32": lambda a, b: layers.bmm_f32(a, b),
            "conv2d_same": lambda x, w: layers.conv2d(
                {"w": w, "b": torch.zeros(w.shape[0])}, x)}[name](*args)
    got = op(*args)
    if name == "conv2d_same":
        got = got.float()
    assert torch.equal(got, want)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch, want", [
    pytest.param("s2vt", {"vcr_tpu_torch.gru_recurrence.default": 2}, id="s2vt"),
    pytest.param("rationale", {"vcr_tpu_torch.gru_recurrence.default": 2,
                               "vcr_tpu_torch.lstm_recurrence.default": 2}, id="rationale"),
])
def test_paths_reach_the_kernels_through_the_dispatcher(arch, want):
    spec, params = entry.make_spec_and_params(vocab_size=11, embed_size=4, hidden=8,
                                              vid_feat=6, max_len=3, num_frames=2,
                                              arch=arch, device="cpu")
    caption = serving.build_captioner(params, spec, device="cpu")
    with _Recorder() as rec:
        caption(torch.randn((2, 2, 6)))
    got = {op: rec.ops.count(op) for op in set(rec.ops) if op.startswith("vcr_tpu_torch.")
           and "recurrence" in op}
    assert got == want


def test_gru_sequence_gradients_unchanged():
    """GruSequence, whose forward runs the op, against jax.grad of the JAX
    package's plain GRU sequence, in float32."""
    jp = jrnn.gru_init(jax.random.PRNGKey(1), I, H)
    rng = np.random.default_rng(6)
    xs, h0 = (rng.standard_normal(s).astype(np.float32) for s in ((T, B, I), (B, H)))
    cot = rng.standard_normal((T, B, H)).astype(np.float32)

    def jloss(p, x, h):
        outs, _ = jrnn.gru_sequence(p, x, h, compute_dtype=jnp.float32)
        return jnp.sum(outs * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(xs), jnp.asarray(h0))
    tp = {k: v.requires_grad_(True) for k, v in bridge.from_jax_params(jp, "cpu").items()}
    txs, th0 = (torch.from_numpy(a).requires_grad_(True) for a in (xs, h0))
    outs, _ = cuda_gru.gru_sequence_fused(tp, txs, th0, compute_dtype=torch.float32)
    names = ["w_ih", "b_ih", "w_hh", "b_hh"]
    got = torch.autograd.grad((outs * torch.from_numpy(cot)).sum(),
                              [tp[k] for k in names] + [txs, th0])
    for g, w in zip(got, [want[0][k] for k in names] + list(want[1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_TOL)


def test_lstm_sequence_gradients_unchanged():
    """LstmSequence (reversed), whose forward runs the op, against jax.grad of
    the JAX package's plain LSTM sequence, in float32."""
    jp = jrnn.lstm_init(jax.random.PRNGKey(2), I, H)
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((T, B, I)).astype(np.float32)
    cot = rng.standard_normal((T, B, H)).astype(np.float32)

    def jloss(p, x):
        outs, _ = jrnn.lstm_sequence(p, x, None, reverse=True, compute_dtype=jnp.float32)
        return jnp.sum(outs * cot)

    want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(xs))
    tp = {k: v.requires_grad_(True) for k, v in bridge.from_jax_params(jp, "cpu").items()}
    txs = torch.from_numpy(xs).requires_grad_(True)
    outs, _ = cuda_lstm.lstm_sequence_fused(tp, txs, reverse=True,
                                            compute_dtype=torch.float32)
    names = ["w_ih", "b_ih", "w_hh", "b_hh"]
    got = torch.autograd.grad((outs * torch.from_numpy(cot)).sum(),
                              [tp[k] for k in names] + [txs])
    for g, w in zip(got, [want[0][k] for k in names] + [want[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("drop_in", [cuda_gru.gru_sequence_fused_bt,
                                     cuda_gru.gru_sequence_fused_dma], ids=["B3", "B4"])
def test_backward_through_forward_only_ops_raises(drop_in):
    """B3 and B4 are forward only, as the JAX package's drop-ins: with the op,
    a backward through them raises."""
    spec_p = bridge.from_jax_params(jrnn.gru_init(jax.random.PRNGKey(3), I, H), "cpu")
    params = {k: v.requires_grad_(True) for k, v in spec_p.items()}
    xs = torch.randn((B, T, I) if drop_in is cuda_gru.gru_sequence_fused_bt
                     else (T, B, I))
    outs, _ = drop_in(params, xs, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        outs.sum().backward()


def test_other_devices_raise():
    """The op's own implementation for a device with no kernel raises, as the
    wrappers do for a meta tensor."""
    with pytest.raises(ValueError, match="no GRU recurrence for device meta"):
        library._no_device("GRU", torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="no LSTM recurrence"):
        cuda_lstm.lstm_recurrence(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                                    for a in _lstm_args(8, torch.float32, False)))
