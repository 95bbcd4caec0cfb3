"""The port's quantization ops (``vcr_tpu_torch.ops.kvquant``,
``ops.wquant``) against the JAX package's, on the CPU in float32: codes and
scales bit for bit, the W8 products within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.ops import kvquant as jkv
from vcr_tpu.ops import wquant as jwq
from vcr_tpu_torch.ops import kvquant as tkv
from vcr_tpu_torch.ops import wquant as twq


def _vectors(seed=0):
    """(3, 2, 5, 8) float32 vectors with a zero vector and exact ties: a
    vector whose codes fall on .5 before rounding (half to even)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    v[0, 0, 0] = 0.0
    v[1, 1, 2] = np.array([7, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -7], np.float32)
    v[2, 0, 4] = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -127], np.float32)
    return v


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_matches_jax_bit_for_bit(mode):
    v = _vectors()
    qmax, _ = tkv.mode_params(mode)
    jq, js = jkv.quantize(jnp.asarray(v), qmax=qmax, qdtype=jkv.mode_params(mode)[1])
    tq, ts = tkv.quantize(torch.from_numpy(v), qmax)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert not tq[0, 0, 0].any() and ts[0, 0, 0].item() == 0.0
    # the ties round half to even, as jnp.round does
    assert tq.abs().max().item() <= qmax
    # the stored form, and the reference dequantization against JAX's
    codes, scales = tkv.quantize_store(torch.from_numpy(v), mode)
    assert codes.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    assert codes.shape[-1] == tkv.code_width(mode, 8)
    np.testing.assert_array_equal(tkv.unpack(codes).numpy(), tq.numpy())
    np.testing.assert_array_equal(
        tkv.dequantize(codes, scales[..., None]).numpy(),
        np.asarray(jkv.dequantize(jq, js)))
    x = torch.from_numpy(v[..., 0])
    assert torch.equal(tkv.fold_k(x, ts[..., 0]), x * ts[..., 0])
    assert torch.equal(tkv.fold_v(x, ts[..., 0]), x * ts[..., 0])


def test_int4_pack_round_trip():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)          # (3, 32)
    packed = tkv.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    assert torch.equal(tkv.unpack_int4(packed), q)
    # code 2j in the low nibble, 2j+1 in the high one
    assert packed[0, 0].item() == (0x8 | (0x9 << 4))


def _dense(seed=1, rows=4, din=6, dout=10):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    w[:, 3] = 0.0                                                    # a zero column
    return {"w": w, "b": rng.standard_normal(dout).astype(np.float32)}, \
        rng.standard_normal((rows, din)).astype(np.float32)


def test_quantize_dense_and_dense_q_match_jax():
    p, x = _dense()
    jp = jwq.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    tp = twq.quantize_dense({k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_array_equal(tp["wq"].numpy(), np.asarray(jp["wq"]))
    np.testing.assert_array_equal(tp["ws"].numpy().view(np.uint32),
                                  np.asarray(jp["ws"]).view(np.uint32))
    for cd, jcd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = twq.dense_q(tp, torch.from_numpy(x), cd).numpy()
        want = np.asarray(jwq.dense_q(jp, jnp.asarray(x), jcd))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(twq.dequantize_dense(tp)["w"].numpy(),
                                  np.asarray(jwq.dequantize_dense(jp)["w"]))
    # a stacked layer tree quantizes per layer
    stack = np.stack([p["w"], 2 * p["w"]])
    ts = twq.quantize_dense({"w": torch.from_numpy(stack)})
    np.testing.assert_array_equal(ts["wq"][1].numpy(), tp["wq"].numpy())


def test_augmented_gru_and_dense_match_jax():
    rng = np.random.default_rng(2)
    h, din, rows = 5, 7, 3
    g = {"w_ih": rng.standard_normal((din, 3 * h)).astype(np.float32),
         "w_hh": rng.standard_normal((h, 3 * h)).astype(np.float32),
         "b_ih": rng.standard_normal(3 * h).astype(np.float32),
         "b_hh": rng.standard_normal(3 * h).astype(np.float32)}
    jg = jwq.augment_gru({k: jnp.asarray(v) for k, v in g.items()})
    tg = twq.augment_gru({k: torch.from_numpy(v) for k, v in g.items()})
    assert twq.augment_gru(tg) is tg
    for k in ("wq_ih", "wq_hh", "ws_ih", "ws_hh"):
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]), err_msg=k)
    x = rng.standard_normal((rows, din)).astype(np.float32)
    hs = rng.standard_normal((rows, h)).astype(np.float32)
    for cd, jcd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_allclose(
            twq.gru_x_gates(tg, torch.from_numpy(x), cd).numpy(),
            np.asarray(jwq.gru_x_gates(jg, jnp.asarray(x), jcd)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            twq.gru_h_gates(tg, torch.from_numpy(hs), cd).numpy(),
            np.asarray(jwq.gru_h_gates(jg, jnp.asarray(hs), jcd)), rtol=0, atol=1e-6)
    p, xd = _dense(3)
    jd = jwq.augment_dense({k: jnp.asarray(v) for k, v in p.items()})
    td = twq.augment_dense({k: torch.from_numpy(v) for k, v in p.items()})
    assert twq.augment_dense(td) is td and "w" in td
    np.testing.assert_allclose(
        twq.dense_aug(td, torch.from_numpy(xd)).numpy(),
        np.asarray(jwq.dense_aug(jd, jnp.asarray(xd))), rtol=0, atol=1e-6)


def test_resolve_mode():
    assert twq.resolve_mode(None) == "bf16" and twq.resolve_mode("int8") == "int8"
    with pytest.raises(ValueError, match="decode_weights"):
        twq.resolve_mode("int4")
