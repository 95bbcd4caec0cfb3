"""The port's VGG16 and ResNet-18/34 featurizers against the JAX package on
the CPU, from one JAX parameter tree: the backbones' strided conv and max
pools, fc7 and the pooled features in float32 and bf16, the basic block
against torch's own modules, and the torchvision state_dict converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vcr_tpu.models import resnet as jresnet
from vcr_tpu.models import vgg as jvgg
from vcr_tpu_torch import bridge
from vcr_tpu_torch.models import resnet as tresnet
from vcr_tpu_torch.models import vgg as tvgg
from vcr_tpu_torch.nn import layers as tlayers

F32_TOL = 1e-5      # float32 features relative to the largest |feature|:
                    # sums in other orders through 13-36 convs; read
                    # 8.4e-7 (VGG16), 8.6e-7 (ResNet-18), 5.2e-7 (ResNet-34)
BF16_TOL = 2e-2     # bf16 envelope, the same relative measure: both round
                    # each layer's output to bf16, and a float32 sum one
                    # ulp apart rounds to the other bf16 neighbour now and
                    # then, which later layers carry on; read 4.9e-3
                    # (VGG16), 5.6e-3 (ResNet-18), 5.7e-3 (ResNet-34)
SIZE = 32
DTYPES = [(jnp.float32, torch.float32, F32_TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _frames(n=3, size=SIZE, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(
        np.float32)


@pytest.fixture(scope="module")
def vgg_params():
    """VGG16's 13 convs, He-normal as both inits draw them, from a numpy
    generator (one tree for both packages), with small biases; at 32x32 fc6
    reads 512 values, so fc6 and fc7 are (512, 64) and (64, 64)."""
    rng = np.random.default_rng(0)
    jp, in_ch = {"convs": []}, 3
    for v in (c for c in jvgg._CFG if c != "M"):
        w = (2.0 / (in_ch * 9)) ** 0.5 * rng.standard_normal((v, in_ch, 3, 3))
        jp["convs"].append({"w": w.astype(np.float32),
                            "b": np.full((v,), 0.01, np.float32)})
        in_ch = v
    jp["fc6"] = {"w": (0.05 * rng.standard_normal((512, 64))).astype(np.float32),
                 "b": np.full((64,), 0.1, np.float32)}
    jp["fc7"] = {"w": (0.05 * rng.standard_normal((64, 64))).astype(np.float32),
                 "b": np.full((64,), -0.05, np.float32)}
    return jp, bridge.from_jax_params(jp, "cpu")


def _random_bn(tree, rng):
    """Every BatchNorm's stats and affine drawn, so eval mode is a real test."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": rng.normal(0, 0.1, n).astype(np.float32),
                    "mean": rng.normal(0, 0.1, n).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_bn(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module", params=["resnet18", "resnet34"])
def resnet_params(request):
    """The port's init as one numpy tree for both packages, every
    BatchNorm drawn."""
    tp = tresnet.init_params(torch.Generator().manual_seed(2), request.param)
    jp = _random_bn(bridge.to_numpy(tp), np.random.default_rng(3))
    return request.param, jp, bridge.from_jax_params(jp, "cpu")


@pytest.mark.parametrize("k, stride, pad", [(3, 1, 1), (7, 2, 3), (3, 2, 1), (1, 2, 0)])
@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32),
                                      (jnp.bfloat16, torch.bfloat16)])
def test_strided_conv_matches_lax(k, stride, pad, jdt, tdt):
    """conv2d_f32 against lax.conv_general_dilated with the explicit,
    symmetric padding and a float32 result: the products of bf16-rounded
    operands are exact in float32, so both dtypes agree to float32 sums."""
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 6, 11, 11)).astype(np.float32)
    w = rng.standard_normal((5, 6, k, k)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)
    got = tlayers.conv2d_f32(torch.from_numpy(x), torch.from_numpy(w), stride, pad, tdt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-6


def test_max_pools_match_reduce_window():
    """torch's max pool as the VGG and ResNet models use it (2x2/2, VALID;
    3x3/2 with padding 1, which torch fills with -inf) on a map of negative
    values, and Darknet's stride-1 pool (edge-extended)."""
    x = -np.abs(np.random.default_rng(4).standard_normal((2, 3, 9, 9))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jax.lax.reduce_window(jx, -jnp.inf, jax.lax.max, (1, 1, 2, 2), (1, 1, 2, 2),
                                 "VALID")
    np.testing.assert_array_equal(F.max_pool2d(tx, 2, 2).numpy(), want)
    want = jax.lax.reduce_window(jx, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2),
                                 [(0, 0), (0, 0), (1, 1), (1, 1)])
    np.testing.assert_array_equal(F.max_pool2d(tx, 3, 2, 1).numpy(), want)
    padded = jnp.pad(jx, ((0, 0), (0, 0), (0, 2), (0, 2)), mode="edge")
    want = jax.lax.reduce_window(padded, -jnp.inf, jax.lax.max, (1, 1, 3, 3),
                                 (1, 1, 1, 1), "VALID")
    np.testing.assert_array_equal(tlayers.max_pool2d_edge(tx, 3).numpy(), want)


@pytest.mark.parametrize("jdt, tdt, tol", DTYPES)
def test_vgg_fc7_matches_jax(vgg_params, jdt, tdt, tol):
    jp, tp = vgg_params
    x = _frames()
    want = np.asarray(jvgg.extract_fc7(jp, jnp.asarray(x), jdt))
    got = tvgg.extract_fc7(tp, torch.from_numpy(x), tdt)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 64)
    assert _rel(got.numpy(), want) <= tol


@pytest.mark.parametrize("jdt, tdt, tol", DTYPES)
def test_resnet_features_match_jax(resnet_params, jdt, tdt, tol):
    _, jp, tp = resnet_params
    x = _frames()
    want = np.asarray(jresnet.extract_features(jax.tree_util.tree_map(jnp.asarray, jp),
                                               jnp.asarray(x), jdt))
    got = tresnet.extract_features(tp, torch.from_numpy(x), tdt)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 512)
    assert _rel(got.numpy(), want) <= tol


def test_resnet_init_has_jax_structure(resnet_params):
    """The port's random init has the JAX tree's structure and shapes,
    downsample blocks where JAX has them."""
    arch = resnet_params[0]
    jp = jax.eval_shape(lambda k: jresnet.init_params(k, arch), jax.random.PRNGKey(0))
    tp = tresnet.init_params(torch.Generator().manual_seed(0), arch)
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    tleaves, tdef = jax.tree_util.tree_flatten(bridge.to_numpy(tp))
    assert jdef == tdef
    assert [a.shape for a in jleaves] == [b.shape for b in tleaves]


def test_vgg_init_has_jax_structure():
    jp = jax.eval_shape(jvgg.init_params, jax.random.PRNGKey(0))
    tp = bridge.to_numpy(tvgg.init_params(torch.Generator().manual_seed(0)))
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    tleaves, tdef = jax.tree_util.tree_flatten(tp)
    assert jdef == tdef
    assert [a.shape for a in jleaves] == [b.shape for b in tleaves]


def test_basic_block_matches_torch_modules():
    """One downsampling basic block against torch's Conv2d/BatchNorm2d in
    eval mode (the torchvision block), and against JAX's."""
    import torch.nn as nn

    torch.manual_seed(0)
    conv = lambda i, o, k, s, p: nn.Conv2d(i, o, k, s, p, bias=False)  # noqa: E731
    mods = {"conv1": conv(4, 8, 3, 2, 1), "bn1": nn.BatchNorm2d(8),
            "conv2": conv(8, 8, 3, 1, 1), "bn2": nn.BatchNorm2d(8),
            "ds": conv(4, 8, 1, 2, 0), "dsbn": nn.BatchNorm2d(8)}
    with torch.no_grad():
        for m in mods.values():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_()
            m.eval()

    def bn(m):
        return {"scale": m.weight.detach(), "bias": m.bias.detach(),
                "mean": m.running_mean.clone(), "var": m.running_var.clone()}

    blk = {"conv1": mods["conv1"].weight.detach(), "bn1": bn(mods["bn1"]),
           "conv2": mods["conv2"].weight.detach(), "bn2": bn(mods["bn2"]),
           "downsample": {"conv": mods["ds"].weight.detach(), "bn": bn(mods["dsbn"])}}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(
        np.float32))
    with torch.no_grad():
        out = torch.relu(mods["bn1"](mods["conv1"](x)))
        out = mods["bn2"](mods["conv2"](out))
        want = torch.relu(out + mods["dsbn"](mods["ds"](x)))
    got = tresnet._basic_block(blk, x, stride=2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    jblk = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jresnet._basic_block(jblk, jnp.asarray(x.numpy()), stride=2)), atol=1e-5)


def _torchvision_vgg_state_dict(gen):
    sd, layer_idx, in_ch = {}, 0, 3
    for v in tvgg._CFG:
        if v == "M":
            layer_idx += 1
            continue
        sd[f"features.{layer_idx}.weight"] = torch.randn((v, in_ch, 3, 3), generator=gen)
        sd[f"features.{layer_idx}.bias"] = torch.randn((v,), generator=gen)
        in_ch, layer_idx = v, layer_idx + 2
    sd["classifier.0.weight"] = torch.randn((96, 512 * 7 * 7), generator=gen)
    sd["classifier.0.bias"] = torch.randn((96,), generator=gen)
    sd["classifier.3.weight"] = torch.randn((80, 96), generator=gen)
    sd["classifier.3.bias"] = torch.randn((80,), generator=gen)
    return sd


def _assert_same_tree(tp, jp):
    jleaves, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jp))
    tleaves, tdef = jax.tree_util.tree_flatten(bridge.to_numpy(tp))
    assert jdef == tdef
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a, b)


def test_vgg_state_dict_conversion_matches_jax():
    """A state_dict with torchvision's vgg16 key layout (classifier widths cut
    to 96 and 80) gives the same tree in both packages, leaf for leaf."""
    sd = _torchvision_vgg_state_dict(torch.Generator().manual_seed(0))
    tp = tvgg.load_torch_state_dict(sd)
    assert len(tp["convs"]) == 13 and tp["fc6"]["w"].shape == (512 * 7 * 7, 96)
    _assert_same_tree(tp, jvgg.load_torch_state_dict(sd))
    # numpy arrays convert too
    _assert_same_tree(tvgg.load_torch_state_dict({k: v.numpy() for k, v in sd.items()}),
                      jvgg.load_torch_state_dict(sd))


def torchvision_resnet_state_dict(arch, gen):
    """A state_dict with torchvision's resnet18/34 keys and shapes (fc
    included, which both converters skip), random values."""
    sd = {"conv1.weight": torch.randn((64, 3, 7, 7), generator=gen)}

    def bn(prefix, ch):
        sd[prefix + ".weight"] = torch.rand((ch,), generator=gen) + 0.5
        sd[prefix + ".bias"] = torch.randn((ch,), generator=gen) * 0.1
        sd[prefix + ".running_mean"] = torch.randn((ch,), generator=gen) * 0.1
        sd[prefix + ".running_var"] = torch.rand((ch,), generator=gen) + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    bn("bn1", 64)
    in_ch = 64
    for stage, (n, ch) in enumerate(zip(tresnet._BLOCKS[arch], tresnet._STAGE_CH)):
        for b in range(n):
            pre = f"layer{stage + 1}.{b}"
            sd[pre + ".conv1.weight"] = torch.randn((ch, in_ch, 3, 3), generator=gen) * 0.1
            bn(pre + ".bn1", ch)
            sd[pre + ".conv2.weight"] = torch.randn((ch, ch, 3, 3), generator=gen) * 0.1
            bn(pre + ".bn2", ch)
            if stage > 0 and b == 0:
                sd[pre + ".downsample.0.weight"] = torch.randn((ch, in_ch, 1, 1),
                                                               generator=gen) * 0.1
                bn(pre + ".downsample.1", ch)
            in_ch = ch
    sd["fc.weight"] = torch.randn((1000, 512), generator=gen)
    sd["fc.bias"] = torch.zeros((1000,))
    return sd


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_resnet_state_dict_conversion_matches_jax(arch):
    """torchvision's resnet keys, downsample blocks included, give the same
    tree in both packages, and the same features from it."""
    sd = torchvision_resnet_state_dict(arch, torch.Generator().manual_seed(1))
    tp = tresnet.load_torch_state_dict(sd, arch)
    jp = jresnet.load_torch_state_dict(sd, arch)
    assert [("downsample" in blk) for st in tp["layers"] for blk in st] == \
        [stage > 0 and b == 0 for stage, n in enumerate(tresnet._BLOCKS[arch])
         for b in range(n)]
    _assert_same_tree(tp, jp)
    x = _frames(2, seed=5)
    want = np.asarray(jresnet.extract_features(jp, jnp.asarray(x), jnp.float32))
    assert _rel(tresnet.extract_features(tp, torch.from_numpy(x), torch.float32).numpy(),
                want) <= F32_TOL


def test_bridge_carries_lists_and_none():
    """Lists, tuples and None cross the bridge leaf for leaf and back."""
    tree = {"a": [np.ones((2,), np.float32), None, {"b": np.zeros((1, 2), np.float32)}],
            "c": (np.arange(3, dtype=np.int32),)}
    t = bridge.from_jax_params(tree, "cpu")
    assert isinstance(t["a"], list) and t["a"][1] is None and isinstance(t["c"], tuple)
    back = bridge.to_numpy(t)
    assert back["a"][1] is None
    np.testing.assert_array_equal(back["a"][2]["b"], tree["a"][2]["b"])
    np.testing.assert_array_equal(back["c"][0], tree["c"][0])
