"""The port's Darknet / YOLOv3 against the JAX package on the CPU: the cfg
reader and the filter chain, the binary .weights file read and written
byte for byte, the forward, the detections of one and of all heads, the
feature cut, reorg, the max pools and YOLOv3's published plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_tpu.models import darknet as jdn
from vcr_tpu_torch import bridge
from vcr_tpu_torch.models import darknet as tdn

F32_TOL = 1e-5      # float32 maps and detections relative to the largest
                    # |value|; read 3.0e-7 to 1.9e-6
BF16_TOL = 1e-5     # bf16: both keep the maps float32 between layers and
                    # round only each conv's operands; read 6.6e-8 to 9.5e-7

# the cfg of tests/test_darknet.py: its shortcut adds maps of two sizes, so
# it serves the reader, the chain and the weights file, not a forward
TINY_CFG = """
[net]
height=32
width=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
filters=24
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326
classes=3
num=9
"""


def _conv(filters, size, stride=1, bn=True, act="leaky"):
    return ("[convolutional]\n" + ("batch_normalize=1\n" if bn else "")
            + f"filters={filters}\nsize={size}\nstride={stride}\npad=1\n"
              f"activation={act}\n\n")


_YOLO = ("[yolo]\nmask={}\nanchors=10,13, 16,30, 33,23, 30,61, 62,45, 59,119, "
         "116,90, 156,198, 373,326\nclasses=3\nnum=9\n\n")
_NET = "[net]\nheight=32\nwidth=32\nchannels=3\n\n"

# a Darknet-53 residual block, then a head: the cut is the 3x3 conv's map
RESIDUAL_CFG = (_NET + _conv(8, 3) + _conv(16, 3, 2) + _conv(8, 1) + _conv(16, 3)
                + "[shortcut]\nfrom=-3\nactivation=linear\n\n" + _conv(16, 3)
                + _conv(24, 1, bn=False, act="linear") + _YOLO.format("6,7,8"))
# both pools, a route back past the first head, upsample, a two-layer route
# with a positive (absolute) index, reorg and a second head
ROUTE_CFG = (_NET + _conv(8, 3) + "[maxpool]\nsize=2\nstride=2\n\n" + _conv(16, 3, 2)
             + "[maxpool]\nsize=2\nstride=1\n\n" + _conv(24, 1, bn=False, act="linear")
             + _YOLO.format("3,4,5") + "[route]\nlayers = -3\n\n"
             + "[upsample]\nstride=2\n\n" + "[route]\nlayers = -1, 1\n\n"
             + "[reorg]\nstride=2\n\n" + _conv(24, 1, bn=False, act="linear")
             + _YOLO.format("0,1,2"))
CFGS = {"tiny": TINY_CFG, "residual": RESIDUAL_CFG, "route": ROUTE_CFG}


@pytest.fixture
def cfg_path(tmp_path):
    def write(name):
        p = tmp_path / f"{name}.cfg"
        p.write_text(CFGS[name])
        return str(p)
    return write


def _random_bn(params, rng):
    """Every BatchNorm's stats and affine, and every bias, drawn."""
    out = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        p = dict(p)
        n = p["w"].shape[0]
        if "bn" in p:
            p["bn"] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                       "bias": rng.normal(0, 0.1, n).astype(np.float32),
                       "mean": rng.normal(0, 0.1, n).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        else:
            p["b"] = rng.normal(0, 0.1, n).astype(np.float32)
        out.append(p)
    return out


def _nets(path, seed=3):
    """(JAX net, the port's net) with one set of weights."""
    jnet = jdn.Darknet(path, key=jax.random.PRNGKey(seed))
    jnet.params = _random_bn(jax.tree_util.tree_map(np.asarray, jnet.params),
                             np.random.default_rng(seed))
    return jnet, bridge.from_jax_darknet(jnet, "cpu")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cfg_and_filter_chain_match_jax(cfg_path, name):
    path = cfg_path(name)
    assert tdn.parse_cfg(path) == jdn.parse_cfg(path)
    blocks = tdn.parse_cfg(path)
    assert tdn.build_filter_chain(blocks) == jdn.build_filter_chain(blocks)
    if name == "tiny":
        assert tdn.build_filter_chain(blocks) == [8, 16, 16, 24, 24]


def test_cfg_parser_robustness(tmp_path):
    """Comments, blank lines, stray whitespace, values with '=' inside."""
    p = tmp_path / "messy.cfg"
    p.write_text("# top comment\n\n[net]\n  height = 32  \nwidth=32\n\n"
                 "# layer comment\n[convolutional]\nbatch_normalize=1\nfilters=8\n"
                 "size=3\nstride=1\npad=1\nactivation=leaky\nnote=a=b\n\n")
    assert tdn.parse_cfg(str(p)) == jdn.parse_cfg(str(p))
    assert tdn.parse_cfg(str(p))[1]["note"] == "a=b"


@pytest.mark.parametrize("name", ["tiny", "route"])
def test_weights_file_round_trip_is_byte_equal(cfg_path, tmp_path, name):
    """A .weights file the JAX package writes is read by the port, leaf for
    leaf with its header, and written back byte for byte; the port's own
    writer matches JAX's reader."""
    path = cfg_path(name)
    jnet, _ = _nets(path)
    jnet.header = np.array([0, 2, 5, 32013312, 0], dtype=np.int32)
    jfile, tfile = str(tmp_path / "jax.weights"), str(tmp_path / "port.weights")
    jnet.save_weights(jfile)
    tnet = tdn.Darknet(path, gen=torch.Generator().manual_seed(9))
    tnet.load_weights(jfile)
    np.testing.assert_array_equal(tnet.header, jnet.header)
    jleaves, jdef = jax.tree_util.tree_flatten(jnet.params)
    tleaves, tdef = jax.tree_util.tree_flatten(bridge.to_numpy(tnet.params))
    assert jdef == tdef
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a, b)
    tnet.save_weights(tfile)
    with open(jfile, "rb") as f, open(tfile, "rb") as g:
        assert f.read() == g.read()
    back = jdn.Darknet(path)
    back.load_weights(tfile)
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_weights_file_of_the_wrong_size_raises(cfg_path, tmp_path):
    path = cfg_path("tiny")
    jnet, tnet = _nets(path)
    wfile = str(tmp_path / "w.weights")
    jnet.save_weights(wfile)
    with open(wfile, "ab") as f:
        np.zeros(3, np.float32).tofile(f)
    with pytest.raises(ValueError, match="mismatch"):
        tnet.load_weights(wfile)
    with open(wfile, "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="ends after"):
        tnet.load_weights(wfile)


@pytest.mark.parametrize("name", ["residual", "route"])
@pytest.mark.parametrize("jdt, tdt, tol", [(jnp.float32, torch.float32, F32_TOL),
                                           (jnp.bfloat16, torch.bfloat16, BF16_TOL)])
def test_forward_heads_and_cut_match_jax(cfg_path, name, jdt, tdt, tol):
    jnet, tnet = _nets(cfg_path(name))
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    for fn in ("get_feats", "forward", "forward_all_heads"):
        want = np.asarray(getattr(jnet, fn)(jnp.asarray(x), jdt))
        got = getattr(tnet, fn)(torch.from_numpy(x), tdt)
        assert got.dtype == torch.float32 and got.shape == want.shape, fn
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max(), fn
    # the cut is the map two layers before the first head; explicit params
    # are the trace's weights
    feats = tnet.get_feats(torch.from_numpy(x), tdt, params=tnet.params)
    assert feats.shape[1] == tnet.filter_chain[tnet._trace(
        tnet.params, torch.from_numpy(x), tdt, True)[2] - 2]


def test_reorg_and_pools_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(tdn.reorg(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdn.reorg(jnp.asarray(x))))
    y = np.random.default_rng(2).standard_normal((2, 3, 7, 7)).astype(np.float32)
    for size, stride in ((2, 1), (3, 1), (2, 2)):
        np.testing.assert_array_equal(
            tdn._maxpool(torch.from_numpy(y), size, stride).numpy(),
            np.asarray(jdn._maxpool(jnp.asarray(y), size, stride)))
    with pytest.raises(ValueError, match="divide"):
        tdn.reorg(torch.zeros((1, 1, 3, 4)))


def test_predict_transform_matches_jax():
    pred = np.random.default_rng(3).standard_normal((2, 2 * 6, 3, 3)).astype(np.float32)
    anchors = [(4, 8), (8, 4)]
    want = np.asarray(jdn.predict_transform(jnp.asarray(pred), 12, anchors, 1))
    got = tdn.predict_transform(torch.from_numpy(pred), 12, anchors, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    zero = tdn.predict_transform(torch.zeros((1, 12, 2, 2)), 8, anchors, 1).numpy()
    np.testing.assert_allclose(zero[0, 0, :4], [2.0, 2.0, 4.0, 8.0], atol=1e-6)


def test_yolov3_plan_reads_the_same_in_both_packages(tmp_path):
    """The published YOLOv3 plan up to its first head: 59 convs (52 of
    Darknet-53, 7 of the head), 23 shortcuts, one yolo; both packages read
    the same blocks and chain, and the cut at 416 is 1024 channels at 13x13
    (stride 32), two layers before the 255-channel head."""
    p = tmp_path / "yolov3_first_head.cfg"
    p.write_text(tdn.yolov3_first_head_cfg(416))
    blocks = tdn.parse_cfg(str(p))
    assert blocks == jdn.parse_cfg(str(p)) == tdn.parse_cfg_text(p.read_text())
    types = [b["type"] for b in blocks[1:]]
    assert (types.count("convolutional"), types.count("shortcut"), types.count("yolo"),
            len(types)) == (59, 23, 1, 83)
    chain = tdn.build_filter_chain(blocks)
    assert chain == jdn.build_filter_chain(blocks)
    first_yolo = types.index("yolo")
    assert (first_yolo, chain[first_yolo - 2], chain[first_yolo - 1]) == (82, 1024, 255)
    strides = [int(b["stride"]) for b in blocks[1:] if b["type"] == "convolutional"]
    assert np.prod(strides) == 32 and 416 // 32 == 13


def test_yolov3_cut_shape_at_a_small_input(tmp_path):
    """The whole plan on one 64x64 frame in the port (the forward's parity
    with JAX is held on the smaller cfgs above): the cut is (1, 1024, 2, 2),
    finite, and the first head's detections (1, 2*2*3, 85)."""
    p = tmp_path / "yolov3_first_head.cfg"
    p.write_text(tdn.yolov3_first_head_cfg(64))
    tnet = tdn.Darknet(str(p))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 64, 64)).astype(
        np.float32))
    feats = tnet.get_feats(x, torch.float32)
    assert feats.shape == (1, 1024, 2, 2) and bool(torch.isfinite(feats).all())
    assert tnet.forward(x, torch.float32).shape == (1, 2 * 2 * 3, 85)
