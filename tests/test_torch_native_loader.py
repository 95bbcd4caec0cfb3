"""The port's C++ batch loader (``vcr_tpu_torch.data.native``, built by g++
from its own copy of the source) against the JAX package's
(``vcr_tpu.data.native``), call for call and bit for bit, and the port's
``BatchIterator`` on both of its routes against JAX's ``BatchIterator``."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from util_corpus import build_corpus  # noqa: E402
from vcr_tpu.data import native as jnative  # noqa: E402
from vcr_tpu.data import pipeline as jpipeline  # noqa: E402
from vcr_tpu_torch.data import native as tnative  # noqa: E402
from vcr_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from vcr_tpu_torch.ops import _build  # noqa: E402


def _write(tmp_path, name, arr):
    path = str(tmp_path / f"{name}.npy")
    np.save(path, arr)
    return path


@pytest.mark.parametrize("dtype,feat_shape", [
    (np.float32, (6,)), (np.float64, (6,)), (np.float32, (5, 3, 3)),
    (np.float64, (5, 3, 3))], ids=["f4", "f8", "grid-f4", "grid-f8"])
def test_load_feature_batch_matches_jax(tmp_path, dtype, feat_shape):
    """Rows shorter than num_frames are zero-padded, longer ones truncated;
    float64 rounds to float32 as numpy's astype does."""
    rng = np.random.default_rng(0)
    frames = [2, 4, 7, 4, 1]
    paths = [_write(tmp_path, f"v{i}", (rng.standard_normal((n, *feat_shape)) * 3)
                    .astype(dtype)) for i, n in enumerate(frames)]
    got = tnative.load_feature_batch(paths, 4, feat_shape, n_threads=3)
    want = jnative.load_feature_batch(paths, 4, feat_shape, n_threads=3)
    assert got.dtype == np.float32 and got.shape == (5, 4, *feat_shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for i, p in enumerate(paths):
        a = np.load(p)[:4].astype(np.float32)
        np.testing.assert_array_equal(got[i, :len(a)].view(np.uint32), a.view(np.uint32))
        assert not got[i, len(a):].any()
        assert tnative.probe_npy(p) == jnative.probe_npy(p)


def test_refused_file_raises_naming_the_batch(tmp_path):
    good = _write(tmp_path, "good", np.ones((3, 4), np.float32))
    bad = _write(tmp_path, "bad", np.ones((3, 4), np.float16))
    with pytest.raises(IOError, match="bad.npy"):
        tnative.load_feature_batch([good, bad], 3, (4,))
    with pytest.raises(IOError):
        tnative.probe_npy(bad)
    # the JAX package's library refuses it with the same code path
    with pytest.raises(IOError):
        jnative.load_feature_batch([good, bad], 3, (4,))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found"):
            tnative.get_lib()
    finally:
        _build.load_host.cache_clear()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp:\n.*error"):
        _build.load_host(src)
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------- BatchIterator

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_corpus"))
    glove = build_corpus(root, num_videos=7, num_frames=5, feat_dim=6)
    return root, glove


def _epochs(mod, root, glove, epochs=2, skip=0, use_native=True, **kw):
    v = mod.Vocab(glove, seed=0)
    ds = mod.CaptionDataset(root, "msvd_vgg", "train", v, num_frames=4, max_len=5)
    it = mod.BatchIterator(ds, 3, seed=11, num_threads=2, use_native=use_native, **kw)
    out = []
    for _ in range(epochs):
        it.skip_next = skip
        out.append(list(it))
    return it, out


def _assert_same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want] and len(got[0]) > 0
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            assert bg.keys() == bw.keys()
            for k in bw:
                if isinstance(bw[k], np.ndarray):
                    assert bg[k].dtype == bw[k].dtype, k
                    np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)
                else:
                    assert bg[k] == bw[k], k


@pytest.mark.parametrize("kw", [
    {"shuffle": True}, {"shuffle": False}, {"shuffle": True, "skip": 1},
    {"shuffle": True, "num_shards": 2, "shard_index": 1}],
    ids=["shuffled", "in-order", "skip_next", "shard-1-of-2"])
def test_batch_iterator_routes_match_jax(corpus, kw):
    """7 videos in batches of 3: a short final batch, zero-padded, on both
    routes; the same batches as the JAX package's native and numpy paths."""
    root, glove = corpus
    it_n, native_b = _epochs(tpipeline, root, glove, use_native=True, **kw)
    it_p, numpy_b = _epochs(tpipeline, root, glove, use_native=False, **kw)
    assert (it_n.route, it_p.route) == ("native", "numpy")
    for use_native in (True, False):
        _, want = _epochs(jpipeline, root, glove, use_native=use_native, **kw)
        _assert_same(native_b, want)
        _assert_same(numpy_b, want)


@pytest.mark.parametrize("layout", ["f2", "fortran", "big-endian"])
def test_other_first_layout_takes_numpy_route(tmp_path, layout):
    root = str(tmp_path)
    glove = build_corpus(root, num_videos=4, num_frames=4, feat_dim=6)
    feat_dir = os.path.join(root, "msvd_vgg", "feats")
    first = os.path.join(feat_dir, "train_vid0.npy")
    a = np.load(first)
    if layout == "f2":
        np.save(first, a.astype(np.float16))
    elif layout == "fortran":
        np.save(first, np.asfortranarray(a.astype(np.float64)))
    else:
        np.save(first, a.astype(">f4"))
    it, got = _epochs(tpipeline, root, glove, shuffle=True)
    assert it.route == "numpy"
    _, want = _epochs(jpipeline, root, glove, shuffle=True)
    _assert_same(got, want)


def test_refused_later_file_raises(tmp_path):
    root = str(tmp_path)
    glove = build_corpus(root, num_videos=4, num_frames=4, feat_dim=6)
    later = os.path.join(root, "msvd_vgg", "feats", "train_vid3.npy")
    np.save(later, np.load(later).astype(np.float16))
    it, _ = _epochs(tpipeline, root, glove, epochs=0, shuffle=False)
    assert it.route == "native"
    with pytest.raises(IOError, match="train_vid3.npy"):
        list(it)


def test_empty_dataset_takes_numpy_route(tmp_path):
    root = str(tmp_path)
    glove = build_corpus(root, num_videos=2)
    with open(os.path.join(root, "msvd_vgg", "train_captions.json"), "w") as f:
        f.write("[]")
    it, got = _epochs(tpipeline, root, glove, shuffle=True)
    assert it.route == "numpy" and got == [[], []]
