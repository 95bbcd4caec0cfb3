"""The port's whole-batch serving artifact against the JAX package's, on the
CPU, from one JAX parameter tree: for each of the five families, greedy and
beam 3, the port's artifact gives the JAX artifact's tokens on the same
features in float32 (RationaleNet's with JAX's selection noise fed to the
port's program; under its own draw plan it equals the live port call), and
its ``weights.npz`` equals JAX's key for key and leaf for leaf, in float32
and with bf16 products."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vcr_tpu import export_serving as jexport
from vcr_tpu_torch import export_serving as texport
from vcr_tpu_torch import serving

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_decode import _jax_gumbel  # noqa: E402
from test_torch_export_serving import ARCHS, N, _models  # noqa: E402


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _models(request.param)


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
def test_artifact_equals_jax_artifact(family, beam, tmp_path):
    jspec, jparams, tspec, tparams, feats = family
    jdir = jexport.export_captioner(jparams, jspec, str(tmp_path / "jax"), beam_size=beam,
                                    platforms=("cpu",))
    want = np.asarray(jexport.load_artifact(jdir).caption(feats))
    tdir = texport.export_captioner(tparams, tspec, str(tmp_path / "port"),
                                    beam_size=beam, device="cpu")
    art = texport.load_artifact(tdir, device="cpu")
    live = serving.build_captioner(tparams, tspec, beam_size=beam, device="cpu")
    got = art(feats)
    assert torch.equal(got, live(feats))
    if tspec.arch == "rationale":
        # JAX draws its selection noise from PRNGKey(0); fed to the port's
        # program, it gives JAX's tokens
        noise = torch.from_numpy(_jax_gumbel(jax.random.PRNGKey(0),
                                             (N, tspec.num_frames, 2)))
        with torch.no_grad():
            got = art._module(art.leaves, torch.from_numpy(feats), [noise])
        assert art.meta["draws"]["plan"][0]["input"] == "select"
    np.testing.assert_array_equal(got.numpy(), want)
    if beam == 1:
        _assert_weights_equal(jdir, tdir, jparams)


def _assert_weights_equal(jdir, tdir, jparams):
    """weights.npz key for key and leaf for leaf, the leaf dtypes and the
    leaf order (``jax.tree_util``'s paths) against the JAX artifact's."""
    with np.load(os.path.join(jdir, "weights.npz")) as jw, \
            np.load(os.path.join(tdir, "weights.npz")) as tw:
        assert sorted(jw.files) == sorted(tw.files)
        for k in jw.files:
            np.testing.assert_array_equal(tw[k], jw[k])
    with open(os.path.join(jdir, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tdir, "meta.json")) as f:
        tmeta = json.load(f)
    assert tmeta["leaf_dtypes"] == jmeta["leaf_dtypes"]
    assert tmeta["leaf_paths"] == [
        "/".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]


@pytest.mark.parametrize("arch", ["s2vt", "spatial", "rationale"])
def test_weights_equal_jax_artifact_bf16(arch, tmp_path):
    """The same for bf16 products (the leaves stay float32 in both)."""
    jspec, jparams, tspec, tparams, _ = _models(arch, compute_dtype="bfloat16")
    jdir = jexport.export_captioner(jparams, jspec, str(tmp_path / "jax"),
                                    platforms=("cpu",))
    tdir = texport.export_captioner(tparams, tspec, str(tmp_path / "port"), device="cpu")
    _assert_weights_equal(jdir, tdir, jparams)
