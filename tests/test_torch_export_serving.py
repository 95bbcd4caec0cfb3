"""The port's whole-batch serving artifact (``vcr_tpu_torch/export_serving.py``)
on the CPU, beside the JAX package's (``vcr_tpu/export_serving.py``): the
sampling decodes, whose noise the two packages cannot share by seed, equal
the live port call under the artifact's draw plan; the symbolic and the
fixed batch, the bf16 leaf round trip, input validation, the int8-weight
tree against JAX's, a fresh interpreter that loads with no model code,
``--mode export_serving`` against ``--mode decode``, and the refusals. The
five families against JAX's artifacts: ``test_torch_export_serving_jax.py``."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import export_serving as jexport
from vcr_tpu_torch import bridge, cli, entry, serving
from vcr_tpu_torch import export_serving as texport
from vcr_tpu_torch.config import get_config
from vcr_tpu_torch import tools as ttools

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=12, max_len=6,
            num_frames=4)
GRID = 3
ARCHS = ["s2vt", "s2vt-att", "spatial", "rationale", "transformer"]
N = 5


def _models(arch, compute_dtype="float32", seed=0):
    """(JAX spec, JAX params as numpy, port spec, port params, feats) from
    one JAX parameter tree; SpatialNet and RationaleNet over S2VT."""
    kw = dict(arch=arch, compute_dtype=compute_dtype, vocab_pad_to=8, seed=seed)
    dims = dict(DIMS)
    if arch in ("spatial", "rationale"):
        kw["base_arch"] = "s2vt"
    if arch == "spatial":
        kw["grid_size"] = GRID
        dims["vid_feat"] = 6
    if arch == "transformer":
        # one layer and 4 steps: its export traces every step of every layer
        kw.update(tf_layers=1, tf_heads=2)
        dims["max_len"] = 4
    jspec, jparams = graft._make_spec_and_params(**dims, **kw)
    tspec, _ = entry.make_spec_and_params(**dims, device="cpu", **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    shape = (N, dims["num_frames"], dims["vid_feat"]) + ((GRID, GRID) if arch == "spatial"
                                                         else ())
    feats = np.random.default_rng(seed + 3).standard_normal(shape).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module")
def s2vt_art(tmp_path_factory):
    """One symbolic-batch S2VT artifact, shared by the tests of the format."""
    _, jparams, tspec, tparams, feats = _models("s2vt")
    out = str(tmp_path_factory.mktemp("art") / "s2vt")
    texport.export_captioner(tparams, tspec, out, device="cpu")
    return out, tspec, tparams, feats, jparams


@pytest.mark.parametrize("arch", ["s2vt-att", "transformer", "rationale"])
def test_sampling_artifact_equals_live_call(arch, tmp_path):
    """Sampling (RationaleNet: selection, then sampling) under the draw plan:
    the loader draws what the live call draws, from the same seed."""
    _, _, tspec, tparams, feats = _models(arch)
    kw = dict(sample_temperature=0.8, sample_top_k=5, rng=7)
    out = texport.export_captioner(tparams, tspec, str(tmp_path / "a"), device="cpu", **kw)
    art = texport.load_artifact(out, device="cpu")
    plan = art.meta["draws"]["plan"]
    assert [p["input"] for p in plan] == (["select"] if arch == "rationale" else []) + [
        "steps"]
    assert plan[-1]["steps"] == tspec.max_len and art.meta["draws"]["seed"] == 7
    live = serving.build_captioner(tparams, tspec, device="cpu", **kw)
    for b in (1, N):
        assert torch.equal(art(feats[:b]), live(feats[:b]))


def test_symbolic_batch_and_fixed_batch(s2vt_art, tmp_path):
    out, tspec, tparams, feats, _ = s2vt_art
    art = texport.load_artifact(out, device="cpu")
    live = serving.build_captioner(tparams, tspec, device="cpu")
    x = np.random.default_rng(9).standard_normal((8,) + feats.shape[1:]).astype(np.float32)
    for b in (1, 3, 8):
        assert torch.equal(art(x[:b]), live(x[:b]))
    assert art.meta["batch"] == "symbolic"
    fixed = texport.load_artifact(texport.export_captioner(
        tparams, tspec, str(tmp_path / "fixed"), batch_size=3, device="cpu"), device="cpu")
    assert fixed.meta["batch"] == 3
    assert torch.equal(fixed(x[:3]), live(x[:3]))
    with pytest.raises(ValueError, match="fixed batch 3"):
        fixed(x[:4])


def test_input_validation(s2vt_art):
    art = texport.load_artifact(s2vt_art[0], device="cpu")
    with pytest.raises(ValueError, match="per-item signature"):
        art(np.zeros((2, 4, 11), np.float32))
    with pytest.raises(ValueError, match="per-item signature"):
        art(np.zeros((2, 5, 12), np.float32))


def test_bf16_leaf_round_trip(tmp_path):
    leaves = [torch.randn(3, 4).bfloat16(), torch.arange(5, dtype=torch.int8),
              torch.randn(2)]
    path = str(tmp_path / "w.npz")
    texport._save_leaves(path, leaves)
    with np.load(path) as w:
        assert [w[k].dtype for k in sorted(w.files)] == [np.float32, np.int8, np.float32]
    back = texport._load_leaves(path, [texport.dtype_name(t.dtype) for t in leaves], "cpu")
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(back, leaves))
    # a tree with bf16 leaves exports and serves as the live call
    _, _, tspec, tparams, feats = _models("s2vt", compute_dtype="bfloat16")
    tparams = dict(tparams, linear={k: v.bfloat16() for k, v in tparams["linear"].items()})
    art = texport.load_artifact(texport.export_captioner(
        tparams, tspec, str(tmp_path / "bf16"), device="cpu"), device="cpu")
    assert "bfloat16" in art.meta["leaf_dtypes"]
    assert torch.equal(art(feats), serving.build_captioner(tparams, tspec,
                                                           device="cpu")(feats))


def test_int8_weight_tree_differs_from_jax_by_the_codes(tmp_path):
    """Under int8 decode weights the port exports the tree build_captioner
    serves: the Transformer's decoder denses replaced by their codes and
    scales (w -> wq, ws), where JAX's artifact keeps the float32 weights
    and quantizes inside its program."""
    jspec, jparams, tspec, tparams, feats = _models("transformer")
    tdir = texport.export_captioner(tparams, tspec, str(tmp_path / "port"),
                                    decode_weights="int8", device="cpu")
    with open(os.path.join(tdir, "meta.json")) as f:
        tpaths = set(json.load(f)["leaf_paths"])
    jpaths = {"/".join(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    only_port, only_jax = tpaths - jpaths, jpaths - tpaths
    assert only_port and {p.rsplit("/", 1)[1] for p in only_port} == {"wq", "ws"}
    assert {p.rsplit("/", 1)[1] for p in only_jax} == {"w"}
    assert {p.rsplit("/", 1)[0] for p in only_port} == {p.rsplit("/", 1)[0]
                                                         for p in only_jax}
    assert all(p.startswith("decoder/") for p in only_port)
    art = texport.load_artifact(tdir, device="cpu")
    live = serving.build_captioner(tparams, tspec, decode_weights="int8", device="cpu")
    assert torch.equal(art(feats), live(feats))


_HOST = """
import json, sys
import numpy as np
import torch
import vcr_tpu_torch.ops.library
from vcr_tpu_torch.export_serving import load_artifact
art = load_artifact(sys.argv[1], device="cpu")
tokens = art(np.load(sys.argv[2]))
print(json.dumps({"tokens": tokens.tolist(),
                  "modules": sorted(m for m in sys.modules if m.startswith("vcr_tpu"))}))
"""


def test_fresh_interpreter_loads_with_no_model_code(s2vt_art, tmp_path):
    out, tspec, tparams, feats, _ = s2vt_art
    np.save(tmp_path / "feats.npy", feats)
    res = subprocess.run([sys.executable, "-c", _HOST, out, str(tmp_path / "feats.npy")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    mods = got["modules"]
    assert not [m for m in mods if m.startswith("vcr_tpu.") or m == "vcr_tpu"]
    for name in ("models", "decode", "serving", "serving_continuous", "entry"):
        assert not [m for m in mods if m.startswith(f"vcr_tpu_torch.{name}")], name
    want = serving.build_captioner(tparams, tspec, device="cpu")(feats)
    assert got["tokens"] == want.tolist()


def test_cli_export_serving_equals_decode(tmp_path):
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"))
    argv = ["--data_dir", os.path.join(tmp, "data"), "--corpus", "msvd_vgg",
            "--glove_emb_file", "glove_tiny.txt", "--num_frames", "4",
            "--vid_feat_size", "12", "--max_len", "6", "--hidden_size", "8",
            "--bsize", "4", "--save_path", os.path.join(tmp, "models"), "--log_dir", "",
            "--seed", "123", "--compute_dtype", "float32", "--device", "cpu",
            "--nworkers", "1"]
    cli.main(["--mode", "train", "--epochs", "1", "--lr", "1e-2", *argv])
    out = cli.main(["--mode", "export_serving", *argv])
    assert out == os.path.join(tmp, "models", "serving_artifact")
    decoded = cli.main(["--mode", "decode", *argv])
    cfg, _ = get_config(["--mode", "decode", *argv])
    cfg, _, spec, vocab = ttools.load_inference_state(cfg, device="cpu")
    feats, keys = ttools.load_split_features(cfg, vocab)
    tokens = texport.load_artifact(out, device="cpu")(feats)
    assert [r["vid_key"] for r in decoded] == keys
    assert [r["tokens"] for r in decoded] == tokens.tolist()


def test_refusals(s2vt_art, tmp_path):
    out, tspec, tparams, feats, jparams = s2vt_art
    # the fused featurizers are ported (A17): a backbone without its weights,
    # or weights without a backbone, raises
    with pytest.raises(ValueError, match="needs feat_params"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "a"), featurizer="vgg16",
                                 device="cpu")
    with pytest.raises(ValueError, match="featurizer='none'"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "a"), feat_params={},
                                 device="cpu")
    # the dp artifact is ported (tests/test_torch_mesh_cli.py): a fixed batch
    # that dp does not divide raises
    with pytest.raises(ValueError, match="not divisible by dp"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "a"), dp=2, batch_size=3,
                                 device="cpu")
    # a JAX artifact, and a meta without this package's runtime
    jspec = graft._make_spec_and_params(**DIMS, arch="s2vt", compute_dtype="float32",
                                        vocab_pad_to=8)[0]
    jdir = jexport.export_captioner(jparams, jspec, str(tmp_path / "jax"),
                                    platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX package"):
        texport.load_artifact(jdir, device="cpu")
    os.remove(os.path.join(jdir, jexport.GRAPH_FILE))
    with pytest.raises(ValueError, match="JAX package"):
        texport.load_artifact(jdir, device="cpu")
    # another kind, other kernel sources
    meta_path = os.path.join(out, texport.META_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    try:
        with open(meta_path, "w") as f:
            json.dump(dict(meta, kind="continuous"), f)
        with pytest.raises(ValueError, match="load_continuous"):
            texport.load_artifact(out, device="cpu")
        with open(meta_path, "w") as f:
            json.dump(dict(meta, kernel_sources={"gru_seq": "0" * 16}), f)
        with pytest.raises(ValueError, match="re-export"):
            texport.load_artifact(out, device="cpu")
    finally:
        with open(meta_path, "w") as f:
            json.dump(meta, f)


def test_failed_symbolic_export_advises_a_fixed_batch(s2vt_art, tmp_path, monkeypatch):
    _, tspec, tparams, _, _ = s2vt_art

    def refuse(*args, dynamic_shapes=None, **kw):
        raise RuntimeError("cannot trace")
    monkeypatch.setattr(torch.export, "export", refuse)
    with pytest.raises(RuntimeError, match="retry with an explicit batch_size"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "a"), device="cpu")
    with pytest.raises(RuntimeError, match="^cannot trace$"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "a"), batch_size=2,
                                 device="cpu")
