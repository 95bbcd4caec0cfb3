"""The port's frozen continuous-batching pool (``vcr_tpu_torch/export_continuous.py``),
the counterpart of ``tests/test_export_continuous.py``, on the CPU at
slots=3, admit_chunk=2, step_chunk=2: the artifact's tokens equal the live
pool's (``serving_continuous.ContinuousCaptioner``) for S2VT, the
Transformer and RationaleNet, the beam pools of S2VT and the Transformer
(lineage), and the int8-weight pool; the artifact behind ``CaptionServer``
and ``MultiCaptionServer``; the three programs driven by hand from a fresh
interpreter; admission chunks with invalid rows and with slot 0 among the
valid ones leave the other slots untouched; ``--mode export_continuous``
then ``--mode serve`` on its directory; and the refusals."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcr_tpu_torch import entry
from vcr_tpu_torch import export_continuous as tec
from vcr_tpu_torch import tools as ttools
from vcr_tpu_torch.client import CaptionClient
from vcr_tpu_torch.config import get_config
from vcr_tpu_torch.multiserver import MultiCaptionServer
from vcr_tpu_torch.server import CaptionServer
from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=12, max_len=6,
            num_frames=4)
POOL = dict(slots=3, admit_chunk=2, step_chunk=2)
N_REQ = 7
TIMEOUT = 60


def _model(arch):
    kw = dict(arch=arch, compute_dtype="float32", vocab_pad_to=8)
    if arch == "rationale":
        kw["base_arch"] = "s2vt"
    if arch == "transformer":
        kw.update(tf_layers=1, tf_heads=2)
    return entry.make_spec_and_params(**DIMS, device="cpu", **kw)


def _requests(seed=4):
    rng = np.random.default_rng(seed)
    return {i: rng.standard_normal((DIMS["num_frames"], DIMS["vid_feat"])).astype(
        np.float32) for i in range(N_REQ)}


def _frozen_and_live(tmp_path, arch, **kw):
    spec, params = _model(arch)
    out = tec.export_continuous(params, spec, str(tmp_path / arch), seed=5, device="cpu",
                                **POOL, **kw)
    live = ContinuousCaptioner(params, spec, rng=5, device="cpu", **POOL, **kw)
    return tec.load_continuous(out, device="cpu"), live, out


@pytest.fixture(scope="module")
def s2vt_pool(tmp_path_factory):
    """One frozen S2VT pool, shared by the tests of the protocol."""
    spec, params = _model("s2vt")
    out = str(tmp_path_factory.mktemp("pool") / "s2vt")
    tec.export_continuous(params, spec, out, device="cpu", **POOL)
    return out, spec, params


@pytest.mark.parametrize("arch, kw", [
    pytest.param("s2vt", {}, id="s2vt"),
    pytest.param("transformer", {}, id="transformer"),
    pytest.param("rationale", {}, id="rationale"),
    pytest.param("s2vt", {"beam_size": 3}, id="s2vt-beam3"),
    pytest.param("transformer", {"beam_size": 3}, id="transformer-lineage-beam3"),
    pytest.param("s2vt", {"decode_weights": "int8"}, id="s2vt-int8-weights"),
])
def test_artifact_equals_live_pool(tmp_path, arch, kw):
    frozen, live, _ = _frozen_and_live(tmp_path, arch, **kw)
    reqs = _requests()
    got, want = frozen.caption_all(reqs), live.caption_all(reqs)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in reqs)
    assert frozen.stats["admit_chunks"] == live.stats["admit_chunks"] >= 4
    assert frozen.meta["bookkeeping_leaf_indices"].keys() == {"active", "steps", "toks"}
    if arch == "rationale":
        assert frozen.meta["select_noise"] == [POOL["admit_chunk"], DIMS["num_frames"], 2]


def test_select_noise_is_the_live_pools(tmp_path):
    """The frame-selection noise the frozen RationaleNet pool draws for an
    admission is the live pool's, from the same seed."""
    frozen, live, _ = _frozen_and_live(tmp_path, "rationale")
    shape = (POOL["admit_chunk"], DIMS["num_frames"], 2)
    for admit in (1, 2, 7):
        (got,) = frozen.select_noise(admit)
        assert torch.equal(got, live._select_noise_for(admit, shape))
    assert not torch.equal(frozen.select_noise(1)[0], frozen.select_noise(2)[0])


def _state_rows(state, paths, slots):
    """{path: the leaf's rows per slot} of the slot-indexed leaves."""
    out = {}
    for path, leaf in zip(paths, state):
        k = leaf.shape[0] // (slots + 1)
        out[path] = leaf.reshape(slots + 1, k, *leaf.shape[1:]).clone()
    return out


@pytest.mark.parametrize("valid, ids", [
    pytest.param([True, False], [1, 0], id="invalid-row-padded-to-slot-0"),
    pytest.param([False, True], [0, 0], id="slot-0-valid-beside-a-padded-row"),
])
def test_admission_leaves_other_slots_untouched(s2vt_pool, valid, ids):
    """The scheduler pads a chunk's invalid rows with id 0: they go to the
    sink slot, so slot 0 keeps its state, or takes only its own request."""
    out, spec, params = s2vt_pool
    frozen = tec.load_continuous(out, device="cpu")
    live = ContinuousCaptioner(params, spec, device="cpu", **POOL)
    paths = frozen.meta["state_leaf_paths"]
    feats = np.random.default_rng(1).standard_normal(
        (POOL["admit_chunk"], DIMS["num_frames"], DIMS["vid_feat"])).astype(np.float32)
    # occupy every slot, then admit the test chunk
    frozen.encode_admit(feats, np.array([0, 1]), np.array([True, True]))
    frozen.encode_admit(feats[::-1].copy(), np.array([2, 0]), np.array([True, False]))
    before = _state_rows(frozen._state, paths, POOL["slots"])
    frozen.encode_admit(feats, np.array(ids), np.array(valid))
    after = _state_rows(frozen._state, paths, POOL["slots"])
    admitted = {i for i, v in zip(ids, valid) if v}
    for path in paths:
        for slot in range(POOL["slots"]):
            same = torch.equal(after[path][slot], before[path][slot])
            assert same or slot in admitted, (path, slot)
    # the live pool's admit, on the same chunks, writes the same state
    for f, i, v in ((feats, [0, 1], [True, True]), (feats[::-1].copy(), [2, 0],
                                                    [True, False]), (feats, ids, valid)):
        live.encode_admit(f, np.array(i), np.array(v))
    from vcr_tpu_torch.export_serving import flatten_tree
    live_leaves, _ = flatten_tree(live.state)
    live_rows = _state_rows(live_leaves, paths, POOL["slots"])
    for path in paths:
        assert torch.equal(live_rows[path][:POOL["slots"]], after[path][:POOL["slots"]])


def test_behind_caption_server_and_multiserver(s2vt_pool):
    out, spec, params = s2vt_pool
    reqs = _requests(6)
    want = ContinuousCaptioner(params, spec, device="cpu", **POOL).caption_all(reqs)
    with CaptionServer(tec.load_continuous(out, device="cpu"), port=0) as server:
        client = CaptionClient(f"http://127.0.0.1:{server.port}", timeout_s=TIMEOUT,
                               retries=0)
        for k in (0, 1, 2):
            tokens, _ = client.caption(reqs[k])
            assert tokens == want[k].tolist()
        with pytest.raises(Exception, match="400|expected"):
            client.caption(np.zeros((3, 3), np.float32))
    multi = MultiCaptionServer({"frozen": (tec.load_continuous(out, device="cpu"), None)},
                               port=0)
    with multi:
        client = CaptionClient(f"http://127.0.0.1:{multi.port}", timeout_s=TIMEOUT,
                               retries=0)
        models = client.models()
        assert models["frozen"]["arch"] == "s2vt" and models["frozen"]["slots"] == 3
        client.model = "frozen"
        tokens, _ = client.caption(reqs[3])
        assert tokens == want[3].tolist()


_BY_HAND = """
import json, sys
import numpy as np
import torch
import vcr_tpu_torch.ops.library
from torch.export.passes import move_to_device_pass
art = sys.argv[1]
meta = json.load(open(art + "/meta.json"))
progs = {n: move_to_device_pass(torch.export.load(f"{art}/{n}_fn.pt2"), "cpu").module()
         for n in ("encode", "admit", "step")}
def leaves(name, dtypes):
    w = np.load(f"{art}/{name}")
    return [torch.from_numpy(w[k]).to(getattr(torch, d))
            for k, d in zip(sorted(w.files), dtypes)]
weights = leaves("weights.npz", meta["weight_leaf_dtypes"])
state = leaves("state0.npz", meta["state_leaf_dtypes"])
feats = torch.from_numpy(np.load(sys.argv[2]))
book = meta["bookkeeping_leaf_indices"]
with torch.no_grad():
    new = progs["encode"](weights, feats, [])
    state = progs["admit"](state, new, torch.tensor([0, 1]), torch.tensor([True, True]))
    while bool(state[book["active"]][:meta["slots"]].any()):
        state = progs["step"](weights, state)
toks, steps = state[book["toks"]], state[book["steps"]]
print(json.dumps({"tokens": [toks[i, :steps[i]].tolist() for i in range(2)],
                  "modules": sorted(m for m in sys.modules if m.startswith("vcr_tpu"))}))
"""


def test_three_programs_by_hand_in_a_fresh_interpreter(s2vt_pool, tmp_path):
    out, spec, params = s2vt_pool
    reqs = _requests(8)
    np.save(tmp_path / "feats.npy", np.stack([reqs[0], reqs[1]]))
    res = subprocess.run([sys.executable, "-c", _BY_HAND, out, str(tmp_path / "feats.npy")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("models", "decode", "serving", "serving_continuous", "export"):
        assert not [m for m in got["modules"] if m.startswith(f"vcr_tpu_torch.{name}")]
    assert not [m for m in got["modules"] if m.split(".")[0] == "vcr_tpu"]
    want = ContinuousCaptioner(params, spec, device="cpu", **POOL).caption_all(
        {0: reqs[0], 1: reqs[1]})
    assert got["tokens"] == [want[0].tolist(), want[1].tolist()]


def test_cli_export_continuous_then_serve(tmp_path, monkeypatch):
    sys.path.insert(0, os.path.dirname(__file__))
    from util_corpus import build_corpus

    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"))
    argv = ["--data_dir", os.path.join(tmp, "data"), "--corpus", "msvd_vgg",
            "--glove_emb_file", "glove_tiny.txt", "--num_frames", "4",
            "--vid_feat_size", "12", "--max_len", "6", "--hidden_size", "8",
            "--bsize", "4", "--save_path", os.path.join(tmp, "models"), "--log_dir", "",
            "--seed", "123", "--compute_dtype", "float32", "--device", "cpu",
            "--nworkers", "1", "--serve_slots", "2", "--serve_admit_chunk", "1"]
    from vcr_tpu_torch import cli

    cli.main(["--mode", "train", "--epochs", "1", "--lr", "1e-2", *argv])
    out = cli.main(["--mode", "export_continuous", *argv])
    assert out == os.path.join(tmp, "models", "continuous_artifact")
    assert "id_to_word" in tec.load_continuous(out, device="cpu").meta
    serve = ttools.serve_captions
    monkeypatch.setattr(ttools, "serve_captions",
                        lambda *a, **k: serve(*a, **dict(k, block=False)))
    server = cli.main(["--mode", "serve", "--pretrained_base", out, "--serve_port", "0",
                       "--device", "cpu"])
    try:
        assert isinstance(server.captioner, tec.ContinuousArtifact)
        feats = np.random.default_rng(2).standard_normal((4, 12)).astype(np.float32)
        tokens, caption = CaptionClient(f"http://127.0.0.1:{server.port}",
                                        timeout_s=TIMEOUT, retries=0).caption(feats)
        cfg, _ = get_config(["--mode", "decode", *argv])
        _, params, spec, vocab = ttools.load_inference_state(cfg, device="cpu")
        want = ContinuousCaptioner(params, spec, slots=2, admit_chunk=1, vocab=vocab,
                                   device="cpu").caption_all({0: feats})[0]
        assert tokens == want.tolist() and caption == vocab.get_sent_from_index(tokens)
    finally:
        server.close()


def test_refusals(s2vt_pool, tmp_path):
    out, spec, params = s2vt_pool
    from vcr_tpu_torch.export_serving import load_artifact

    with pytest.raises(ValueError, match="load_continuous"):
        load_artifact(out, device="cpu")
    jax_dir = tmp_path / "jax_pool"
    jax_dir.mkdir()
    (jax_dir / "meta.json").write_text(json.dumps({"kind": "continuous",
                                                   "format_version": 1}))
    with pytest.raises(ValueError, match="JAX package"):
        tec.load_continuous(str(jax_dir), device="cpu")
    (jax_dir / "step_fn.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="JAX package"):
        tec.load_continuous(str(jax_dir), device="cpu")
    cfg, _ = get_config(["--mode", "export_continuous", "--sample_temperature", "0.7",
                         "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="live-pool only"):
        ttools.export_continuous_artifact(cfg, device="cpu")
