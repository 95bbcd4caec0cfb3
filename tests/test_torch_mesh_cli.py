"""Multi-device decode, serve and export of the port on the CPU.

* ``--mode decode --mesh_dp 2`` and ``--mesh_mp 2`` through
  ``python -m vcr_tpu_torch.parallel.launch --nproc 2``: ``captions.json``
  equals the one-process port's and the JAX package's
  ``decode_corpus(mesh_dp=4, mesh_mp=2)`` on the same checkpoint; beam 3
  and sampling at dp=2 and mp=2 (two processes calling
  ``tools.decode_corpus``) equal one process's.
* ``--mode serve --mesh_dp 2`` through the launcher: POSTs answered with
  the one-process daemon's tokens, and a SIGTERM that ends both ranks
  with 0.
* The dp=2 artifact on ``["cpu", "cpu"]``: tokens equal to the JAX
  package's dp=8 artifact, its live captioner and the port's dp=1 artifact;
  RationaleNet's dp=2 artifacts (selection, and selection then sampling)
  equal dp=1's, since the draws are the whole batch's sliced by rows;
  ``--mode export_serving --mesh_dp 2``; the "batch % dp" and "needs 2
  devices" errors.

The JAX package trains the checkpoint; the port's is the same weights.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
from vcr_tpu import config as jconfig
from vcr_tpu import export_serving as jexport
from vcr_tpu import tools as jtools
from vcr_tpu.serving import build_captioner as jbuild_captioner
from vcr_tpu.train import loop as jloop
from vcr_tpu_torch import bridge, cli, entry
from vcr_tpu_torch import config as tconfig
from vcr_tpu_torch import export_serving as texport
from vcr_tpu_torch import tools as ttools
from vcr_tpu_torch.client import CaptionClient
from vcr_tpu_torch.parallel.launch import free_port
from vcr_tpu_torch.train import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240

DECODE_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank)
from vcr_tpu_torch import config, tools
flags = json.loads(sys.argv[4])
res = {{}}
for name, dp, mp, beam, temp in [("beam3_dp2", 2, 1, 3, 0.0), ("beam3_mp2", 1, 2, 3, 0.0),
                                 ("sample_dp2", 2, 1, 1, 0.8),
                                 ("sample_mp2", 1, 2, 1, 0.8)]:
    cfg = config.Config(**dict(flags, mode="decode", mesh_dp=dp, mesh_mp=mp,
                               sample_temperature=temp, sample_top_p=0.9 if temp else 0.0))
    res[name] = [r["tokens"] for r in tools.decode_corpus(cfg, flags["pretrained_base"],
                                                          beam_size=beam, device="cpu")]
with open(os.path.join(out, "decode%d.json" % rank), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _flags(tmp, **kw):
    d = dict(mode="train", data_dir=os.path.join(tmp, "data"), corpus="msvd_vgg",
             nworkers=0, bsize=2, glove_emb_file="glove_tiny.txt", num_frames=4,
             vid_feat_size=12, arch="s2vt", max_len=6, dropout_p=0.0, hidden_size=16,
             epochs=1, lr=1e-2, log_iter=1, save_path=os.path.join(tmp, "jax_models"),
             log_dir="", seed=123, compute_dtype="float32", vocab_pad_to=8)
    d.update(kw)
    return d


def _argv(flags):
    return [x for k, v in flags.items() for x in (f"--{k}", str(v))] + ["--device", "cpu"]


def _launch(args, **kw):
    return subprocess.Popen([sys.executable, "-u", "-m", "vcr_tpu_torch.parallel.launch",
                             "--nproc", "2", "--port", str(free_port()), "--timeout_s", "60",
                             "--", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package trains S2VT one epoch; the port's checkpoint holds its
    weights. -> (tmp, decode flags, JAX's mesh decode tokens)."""
    tmp = str(tmp_path_factory.mktemp("mesh_cli"))
    build_corpus(os.path.join(tmp, "data"))
    flags = _flags(tmp)
    jcfg = jconfig.Config(**flags)
    jloop.train(jcfg)
    _, jparams, _, _ = jtools.load_inference_state(jcfg)
    params = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    ckpt = os.path.join(tmp, "port", "model_best")
    tckpt.save_checkpoint(ckpt, params, {}, {
        "config": tconfig.Config(**dict(flags, save_path=os.path.dirname(ckpt))).to_dict(),
        "n_iter": 0, "epoch": 0})
    want = jtools.decode_corpus(jcfg.replace(mode="decode", mesh_dp=4, mesh_mp=2))
    io = {k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "bsize")}
    return tmp, dict(io, pretrained_base=ckpt), [r["tokens"] for r in want]


def test_decode_over_a_mesh(trained):
    """Greedy through the launcher at dp=2 (chunks of 2, the last padded) and
    mp=2; beam 3 and sampling at dp=2 and mp=2 in two processes."""
    tmp, io, jax_mesh = trained
    runs = {}
    for name, flags in (("dp2", ["--mesh_dp", "2"]), ("mp2", ["--mesh_mp", "2"])):
        save = os.path.join(tmp, name)
        runs[name] = (save, _launch(["--mode", "decode", *_argv(dict(io, save_path=save)),
                                     *flags]))
    path = os.path.join(tmp, "decode_worker.py")
    with open(path, "w") as f:
        f.write(DECODE_WORKER.format(repo=ROOT))
    port = str(free_port())
    workers = [subprocess.Popen([sys.executable, path, str(r), port, tmp, json.dumps(io)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for r in range(2)]
    one = ttools.decode_corpus(tconfig.Config(**dict(io, mode="decode")),
                               io["pretrained_base"], device="cpu")
    variants = {}
    for beam, temp in ((3, 0.0), (1, 0.8)):
        cfg = tconfig.Config(**dict(io, mode="decode", sample_temperature=temp,
                                    sample_top_p=0.9 if temp else 0.0))
        variants[(beam, temp)] = [r["tokens"] for r in ttools.decode_corpus(
            cfg, io["pretrained_base"], beam_size=beam, device="cpu")]
    for name, (save, proc) in runs.items():
        out = proc.communicate(timeout=TIMEOUT)[0]
        assert proc.returncode == 0, f"{name}:\n{out[-4000:]}"
        with open(os.path.join(save, "captions.json")) as f:
            got = json.load(f)
        assert got == one, name
        assert [r["tokens"] for r in got] == jax_mesh, name
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in workers]
    for r, (p, out) in enumerate(zip(workers, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"decode{r}.json")) as f:
            ranks.append(json.load(f))
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert got["beam3_dp2"] == got["beam3_mp2"] == variants[(3, 0.0)]
    assert got["sample_dp2"] == got["sample_mp2"] == variants[(1, 0.8)]


def test_serve_over_a_mesh(trained):
    """Two ranks behind one daemon: the captions of the one-process daemon
    (the batch greedy cut at eos), then SIGTERM ends both with 0."""
    tmp, io, _ = trained
    feats = np.random.default_rng(0).standard_normal((5, 4, 12)).astype(np.float32)
    cfg = tconfig.Config(**dict(io, mode="decode"))
    _, params, spec, vocab = ttools.load_inference_state(cfg, io["pretrained_base"], "cpu")
    want = ttools.decode_features(params, spec, vocab.eos_id, feats, 5, device="cpu")
    proc = _launch(["--mode", "serve", "--mesh_dp", "2", "--serve_port", "0",
                    "--serve_slots", "4", "--serve_admit_chunk", "2",
                    *_argv(dict(io, save_path=os.path.join(tmp, "serve")))])
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                break
        assert "over dp=2 processes" in lines[-1], "".join(lines)
        url = lines[-1].split(" on ")[1].split()[0]
        client = CaptionClient(url, timeout_s=TIMEOUT, retries=0)
        for f, row in zip(feats, want):
            row = list(row)
            tokens, _ = client.caption(f)
            assert tokens == (row[: row.index(vocab.eos_id) + 1] if vocab.eos_id in row
                              else row)
        assert client.health()["served"] == len(feats)
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()     # the rest, after what the loop above read ahead
        assert proc.wait(TIMEOUT) == 0, "".join(lines) + out
        assert "following rank 0" in "".join(lines) + out
    finally:
        proc.kill()
        proc.wait(TIMEOUT)


def _models(arch):
    dims = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=12, max_len=6,
                num_frames=4)
    kw = dict(arch=arch, compute_dtype="float32", vocab_pad_to=8)
    if arch == "rationale":
        kw["base_arch"] = "s2vt"
    jspec, jparams = graft._make_spec_and_params(**dims, **kw)
    tspec, _ = entry.make_spec_and_params(**dims, device="cpu", **kw)
    return jspec, jparams, tspec, bridge.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def s2vt_references(tmp_path_factory):
    """S2VT's weights on both sides, with what a dp artifact is held
    against: the port's dp=1 artifact, the JAX package's dp=8 artifact and
    its live captioner."""
    tmp = tmp_path_factory.mktemp("s2vt_references")
    jspec, jparams, tspec, tparams = _models("s2vt")
    one = texport.load_artifact(texport.export_captioner(
        tparams, tspec, str(tmp / "dp1"), device="cpu"), device="cpu")
    jart = jexport.load_artifact(jexport.export_captioner(
        jparams, jspec, str(tmp / "jax"), dp=8, platforms=("cpu",)))
    live = jbuild_captioner(jparams, jspec, "none")
    return tspec, tparams, one, jart, live


def test_dp_artifact(tmp_path, trained, s2vt_references):
    """The dp=2 artifact on two CPU devices against the JAX package's dp=8
    artifact and live captioner, and the port's dp=1 artifact."""
    tspec, tparams, one, jart, live = s2vt_references
    out = texport.export_captioner(tparams, tspec, str(tmp_path / "dp2"), dp=2,
                                   device="cpu")
    art = texport.load_artifact(out, devices=["cpu", "cpu"])
    assert art.meta["dp"] == art.meta["nr_devices"] == 2
    r = np.random.default_rng(2)
    for b in (8, 16):
        feats = r.standard_normal((b, 4, 12)).astype(np.float32)
        got = art(feats).numpy()
        np.testing.assert_array_equal(got, one(feats).numpy())
        np.testing.assert_array_equal(got, np.asarray(jart.caption(feats)))
        np.testing.assert_array_equal(got, np.asarray(live(jnp.asarray(feats))))
    with pytest.raises(ValueError, match="batch % dp"):
        art(r.standard_normal((3, 4, 12)).astype(np.float32))
    with pytest.raises(ValueError, match="needs 2 devices"):
        texport.load_artifact(out, devices=["cpu"])

    # the command line: --mode export_serving --mesh_dp 2 on the checkpoint
    tmp, io, _ = trained
    save = str(tmp_path / "cli")
    cli.main(["--mode", "export_serving", "--mesh_dp", "2",
              *_argv(dict(io, save_path=save))])
    cli_art = texport.load_artifact(os.path.join(save, "serving_artifact"),
                                    devices=["cpu", "cpu"])
    assert cli_art.meta["dp"] == 2
    cfg = tconfig.Config(**dict(io, mode="decode"))
    cfg, params, spec, vocab = ttools.load_inference_state(cfg, io["pretrained_base"], "cpu")
    feats, _ = ttools.load_split_features(cfg, vocab)
    feats = np.concatenate([feats, feats[:1]])          # 4 rows: a multiple of dp
    np.testing.assert_array_equal(
        cli_art(feats).numpy(),
        ttools.decode_features(params, spec, vocab.eos_id, feats, 4, device="cpu"))


def test_dp_artifact_fixed_batch(tmp_path, s2vt_references):
    """A dp=2 artifact exported at a fixed global batch of 8: each device
    runs its 4 rows, and the tokens equal the dp=1 artifact's, the JAX
    package's dp=8 artifact's (8 is the smallest batch it takes) and its
    live captioner's; another batch is refused."""
    tspec, tparams, one, jart, live = s2vt_references
    art = texport.load_artifact(texport.export_captioner(
        tparams, tspec, str(tmp_path / "dp2"), dp=2, batch_size=8, device="cpu"),
        devices=["cpu", "cpu"])
    assert art.meta["batch"] == 8 and art.meta["dp"] == 2
    r = np.random.default_rng(4)
    feats = r.standard_normal((8, 4, 12)).astype(np.float32)
    got = art(feats).numpy()
    assert got.shape[0] == 8
    np.testing.assert_array_equal(got, one(feats).numpy())
    np.testing.assert_array_equal(got, np.asarray(jart.caption(feats)))
    np.testing.assert_array_equal(got, np.asarray(live(jnp.asarray(feats))))
    with pytest.raises(ValueError, match="fixed batch 8"):
        art(r.standard_normal((4, 4, 12)).astype(np.float32))
    with pytest.raises(ValueError, match="not divisible by dp"):
        texport.export_captioner(tparams, tspec, str(tmp_path / "bad"), dp=2,
                                 batch_size=5, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_dp_artifact_slices_the_draws(tmp_path, temperature):
    """RationaleNet draws its frame selection ((B, N, 2), batch first) and,
    when sampling, a stack of per-step draws ((L, B, V), batch second):
    drawn for the whole batch and sliced by rows on each entry's batch axis,
    the dp=2 artifact's tokens equal dp=1's."""
    _, _, tspec, tparams = _models("rationale")
    kw = dict(rng=3, sample_temperature=temperature, sample_top_k=5 if temperature else 0)
    one = texport.export_captioner(tparams, tspec, str(tmp_path / "dp1"), device="cpu", **kw)
    # a dp artifact holds the dp=1 program (test_dp_artifact exports one): a
    # copy whose meta says dp=2 is one, without a second trace
    two = str(tmp_path / "dp2")
    shutil.copytree(one, two)
    meta_path = os.path.join(two, texport.META_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump(dict(meta, dp=2, nr_devices=2), f)
    arts = [texport.load_artifact(d, devices=["cpu"] * dp) for d, dp in ((one, 1), (two, 2))]
    plan = arts[1].meta["draws"]["plan"]
    assert [e["input"] for e in plan] == ["select"] + (["steps"] if temperature else [])
    feats = np.random.default_rng(6).standard_normal((6, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(arts[1](feats).numpy(), arts[0](feats).numpy())
