"""The port's training loop, checkpoints, eval, decode and command line on the
tiny corpus of ``tests/util_corpus.py``, on the CPU: two epochs trained in
both packages from one set of JAX-initialised weights at float32, with
validation by beam search, then the eval and decode modes of both; mid-epoch
resume bit for bit; the crash-atomic checkpoint swap; preemption; and the
refusals of what is not ported."""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from vcr_tpu import config as jconfig
from vcr_tpu import tools as jtools
from vcr_tpu import vocab as jvocab
from vcr_tpu.models import base as jbase
from vcr_tpu.train import loop as jloop
from vcr_tpu.utils import logging as jlogging
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch import config as tconfig
from vcr_tpu_torch import tools as ttools
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.train import optim as toptim
from vcr_tpu_torch.train import step as tstep
from vcr_tpu_torch.utils import logging as tlogging

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5      # float32 losses after 4 Adam steps, sums in other orders
# caption metrics are functions of the tokens alone: equal tokens give equal
# values, so they are held to equality
CAPTION_METRICS = ("METEOR", "BLEU4", "CIDEr", "ROUGE_L", "EmbAverage", "VectorExtrema",
                   "GreedyMatching")


def _flags(tmp, save="models", **kw):
    d = dict(mode="train", data_dir=os.path.join(tmp, "data"), corpus="msvd_vgg",
             nworkers=2, bsize=4, glove_emb_file="glove_tiny.txt", num_frames=4,
             vid_feat_size=12, arch="s2vt", max_len=6, dropout_p=0.0, hidden_size=16,
             epochs=2, lr=1e-2, log_iter=1, save_path=os.path.join(tmp, save),
             log_dir="", seed=123, compute_dtype="float32", beam_size=3)
    d.update(kw)
    return d


def _argv(flags, device="cpu"):
    out = []
    for k, v in flags.items():
        out += [f"--{k}", str(v)]
    return out + ["--device", device]


def _jax_init_params(cfg):
    """The JAX loop's initial parameters (vcr_tpu/train/loop.py:258-261)."""
    vocab = jvocab.Vocab(os.path.join(cfg.data_dir, cfg.corpus, "glove",
                                      cfg.glove_emb_file), seed=cfg.seed)
    spec = jbase.spec_from_config(cfg, vocab)
    init_fn, _ = jbase.build_model(jloop.WORKLOADS[cfg.mode][0](cfg))
    params = init_fn(jax.random.fold_in(jax.random.key(cfg.seed, impl=cfg.rng_impl), 0),
                     spec, vocab.vectors)
    return jax.tree_util.tree_map(np.asarray, params)


class _Recorder:
    """Records each validation pass and each step's metrics of a loop."""

    def __init__(self, mp, loop_mod, logger_cls):
        self.evals, self.steps = [], []
        evaluate, update = loop_mod.evaluate, logger_cls.update

        def rec_evaluate(*args, **kw):
            out = evaluate(*args, **kw)
            self.evals.append(out[0])
            return out

        def rec_update(logger, metrics):
            self.steps.append({k: float(np.asarray(v)) for k, v in metrics.items()})
            return update(logger, metrics)

        mp.setattr(loop_mod, "evaluate", rec_evaluate)
        mp.setattr(logger_cls, "update", rec_update)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages train S2VT for 2 epochs on one corpus from the same
    initial weights (dropout 0, static teacher forcing, so nothing is drawn
    after init), validating with beam search of width 3."""
    tmp = str(tmp_path_factory.mktemp("loop"))
    build_corpus(os.path.join(tmp, "data"))
    flags = _flags(tmp)
    jcfg = jconfig.Config(**dict(flags, save_path=os.path.join(tmp, "jax_models")))
    init = _jax_init_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        jrec = _Recorder(mp, jloop, jlogging.TrainLogger)
        jfinal = jloop.train(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        trec = _Recorder(mp, tloop, tlogging.TrainLogger)
        mp.setattr(tloop, "init_params",
                   lambda cfg, spec, vocab, device: bridge.from_jax_params(init, device))
        tfinal = cli.main(_argv(flags))
    return dict(tmp=tmp, flags=flags, jcfg=jcfg, jrec=jrec, trec=trec, jfinal=jfinal,
                tfinal=tfinal)


def _assert_eval_equal(got, want):
    for k in CAPTION_METRICS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("acc", "loss"):
        assert abs(got[k] - want[k]) <= LOSS_TOL, (k, got[k], want[k])


def test_train_matches_jax(trained):
    jrec, trec = trained["jrec"], trained["trec"]
    assert len(trec.evals) == len(jrec.evals) == 2
    assert len(trec.steps) == len(jrec.steps) == 4
    for got, want in zip(trec.steps, jrec.steps):
        for k in ("loss", "acc"):
            assert abs(got[k] - want[k]) <= LOSS_TOL, (k, got[k], want[k])
    for got, want in zip(trec.evals, jrec.evals):
        _assert_eval_equal(got, want)
    # the validation actually captions (the tiny model emits words)
    assert trec.evals[-1]["METEOR"] > 0.0
    save = trained["flags"]["save_path"]
    for name in ("model_latest", "model_best"):
        meta = tckpt.peek_meta(os.path.join(save, name))
        assert meta["config"] == tconfig.Config(**trained["flags"]).to_dict()
    assert tckpt.peek_meta(tckpt.latest_path(save))["n_iter"] == 4
    assert trained["tfinal"]["perf/steps"] == 1.0


def test_eval_and_decode_match_jax(trained):
    flags, jcfg = trained["flags"], trained["jcfg"]
    io = {k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")}
    got = cli.main(_argv(dict(io, mode="eval")))
    want = jloop.evaluate_checkpoint(jconfig.Config(**dict(io, mode="eval",
                                                           save_path=jcfg.save_path)))
    _assert_eval_equal(got, want)
    decoded = {}
    for beam in (1, 3):
        tokens = decoded[beam] = cli.main(_argv(dict(io, mode="decode", beam_size=beam)))
        with open(os.path.join(flags["save_path"], "captions.json")) as f:
            assert json.load(f) == tokens
        jtokens = jtools.decode_corpus(
            jconfig.Config(**dict(io, mode="decode", save_path=jcfg.save_path)),
            beam_size=beam)
        assert tokens == jtokens
        assert len(tokens) == 3 and {r["vid_key"] for r in tokens} == {
            "val_vid0", "val_vid1", "val_vid2"}
    # greedy_captions is the greedy decode in chunks (here of 2: one padded)
    cfg, params, spec, vocab = ttools.load_inference_state(
        tconfig.Config(**dict(io, mode="decode")), device="cpu")
    feats, _ = ttools.load_split_features(cfg, vocab)
    caps = ttools.greedy_captions(params, spec, vocab, feats, batch_size=2, device="cpu")
    assert [c["tokens"] for c in caps] == [r["tokens"] for r in decoded[1]]


def test_sampling_decode_and_rationale_warm_start(trained, monkeypatch):
    """Sampled captions are deterministic per seed; RationaleNet's caption
    net starts as the S2VT checkpoint's parameters, leaf for leaf, then
    trains and decodes by beam search."""
    tmp, flags = trained["tmp"], trained["flags"]
    io = {k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")}
    a = cli.main(_argv(dict(io, mode="decode", sample_temperature=0.8, sample_top_p=0.9)))
    b = cli.main(_argv(dict(io, mode="decode", sample_temperature=0.8, sample_top_p=0.9)))
    assert a == b and all(len(r["tokens"]) == flags["max_len"] for r in a)
    base = os.path.join(flags["save_path"], "model_best")
    rflags = _flags(tmp, save="rationale", mode="train_rationale", epochs=1,
                    pretrained_base=base, beam_size=2)
    restore, restored = tckpt.restore_into, []

    def recording(params, saved):
        # recursive: the outermost call, the warm start's, is recorded last
        restore(params, saved)
        restored.append(jax.tree_util.tree_map(torch.clone, params))

    monkeypatch.setattr(tckpt, "restore_into", recording)
    metrics = cli.main(_argv(rflags))
    base_params, _, _ = tckpt.load_checkpoint(base)
    flat_got, spec_got = jax.tree_util.tree_flatten(restored[-1])
    flat_want, spec_want = jax.tree_util.tree_flatten(base_params)
    assert spec_got == spec_want
    assert all(torch.equal(g, w) for g, w in zip(flat_got, flat_want))
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["len"] <= flags["num_frames"]
    params, _, meta = tckpt.load_checkpoint(os.path.join(tmp, "rationale", "model_latest"))
    assert meta["config"]["mode"] == "train_rationale" and set(params) == {"caption_net",
                                                                         "gen"}
    rio = dict(io, save_path=rflags["save_path"])
    caps = cli.main(_argv(dict(rio, mode="decode", beam_size=2)))
    assert len(caps) == 3


class _Cut(Exception):
    pass


def test_midepoch_resume_is_bit_for_bit(tmp_path, monkeypatch):
    """A run cut after a ckpt_iter checkpoint mid-epoch, resumed with
    --resume true, ends with the parameters and Adam state of one
    uninterrupted run, bit for bit (dropout on: the step seeds matter)."""
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"))
    common = dict(bsize=2, dropout_p=0.2, ckpt_iter=1, beam_size=1, epochs=2)
    cli.main(_argv(_flags(tmp, save="whole", **common)))

    cut = _flags(tmp, save="cut", **common)
    build = tstep.build_step_fns

    def cut_after_4(*args, **kw):
        train_step, eval_step = build(*args, **kw)
        calls = []

        def step(*a, **k):
            if len(calls) == 4:
                raise _Cut()
            calls.append(1)
            return train_step(*a, **k)
        return step, eval_step

    monkeypatch.setattr(tloop, "build_step_fns", cut_after_4)
    with pytest.raises(_Cut):
        cli.main(_argv(cut))
    monkeypatch.setattr(tloop, "build_step_fns", build)
    meta = tckpt.peek_meta(tckpt.latest_path(cut["save_path"]))
    assert (meta["epoch"], meta["batch_in_epoch"], meta["n_iter"]) == (1, 1, 4)
    cli.main(_argv(dict(cut, resume="true", epochs=5)))   # the saved epochs=2 wins

    whole = torch.load(os.path.join(tmp, "whole", "model_latest", "tree.pt"),
                       weights_only=True)
    resumed = torch.load(os.path.join(tmp, "cut", "model_latest", "tree.pt"),
                         weights_only=True)
    got, want = bridge.to_numpy(resumed["params"]), bridge.to_numpy(whole["params"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(g, leaf, err_msg=jax.tree_util.keystr(path))
    for i, state in whole["opt_state"]["state"].items():
        for name, value in state.items():
            assert torch.equal(resumed["opt_state"]["state"][i][name], value), (i, name)
    assert tckpt.peek_meta(tckpt.latest_path(cut["save_path"]))["n_iter"] == 6


def test_crash_between_renames_leaves_old_loadable(tmp_path, monkeypatch):
    path = str(tmp_path / "model_latest")
    p1, p2 = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    opt = toptim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    tckpt.save_checkpoint(path, p1, opt.init(p1), {"epoch": 1})
    rename = os.rename
    calls = []

    def crash_on_second(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise OSError("killed between the renames")
        rename(src, dst)

    monkeypatch.setattr(tckpt.os, "rename", crash_on_second)
    with pytest.raises(OSError, match="between the renames"):
        tckpt.save_checkpoint(path, p2, opt.init(p2), {"epoch": 2})
    monkeypatch.setattr(tckpt.os, "rename", rename)
    assert not os.path.exists(path) and os.path.exists(path + ".old")
    assert tckpt.checkpoint_exists(path)
    params, opt_saved, meta = tckpt.load_checkpoint(path)
    assert torch.equal(params["w"], torch.ones(3)) and meta == {"epoch": 1}
    assert opt_saved["param_groups"][0]["lr"] == 1e-3
    assert tckpt.peek_meta(path) == {"epoch": 1}
    # a JAX package (Orbax) checkpoint is refused, naming the route that
    # reads it: the JAX package's export to a .net file
    os.makedirs(tmp_path / "jax_ckpt" / "tree")
    with pytest.raises(NotImplementedError, match="--mode export_reference"):
        tckpt.load_checkpoint(str(tmp_path / "jax_ckpt"))
    # the next save completes over the leftovers
    tckpt.save_checkpoint(path, p2, opt.init(p2), {"epoch": 3})
    assert tckpt.peek_meta(path) == {"epoch": 3} and not os.path.exists(path + ".old")


def test_preemption_signal_saves_and_resumes(tmp_path):
    """SIGTERM mid-training saves a mid-epoch checkpoint at the next step
    boundary (or after the epoch's checkpoint) and exits 0; --resume
    continues from it."""
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"), num_videos=8)
    flags = _flags(tmp, bsize=2, epochs=2000, beam_size=1, hidden_size=8)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vcr_tpu_torch.cli", *_argv(flags)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    while time.time() < deadline:
        if "updates:" in proc.stdout.readline():
            break
    else:
        proc.kill()
        pytest.fail("training never reached a logged step")
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert "Preemption signal" in out
    meta = tckpt.peek_meta(tckpt.latest_path(flags["save_path"]))
    assert meta is not None and meta["n_iter"] >= 1


# verify_parity and export_reference run since A8, train_spatial since A11,
# the Transformer in each since A12, serve since A14, the quantized serving
# modes since A13, export_serving, export_continuous and serve on a frozen
# artifact since A16, and the prep modes and eval_attention since A17; their
# cases keep their ids and hold what still stands: a multi-device artifact
# (A15), a sampling pool frozen (live-pool only, as in the JAX package), a
# JAX-made artifact, a quantized KV cache on S2VT, which has none; the
# int8-weight pool is exported and served; SpatialNet over a Transformer; an
# unknown corpus or vision architecture, a YOLO input size that is no
# multiple of 32, a corpus without train captions, a SpatialNet checkpoint
# that is not there
@pytest.mark.parametrize("mode, extra, exc, item", [
    # bench runs since A4, on the card only: on the CPU the bench's timing
    # refuses it before anything is built
    pytest.param("bench", [], RuntimeError, "a CPU time is not a device measurement",
                 id="bench"),
    pytest.param("extract_captions", ["--corpus", "youtube"], NotImplementedError,
                 "Unknown corpus", id="extract_captions"),
    pytest.param("extract_video_feats", ["--corpus", "msvd", "--vision_arch", "alexnet"],
                 NotImplementedError, "vision architecture", id="extract_video_feats"),
    pytest.param("extract_bbox_feats", ["--img_size", "48"], ValueError, "multiple of 32",
                 id="extract_bbox_feats"),
    pytest.param("extract_glove", ["--data_dir", "{artifact}"], FileNotFoundError,
                 "train_captions.json", id="extract_glove"),
    pytest.param("eval_attention", ["--spatial_net_file", "{artifact}"], FileNotFoundError,
                 "tree.pt", id="eval_attention"),
    pytest.param("export_serving", ["--mesh_mp", "2"], NotImplementedError, "ignores",
                 id="export_serving"),
    pytest.param("export_continuous", ["--sample_temperature", "0.7"],
                 NotImplementedError, "live-pool only", id="export_continuous"),
    pytest.param("serve", ["--pretrained_base", "{artifact}", "--serve_kv_cache", "int8"],
                 ValueError, "JAX package", id="serve"),
    pytest.param("export_serving", ["{trained}", "--serve_kv_cache", "int8"],
                 ValueError, "has none", id="export_reference"),
    pytest.param("export_continuous", ["{trained}", "--serve_decode_weights", "int8"],
                 None, "", id="verify_parity"),
    pytest.param("train_spatial", ["--arch", "transformer"], NotImplementedError,
                 "wraps S2VT or S2VT-att", id="train_spatial")])
def test_unported_modes_raise(mode, extra, exc, item, tmp_path, request):
    (tmp_path / "meta.json").write_text(json.dumps({"kind": "continuous"}))
    if "{trained}" in extra:
        flags = request.getfixturevalue("trained")["flags"]
        io = [x for k in ("data_dir", "corpus", "glove_emb_file", "save_path")
              for x in (f"--{k}", str(flags[k]))]
        extra = io + ["--save_path", str(tmp_path / "export"), "--pretrained_base",
                      tckpt.best_path(flags["save_path"])] + extra[1:]
    extra = [str(tmp_path) if x == "{artifact}" else x for x in extra]
    argv = ["--mode", mode, "--device", "cpu", *extra]
    if exc is not None:
        with pytest.raises(exc, match=item):
            cli.main(argv)
        return
    from vcr_tpu_torch.export_continuous import load_continuous
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    frozen = load_continuous(cli.main(argv), device="cpu")
    assert frozen.meta["decode_weights"] == "int8"
    cfg, _ = tconfig.get_config(["--mode", "decode", *extra])
    _, params, spec, _ = ttools.load_inference_state(cfg, cfg.pretrained_base, "cpu")
    feats = {i: np.random.default_rng(i).standard_normal((4, 12)).astype(np.float32)
             for i in range(3)}
    want = ContinuousCaptioner(params, spec, slots=frozen.slots,
                               admit_chunk=frozen.admit_chunk, decode_weights="int8",
                               rng=cfg.seed, device="cpu").caption_all(feats)
    got = frozen.caption_all(feats)
    assert all(np.array_equal(got[k], want[k]) for k in feats)


@pytest.mark.parametrize("argv, exc, item", [
    # --arch s2vt-att trains since A9, --mode train_spatial since A11, and a
    # mesh since A15; the case keeps its id: a mesh axis of model
    # parallelism in a process that has no process group to span
    pytest.param(["--mesh_mp", "2"], RuntimeError, "init_process_group", id="argv0-A9"),
    # --arch transformer trains since A12; the case keeps its id and holds
    # RationaleNet over a Transformer, which neither package has
    pytest.param(["--arch", "transformer", "--mode", "train_rationale"],
                 NotImplementedError, "wraps S2VT or S2VT-att", id="argv1-A12"),
    # a mesh trains since A15; the case keeps its id: a data-parallel axis
    # without a process group
    pytest.param(["--mesh_dp", "2"], RuntimeError, "init_process_group",
                 id="argv2-NotImplementedError-A15"),
    # the serving daemon's fields parse since A14 and its quantized modes
    # since A13; the case keeps its id and holds an unknown mode, refused
    # before any data is read
    pytest.param(["--serve_kv_cache", "int3"], ValueError, "kv_cache", id="argv3-A14")])
def test_unported_options_raise(argv, exc, item):
    with pytest.raises(exc, match=item):
        cli.main(["--mode", "train", "--device", "cpu", *argv])


def test_cli_refuses_without_a_card_unless_asked_for_cpu(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    io = {k: trained["flags"][k] for k in ("data_dir", "corpus", "glove_emb_file",
                                           "save_path")}
    argv = _argv(dict(io, mode="decode"))[:-2]   # no --device: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(dict(trained["flags"], save_path=os.path.join(
            trained["tmp"], "never")))[:-2])
    assert not os.path.exists(os.path.join(trained["tmp"], "never"))
    assert len(cli.main(argv + ["--device", "cpu"])) == 3
    assert len(ttools.decode_corpus(tconfig.Config(**dict(io, mode="decode")),
                                    device="cpu")) == 3
