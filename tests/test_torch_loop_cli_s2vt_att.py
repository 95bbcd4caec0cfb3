"""The port's command line with ``--arch s2vt-att`` on the tiny corpus of
``tests/util_corpus.py``, on the CPU: two epochs trained in both packages
from one set of JAX-initialised weights at float32 with beam-3 validation,
then eval and decode in both; then RationaleNet warm-started from the
S2VT-att checkpoint; and the refusal of the card where there is none."""

import json
import os
import sys

import jax
import pytest
import torch

from vcr_tpu import config as jconfig
from vcr_tpu import tools as jtools
from vcr_tpu.train import loop as jloop
from vcr_tpu.utils import logging as jlogging
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.utils import logging as tlogging

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_loop_cli import (LOSS_TOL, _argv, _assert_eval_equal,  # noqa: E402
                                 _flags, _jax_init_params, _Recorder)
from util_corpus import build_corpus  # noqa: E402


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages train S2VT-att for 2 epochs on one corpus from the same
    initial weights (dropout 0: nothing is drawn after init), validating
    with beam search of width 3."""
    tmp = str(tmp_path_factory.mktemp("loop_att"))
    build_corpus(os.path.join(tmp, "data"))
    flags = _flags(tmp, arch="s2vt-att")
    jcfg = jconfig.Config(**dict(flags, save_path=os.path.join(tmp, "jax_models")))
    init = _jax_init_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        jrec = _Recorder(mp, jloop, jlogging.TrainLogger)
        jloop.train(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        trec = _Recorder(mp, tloop, tlogging.TrainLogger)
        mp.setattr(tloop, "init_params",
                   lambda cfg, spec, vocab, device: bridge.from_jax_params(init, device))
        cli.main(_argv(flags))
    return dict(tmp=tmp, flags=flags, jcfg=jcfg, jrec=jrec, trec=trec)


def test_train_matches_jax(trained):
    jrec, trec = trained["jrec"], trained["trec"]
    assert len(trec.evals) == len(jrec.evals) == 2
    assert len(trec.steps) == len(jrec.steps) == 4
    for got, want in zip(trec.steps, jrec.steps):
        for k in ("loss", "acc"):
            assert abs(got[k] - want[k]) <= LOSS_TOL, (k, got[k], want[k])
    for got, want in zip(trec.evals, jrec.evals):
        _assert_eval_equal(got, want)
    meta = tckpt.peek_meta(os.path.join(trained["flags"]["save_path"], "model_best"))
    assert meta["config"]["arch"] == "s2vt-att"


def test_eval_and_decode_match_jax(trained):
    flags, jcfg = trained["flags"], trained["jcfg"]
    io = {k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")}
    got = cli.main(_argv(dict(io, mode="eval")))
    want = jloop.evaluate_checkpoint(jconfig.Config(**dict(io, mode="eval",
                                                           save_path=jcfg.save_path)))
    _assert_eval_equal(got, want)
    for beam in (1, 3):
        tokens = cli.main(_argv(dict(io, mode="decode", beam_size=beam)))
        with open(os.path.join(flags["save_path"], "captions.json")) as f:
            assert json.load(f) == tokens
        jtokens = jtools.decode_corpus(
            jconfig.Config(**dict(io, mode="decode", save_path=jcfg.save_path)),
            beam_size=beam)
        assert tokens == jtokens and len(tokens) == 3


def test_rationale_warm_start_from_s2vt_att(trained, monkeypatch):
    """train_rationale over S2VT-att: the caption net starts as S2VT-att's
    model_best leaf for leaf, trains an epoch and decodes by beam search."""
    tmp, flags = trained["tmp"], trained["flags"]
    base = os.path.join(flags["save_path"], "model_best")
    rflags = _flags(tmp, save="rationale_att", mode="train_rationale", arch="s2vt-att",
                    epochs=1, pretrained_base=base, beam_size=2)
    restore, restored = tckpt.restore_into, []

    def recording(params, saved):
        restore(params, saved)
        restored.append(jax.tree_util.tree_map(torch.clone, params))

    monkeypatch.setattr(tckpt, "restore_into", recording)
    metrics = cli.main(_argv(rflags))
    flat_got, tree_got = jax.tree_util.tree_flatten(restored[-1])
    flat_want, tree_want = jax.tree_util.tree_flatten(tckpt.load_checkpoint(base)[0])
    assert tree_got == tree_want and "encoder" in restored[-1]
    assert all(torch.equal(g, w) for g, w in zip(flat_got, flat_want))
    assert 0.0 <= metrics["len"] <= flags["num_frames"]
    rio = {k: rflags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")}
    caps = cli.main(_argv(dict(rio, mode="decode", beam_size=2)))
    assert len(caps) == 3


def test_cli_refuses_without_a_card_unless_asked_for_cpu(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    io = {k: trained["flags"][k] for k in ("data_dir", "corpus", "glove_emb_file",
                                           "save_path")}
    for mode in ("eval", "decode"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(_argv(dict(io, mode=mode))[:-2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(dict(trained["flags"], save_path=os.path.join(
            trained["tmp"], "never")))[:-2])
    assert len(cli.main(_argv(dict(io, mode="decode")))) == 3
