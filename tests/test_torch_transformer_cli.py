"""The port's command line with ``--arch transformer`` and its reference
converter, on the CPU against the JAX package: two epochs trained in both
from one set of JAX-initialised weights (every dropout at 0) with beam-3
validation, then eval and decode at beam 1 and 3 in both; the TransformerNet
state_dict converted and exported leaf for leaf as ``vcr_tpu.convert`` does,
both round trips; and ``--mode export_reference`` then ``--mode
verify_parity`` against the JAX package's verify_parity of the same file."""

import json
import os
import sys

import pytest
import torch

import test_convert_transformer as tct
from vcr_tpu import config as jconfig
from vcr_tpu import convert as jconvert
from vcr_tpu import tools as jtools
from vcr_tpu.models import base as jbase
from vcr_tpu.models import transformer as jtr
from vcr_tpu.train import loop as jloop
from vcr_tpu.utils import logging as jlogging
from vcr_tpu_torch import bridge, cli
from vcr_tpu_torch import convert as tconvert
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.models import transformer as ttr
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.utils import logging as tlogging

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_convert import _assert_state_dicts_equal, _assert_trees_equal  # noqa: E402
from test_torch_loop_cli import (LOSS_TOL, _argv, _assert_eval_equal,  # noqa: E402
                                 _flags, _jax_init_params, _Recorder)
from util_corpus import build_corpus  # noqa: E402

TF_FLAGS = dict(arch="transformer", tf_layers=2, tf_heads=2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages train the Transformer for 2 epochs on one corpus from
    the same initial weights, every dropout at 0 (nothing is drawn after
    init), validating with beam search of width 3."""
    tmp = str(tmp_path_factory.mktemp("loop_tf"))
    build_corpus(os.path.join(tmp, "data"))
    flags = _flags(tmp, **TF_FLAGS)
    jcfg = jconfig.Config(**dict(flags, save_path=os.path.join(tmp, "jax_models")))
    init = _jax_init_params(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "INTERNAL_DROPOUT", 0.0)
        mp.setattr(ttr, "INTERNAL_DROPOUT", 0.0)
        jrec = _Recorder(mp, jloop, jlogging.TrainLogger)
        jloop.train(jcfg)
        trec = _Recorder(mp, tloop, tlogging.TrainLogger)
        mp.setattr(tloop, "init_params",
                   lambda cfg, spec, vocab, device: bridge.from_jax_params(init, device))
        cli.main(_argv(flags))
    return dict(tmp=tmp, flags=flags, jcfg=jcfg, jrec=jrec, trec=trec)


def _io(flags, **kw):
    return dict({k: flags[k] for k in ("data_dir", "corpus", "glove_emb_file", "save_path")},
                **kw)


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
    assert meta["config"]["arch"] == "transformer" and meta["config"]["tf_layers"] == 2


def test_eval_and_decode_match_jax(trained):
    """eval (the parity greedy and the parity beam) and decode at beam 1 (the
    parity greedy, not serving's KV-cached one) and 3, as the JAX package's
    command line runs them."""
    flags, jcfg = trained["flags"], trained["jcfg"]
    got = cli.main(_argv(_io(flags, mode="eval")))
    want = jloop.evaluate_checkpoint(jconfig.Config(**_io(flags, mode="eval",
                                                          save_path=jcfg.save_path)))
    _assert_eval_equal(got, want)
    for beam in (1, 3):
        tokens = cli.main(_argv(_io(flags, mode="decode", beam_size=beam)))
        with open(os.path.join(flags["save_path"], "captions.json")) as f:
            assert json.load(f) == tokens
        jtokens = jtools.decode_corpus(
            jconfig.Config(**_io(flags, mode="decode", save_path=jcfg.save_path)),
            beam_size=beam)
        assert tokens == jtokens and len(tokens) == 3


def test_export_reference_then_verify_parity_match_jax(trained):
    """--mode export_reference writes the checkpoint as a TransformerNet .net
    (its state_dict what vcr_tpu.convert exports from the same weights);
    --mode verify_parity of that file equals --mode decode's greedy captions
    and the JAX package's verify_parity of it."""
    tmp, flags = trained["tmp"], trained["flags"]
    net = cli.main(_argv(_io(flags, mode="export_reference")))
    blob = tconvert.read_reference_checkpoint(net)
    params, _, _ = tckpt.load_checkpoint(tckpt.best_path(flags["save_path"]))
    jspec = jbase.ModelSpec(
        arch="transformer", vocab_size=blob["state_dict"]["decoder.embedding.weight"].shape[0],
        embed_size=16, hidden_size=16, vid_feat_size=12, max_len=6, num_frames=4,
        dropout_p=0.0, sos_id=0, compute_dtype="float32", tf_layers=2, tf_heads=2)
    _assert_state_dicts_equal(blob["state_dict"],
                              jconvert.export_state_dict(bridge.to_numpy(params), jspec,
                                                         "transformer"))
    parity_flags = dict(flags, mode="verify_parity", pretrained_base=net,
                        save_path=os.path.join(tmp, "parity"))
    got = cli.main(_argv(parity_flags))
    decoded = cli.main(_argv(_io(flags, mode="decode")))
    assert got == decoded and len(got) == 3
    want = jtools.verify_parity(jconfig.Config(**parity_flags), net)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]


def test_convert_and_export_match_jax():
    """The reference TransformerNet's state_dict (the skeleton of
    tests/test_convert_transformer.py, 2 layers) converted and exported leaf
    for leaf as the JAX package does, the layers stacked on a leading axis;
    export undoes convert and convert undoes export."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = tct.TTransformer(19, heads=2, n=2, hidden=8).state_dict()
    kw = dict(arch="transformer", vocab_size=19, embed_size=tct.D_W, hidden_size=8,
              vid_feat_size=tct.E_W, max_len=5, num_frames=4, dropout_p=0.0, sos_id=15,
              compute_dtype="float32", vocab_pad_to=8, tf_layers=2, tf_heads=2)
    jspec, tspec = jbase.ModelSpec(**kw), tbase.ModelSpec(**kw)
    assert tconvert.detect_arch(sd) == jconvert.detect_arch(sd) == "transformer"
    params = tconvert.convert_state_dict(sd, tspec, "transformer")
    jparams = jconvert.convert_state_dict(sd, jspec, "transformer")
    _assert_trees_equal(params, jparams)
    exported = tconvert.export_state_dict(params, tspec, "transformer")
    _assert_state_dicts_equal(exported, jconvert.export_state_dict(jparams, jspec,
                                                                   "transformer"))
    _assert_state_dicts_equal(exported, sd)
    _assert_trees_equal(tconvert.convert_state_dict(exported, tspec, "transformer"), jparams)
    # without its PE buffers the tables are built, as the JAX package builds them
    no_pe = {k: v for k, v in sd.items() if not k.endswith("pe.pe")}
    _assert_trees_equal(tconvert.convert_state_dict(no_pe, tspec, "transformer"),
                        jconvert.convert_state_dict(no_pe, jspec, "transformer"))
