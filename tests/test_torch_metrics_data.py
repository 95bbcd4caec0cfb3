"""The port's configuration, vocabulary, tokenizer, stemmer, caption metrics,
batch pipeline and training-loop helpers against the JAX package's, on the
CPU."""

import dataclasses
import json
import os
import string
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.stem.porter import PorterStemmer as NltkPorter
from nltk.tokenize.treebank import TreebankWordTokenizer

from vcr_tpu import config as jconfig
from vcr_tpu import vocab as jvocab
from vcr_tpu.data import captions as jcaptions
from vcr_tpu.data import pipeline as jpipeline
from vcr_tpu.evals import metrics as jmetrics
from vcr_tpu.utils import logging as jlogging
from vcr_tpu.utils import sampler as jsampler
from vcr_tpu_torch import config as tconfig
from vcr_tpu_torch import vocab as tvocab
from vcr_tpu_torch.data import captions as tcaptions
from vcr_tpu_torch.data import pipeline as tpipeline
from vcr_tpu_torch.evals import metrics as tmetrics
from vcr_tpu_torch.evals.porter import PorterStemmer
from vcr_tpu_torch.utils import logging as tlogging
from vcr_tpu_torch.utils import profiling as tprofiling
from vcr_tpu_torch.utils import sampler as tsampler

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import SENTS, build_corpus  # noqa: E402

METRIC_TOL = 1e-12   # the same Python arithmetic in the same order on both sides


# ---------------------------------------------------------------- config

ARGVS = [
    [],
    ["--mode", "eval", "--bsize", "7", "--lr", "1e-2", "--resume", "true",
     "--pretrained_base", "x/model_best", "--sample_top_p", "0.5",
     "--compute_dtype", "float32", "--vocab_pad_to", "128", "--shuffle", "false"],
    ["--mode", "train_rationale", "--tau", "0.5", "--ckpt_iter", "3", "--remat", "1",
     "--grad_accum", "2", "--meteor_synonyms", "wordnet", "--beam_size", "5"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_config_parses_like_jax(argv):
    cfg, device = tconfig.get_config(argv)
    assert device == "cuda"
    assert cfg.to_dict() == jconfig.get_config(argv).to_dict()
    assert "device" not in cfg.to_dict()
    # a checkpoint's embedded config round-trips, and adopting it keeps the
    # same command-line fields
    saved = jconfig.Config(hidden_size=64, mode="train_rationale").to_dict()
    assert tconfig.Config.from_dict(saved).to_dict() == saved
    assert (tconfig.adopt_checkpoint_config(cfg, {"config": saved}).to_dict()
            == jconfig.adopt_checkpoint_config(jconfig.get_config(argv),
                                               {"config": saved}).to_dict())


def test_config_has_every_field_with_its_default():
    ours = [(f.name, f.default, f.type) for f in dataclasses.fields(tconfig.Config)]
    theirs = [(f.name, f.default, f.type) for f in dataclasses.fields(jconfig.Config)]
    assert ours == theirs
    assert tconfig._CLI_OVERRIDE_FIELDS == jconfig._CLI_OVERRIDE_FIELDS
    assert set(tconfig.INERT_FIELDS) <= {name for name, _, _ in ours}
    cfg, device = tconfig.get_config(["--device", "cpu", "--use_pallas", "true"])
    assert device == "cpu" and cfg.use_pallas
    with pytest.raises(SystemExit):
        tconfig.get_config(["--device", "tpu"])


@pytest.mark.parametrize("argv, exc, item", [
    # a mesh parses in the train modes since A15 and --mesh_dp in serve,
    # decode and export_serving since A15b (test_config_takes_a_mesh_in_the_
    # train_modes); these cases keep their ids and hold what the config still
    # refuses: a flag the JAX package ignores in that mode
    pytest.param(["--mesh_mp", "2", "--mode", "serve"], NotImplementedError, "ignores",
                 id="argv0-NotImplementedError-A15"),
    pytest.param(["--mesh_mp", "2", "--mode", "export_serving"], NotImplementedError,
                 "ignores", id="argv1-NotImplementedError-A15"),
    # the serving daemon's fields parse since A14 and its quantized modes
    # since A13 (test_config_takes_the_quantized_serving_modes); these cases
    # keep their ids and hold what the modes still refuse: an unknown mode
    pytest.param(["--serve_kv_cache", "int2"], ValueError, "kv_cache", id="argv2-A14"),
    pytest.param(["--serve_kv_cache", "fp8"], ValueError, "kv_cache", id="argv3-A14"),
    pytest.param(["--serve_decode_weights", "int4"], ValueError, "decode_weights",
                 id="argv4-A14"),
    # --arch s2vt-att parses since A9; the case keeps its id, an unknown arch
    pytest.param(["--arch", "lstm-lm"], NotImplementedError, "Unknown", id="argv5-A9"),
    # --arch transformer parses since A12 and its quantized serving modes
    # since A13; the case keeps its id and holds what the Transformer still
    # refuses on the command line: RationaleNet over it, which neither
    # package has
    pytest.param(["--arch", "transformer", "--mode", "train_rationale"],
                 NotImplementedError, "wraps S2VT or S2VT-att", id="argv6-A12"),
])
def test_config_refuses_what_is_not_ported(argv, exc, item):
    with pytest.raises(exc, match=item):
        tconfig.get_config(argv)


@pytest.mark.parametrize("mode", ["train", "train_rationale", "train_spatial"])
def test_config_takes_a_mesh_in_the_train_modes(mode):
    cfg, _ = tconfig.get_config(["--mode", mode, "--mesh_dp", "2", "--mesh_mp", "4"])
    assert (cfg.mesh_dp, cfg.mesh_mp) == (2, 4)
    with pytest.raises(ValueError, match="mesh_dp must be >= 1"):
        tconfig.get_config(["--mode", mode, "--mesh_dp", "0"])


@pytest.mark.parametrize("argv", [
    ["--mode", "decode", "--mesh_dp", "2", "--mesh_mp", "4"],
    ["--mode", "serve", "--mesh_dp", "2"],
    ["--mode", "export_serving", "--mesh_dp", "2"]])
def test_config_takes_a_mesh_where_the_jax_package_does(argv):
    """The modes whose JAX counterparts read the flags take them (A15b); the
    port's config equals the JAX package's."""
    cfg, _ = tconfig.get_config(argv)
    assert cfg.to_dict() == jconfig.get_config(argv).to_dict()


@pytest.mark.parametrize("mode, flag", [("eval", "--mesh_dp"),
                                        ("export_continuous", "--mesh_dp"),
                                        ("verify_parity", "--mesh_mp")])
def test_config_refuses_a_mesh_the_jax_package_ignores(mode, flag):
    with pytest.raises(NotImplementedError, match=f"{flag} 2 with --mode {mode}: the JAX "
                                                  "package ignores"):
        tconfig.get_config(["--mode", mode, flag, "2"])


@pytest.mark.parametrize("kv, dw", [("int8", "bf16"), ("int4", "int8"), ("bf16", "int8")])
def test_config_takes_the_quantized_serving_modes(kv, dw):
    """The quantized serving modes parse and validate as the JAX package's
    config takes them; --mode serve hands them to the slot pool."""
    argv = ["--mode", "serve", "--arch", "transformer", "--serve_kv_cache", kv,
            "--serve_decode_weights", dw]
    cfg, _ = tconfig.get_config(argv)
    assert (cfg.serve_kv_cache, cfg.serve_decode_weights) == (kv, dw)
    assert cfg.to_dict() == jconfig.get_config(argv).to_dict()


# ---------------------------------------------------------- vocab, captions

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    glove = build_corpus(root, num_videos=7, num_frames=3, feat_dim=5)
    return root, glove


def test_vocab_matches_jax(corpus):
    _, glove = corpus
    t, j = tvocab.Vocab(glove, seed=7), jvocab.Vocab(glove, seed=7)
    assert t.word_to_index == j.word_to_index and t.index_to_word == j.index_to_word
    np.testing.assert_array_equal(t.vectors, j.vectors)
    assert (t.sos_id, t.eos_id, t.pad_id, t.unk_id, t.embed_size, t.vocab_size) == \
        (j.sos_id, j.eos_id, j.pad_id, j.unk_id, j.embed_size, j.vocab_size)
    toks = ["A", "dog", "zebra", "runs"]
    np.testing.assert_array_equal(t.encode(toks, 6), j.encode(toks, 6))
    grid = np.asarray([[3, 1, t.eos_id, 2], [t.unk_id, 0, 4, 5]])
    assert t.get_sents_from_indexes(grid) == j.get_sents_from_indexes(grid)
    assert t.get_sents_from_indexes(grid[0]) == j.get_sents_from_indexes(grid[0])


TREEBANK = TreebankWordTokenizer()
TRICKY_TEXT = SENTS + [
    "Good muffins cost $3.88\nin New York.  Please buy me\ntwo of them.\nThanks.",
    "They'll save and invest more.", "hi, my name can't hello,",
    "\"Hello,\" she said -- (quietly) [sic] {x} <y>... 3,36 euros; 50% & #1 @home!?",
    "gonna gimme gotta lemme wanna cannot 'tis 'twas more'n d'ye",
    "a man's dog isn't here; we'd go, you're late, I'm done, they've left",
    "''quoted'' ``ticks`` it's 'single' end.",
]


def test_tokenizer_matches_nltk_on_the_corpus_and_tricky_text():
    for text in TRICKY_TEXT:
        assert tcaptions.word_tokenize(text) == TREEBANK.tokenize(text), text


_PIECES = ["a", "man", "is", "don't", "can't", "they'll", "we're", "I'm", "o'clock",
           "gonna", "wanna", "cannot", "'tis", "3.88", "3,36", "...", "--", "(", ")",
           "[", "]", "{", "}", "<", ">", ".", ",", ";", ":", "!", "?", "\"", "'",
           "''", "``", "$", "%", "&", "#", "@", "end.", "Mr.", "U.S.", "n't", "'s"]


@settings(max_examples=300, deadline=None)
@given(st.one_of(
    st.lists(st.sampled_from(_PIECES), max_size=12).map(" ".join),
    st.lists(st.sampled_from(_PIECES), max_size=12).map("".join),
    st.text(alphabet=string.ascii_letters + string.digits + " .,;:!?'\"()[]{}<>-$%&@#",
            max_size=40)))
def test_tokenizer_matches_nltk_on_a_sweep(text):
    assert tcaptions.word_tokenize(text) == TREEBANK.tokenize(text)


def test_caption_file_reads_like_jax(corpus):
    root, _ = corpus
    path = os.path.join(root, "msvd_vgg", "train_captions.json")
    assert tcaptions.read_caption_file(path) == jcaptions.read_caption_file(path)


# ---------------------------------------------------------------- stemmer

NLTK_PORTER = NltkPorter()
TRICKY_WORDS = (
    "sky skies dying lying tying news innings inning outings canning howe proceed "
    "exceed succeed flies dies spied died ties ponies caresses caress cats feed agreed "
    "plastered bled motoring sing conflated troubled sized hopping tanned falling "
    "hissing fizzed failing filing happy enjoy spy fly try relational conditional "
    "rational valenci hesitanci digitizer conformabli radicalli differentli vileli "
    "analogousli vietnamization predication operator feudalism decisiveness "
    "hopefulness callousness formaliti sensitiviti sensibiliti fulli geology theology "
    "archaeology triplicate formative formalize electriciti electrical hopeful "
    "goodness revival allowance inference airliner gyroscopic adjustable defensible "
    "irritant replacement adjustment dependent adoption homologou communism activate "
    "angulariti homologous effective bowdlerize probate rate cease controll roll "
    "yyyy syzygy toy running jumps playing cooking women is a on the dog").split()


def test_stemmer_matches_nltk_on_tricky_words():
    ours = PorterStemmer()
    assert [ours.stem(w) for w in TRICKY_WORDS] == [NLTK_PORTER.stem(w) for w in TRICKY_WORDS]
    assert ours.stem("Running") == NLTK_PORTER.stem("Running")


@settings(max_examples=500, deadline=None)
@given(st.text(alphabet=string.ascii_lowercase, min_size=1, max_size=16)
       | st.text(alphabet="aeiouylsszbdtgn", min_size=1, max_size=12)
       .map(lambda w: w + "ing") | st.text(alphabet="aeioucrtyl", min_size=1, max_size=10)
       .map(lambda w: w + "ational"))
def test_stemmer_matches_nltk_on_a_sweep(word):
    assert PorterStemmer().stem(word) == NLTK_PORTER.stem(word)


# ---------------------------------------------------------------- metrics

WORDS = ("a the man men woman dog dogs cat is are was playing plays played play guitar "
         "runs running ran on in table tables cooking cooks food jumps jumped quickly "
         "happily slice sliced slicing onion onions zebra").split()


def _caption_set(seed, n=24):
    r = np.random.default_rng(seed)

    def sent():
        return " ".join(r.choice(WORDS, size=r.integers(1, 10)))

    hyps = [sent() for _ in range(n)] + [""]
    refs = [[sent() for _ in range(r.integers(1, 4))] for _ in range(n)] + [["a man"]]
    return hyps, refs


def _all_metrics(mod, hyps, refs, vocab):
    lookup = mod.vocab_lookup(vocab)
    return {
        "meteor": [mod.meteor_score(h, rs) for h, rs in zip(hyps, refs)],
        "meteor15": [mod.meteor15_score(h, rs) for h, rs in zip(hyps, refs)],
        "batch_meteor": mod.batch_meteor(hyps, refs),
        "bleu4": [mod.bleu4_score(h, rs) for h, rs in zip(hyps, refs)],
        "corpus_bleu": mod.corpus_bleu(hyps, refs),
        "cider_d": mod.cider_d(hyps, refs),
        "rouge_l": mod.corpus_rouge_l(hyps, refs),
        **mod.corpus_embedding_metrics(hyps, refs, lookup),
    }


def _assert_metrics_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(tmp_path, seed):
    words = sorted(set(WORDS))
    t_vocab = tvocab.tiny_vocab(words, dim=8, seed=seed)
    j_vocab = jvocab.tiny_vocab(words, dim=8, seed=seed)
    hyps, refs = _caption_set(seed)
    _assert_metrics_equal(_all_metrics(tmetrics, hyps, refs, t_vocab),
                          _all_metrics(jmetrics, hyps, refs, j_vocab))


def test_meteor_resource_stages_match_jax(tmp_path):
    """The synonym and paraphrase stages, loaded from the same TSV files."""
    syn, para = tmp_path / "syn.tsv", tmp_path / "para.tsv"
    syn.write_text("man\ts1\nmen\ts1\nwoman\ts2 s1\ntable\ts3\nguitar\ts4\n")
    para.write_text("playing guitar\tplays\ncooking food\tcooks\na man\tmen\n")
    hyps, refs = _caption_set(3)
    try:
        summaries = [mod.configure_meteor_resources(str(syn), str(para))
                     for mod in (tmetrics, jmetrics)]
        assert summaries[0] == summaries[1]
        got = [tmetrics.meteor15_score(h, rs) for h, rs in zip(hyps, refs)]
        want = [jmetrics.meteor15_score(h, rs) for h, rs in zip(hyps, refs)]
    finally:
        tmetrics.set_meteor_resources()
        jmetrics.set_meteor_resources()
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL)
    assert tmetrics.wordnet_synonym_table() is None
    with pytest.warns(UserWarning, match="synonym stage stays inert"):
        assert "inert" in tmetrics.configure_meteor_resources("wordnet")


# ---------------------------------------------------------------- pipeline

def _batches(mod, corpus, epochs=2, skip=0, **kw):
    root, glove = corpus
    v = mod.Vocab(glove, seed=0)
    ds = mod.CaptionDataset(root, "msvd_vgg", "train", v, num_frames=4, max_len=5)
    extra = {} if mod is tpipeline else {"use_native": False}
    it = mod.BatchIterator(ds, 3, shuffle=True, seed=11, num_threads=2, **kw, **extra)
    out = []
    for _ in range(epochs):
        it.skip_next = skip
        out.append(list(it))
    return out


@pytest.mark.parametrize("kw", [{}, {"skip": 1}, {"num_shards": 2, "shard_index": 1},
                                {"skip": 1, "num_shards": 2, "shard_index": 0}])
def test_batch_iterator_matches_jax(corpus, kw):
    """Order, caption choices, padding, valid, sample_idx and skip_next: the
    same batches as the JAX package's numpy path."""
    got, want = _batches(tpipeline, corpus, **kw), _batches(jpipeline, corpus, **kw)
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


def test_prefetch_passes_items_and_errors_through():
    assert list(tpipeline.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(tpipeline.prefetch(broken()))


# ------------------------------------------------- logging, sampler, timer

def test_train_logger_prints_the_window_means_of_jax(capsys):
    keys = ["acc", "loss"]
    window = [{"acc": 0.25 * i, "loss": 2.0 / (i + 1)} for i in range(4)]
    lines = []
    for mod, wrap in ((tlogging, lambda v: torch.tensor(v, dtype=torch.float32)),
                      (jlogging, lambda v: np.float32(v))):
        logger = mod.TrainLogger(0, 4, None)
        logger.set(keys)
        for m in window:
            logger.update({k: wrap(v) for k, v in m.items()})
        lines.append([ln.split("time:")[1].split(",", 1)[1]
                      for ln in capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    logger = tlogging.TrainLogger(0, 2, None)
    logger.set(keys)
    logger.update({"acc": torch.tensor(0.0), "loss": torch.tensor(1.0)})
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        logger.update({"acc": torch.tensor(0.0), "loss": torch.tensor(float("nan"))})


def test_stream_sampler_and_step_timer(tmp_path, capsys):
    samples = []
    for mod in (tsampler, jsampler):
        s = mod.StreamSampler(3, seed=5)
        for i in range(20):
            s.add((f"h{i}", f"r{i}", f"v{i}"))
        samples.append(s.get())
        mod.print_sample_sents(s.get())
    assert samples[0] == samples[1]
    out = capsys.readouterr().out
    assert out[:len(out) // 2] == out[len(out) // 2:]
    timer = tprofiling.StepTimer()
    for _ in range(4):
        timer.tick()
    summary = timer.summary()
    assert summary["steps"] == 3.0 and summary["step_ms_p50"] >= 0.0
    with tprofiling.trace(str(tmp_path)):
        with tprofiling.span("span"):
            torch.ones(3).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "span" for e in trace["traceEvents"])
