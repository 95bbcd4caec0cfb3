"""GloVe truncation, the counterpart of ``vcr_tpu/data/prep/glove.py``:
every ``<data_dir>/glove/*.txt`` is copied into the corpus's ``glove/``
with only the rows of words that occur, lowercased, in its train
captions."""

from __future__ import annotations

import json
import os
import shutil

from vcr_tpu_torch.data.captions import word_tokenize


def extract_glove(cfg) -> None:
    corpus_base = os.path.join(cfg.data_dir, cfg.corpus)
    with open(os.path.join(corpus_base, "train_captions.json")) as fp:
        content = json.load(fp)

    vocab = set()
    for video in content:
        for cap in video["captions"]:
            desc = cap["desc"]
            toks = word_tokenize(desc) if isinstance(desc, str) else desc
            vocab.update(w.lower() for w in toks)
    print(f"Found {len(vocab)} words in caption vocabulary")

    glove_dir = os.path.join(cfg.data_dir, "glove/")
    trunc_dir = os.path.join(corpus_base, "glove/")
    if os.path.isdir(trunc_dir):
        shutil.rmtree(trunc_dir)
    os.makedirs(trunc_dir)

    for glove_file in sorted(f for f in os.listdir(glove_dir) if f.endswith(".txt")):
        print(f"Processing {glove_file}... ", end="", flush=True)
        # stream the (possibly multi-GB) file; keep the rows of words in use
        with open(os.path.join(glove_dir, glove_file)) as fin, \
                open(os.path.join(trunc_dir, glove_file), "w") as fout:
            for line in fin:
                if line.split(" ", 1)[0] in vocab:
                    fout.write(line)
        print("done")
