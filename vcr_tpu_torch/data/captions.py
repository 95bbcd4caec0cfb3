"""Caption-file reading and tokenization: the counterpart of
``vcr_tpu/data/captions.py``.

``{split}_captions.json`` is a list of ``{"video_key"|"video_id": str,
"captions": [{"desc": str}, ...]}``; every description is tokenized at load
time with the Penn Treebank word tokenizer. The JAX package takes that
tokenizer from nltk, which this package does not depend on, so
:func:`word_tokenize` is a copy of ``nltk.tokenize.treebank.
TreebankWordTokenizer.tokenize`` (nltk 3.10.0) with its default arguments:
only the regular expressions that method applies, in its order.

The tokenizer's regular expressions are from NLTK, the Natural Language
Toolkit (https://www.nltk.org), Copyright (C) 2001-2026 NLTK Project,
authors Edward Loper, Michael Heilman and Tom Aarsen, after Robert
McIntyre's tokenizer.sed; licensed under the Apache License, Version 2.0
(http://www.apache.org/licenses/LICENSE-2.0).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),  # final period
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# Robert MacIntyre's contractions (nltk.tokenize.destructive.MacIntyreContractions)
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
_CONTRACTIONS3 = [re.compile(p) for p in (r"(?i) ('t)(?#X)(is)\b",
                                          r"(?i) ('t)(?#X)(was)\b")]


def word_tokenize(text: str) -> List[str]:
    """Penn Treebank tokens of ``text``: contractions split ("don't" ->
    "do n't"), most punctuation its own token, a sentence-final period split
    off."""
    for regexp, substitution in _STARTING_QUOTES + _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in (_PARENS_BRACKETS, _DOUBLE_DASHES):
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2 + _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def read_caption_file(fname: str) -> List[Dict]:
    """Load a captions JSON file and tokenize each description."""
    with open(fname, "r") as fp:
        samples = json.load(fp)
    for sample in samples:
        for cap in sample["captions"]:
            cap["desc"] = word_tokenize(cap["desc"]) if isinstance(cap["desc"], str) \
                else cap["desc"]
    return samples
