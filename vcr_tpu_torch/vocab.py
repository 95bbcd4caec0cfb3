"""GloVe vocabulary loading and detokenization: a copy of ``vcr_tpu/vocab.py``.

The embedding matrix is built once as a single float32 numpy array, and
detokenization works on whole padded int32 token grids.

Special tokens ``<sos> <eos> <pad> <unk>`` are appended after the GloVe rows with
seeded random-normal vectors (reference: utils.py:42-50).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

SPECIAL_TOKENS = ("<sos>", "<eos>", "<pad>", "<unk>")


def load_glove_file(fname: str, seed: int = 0):
    """Parse a GloVe txt file -> (word_to_index, index_to_word, vectors).

    Mirrors reference utils.py:17-52 but returns one stacked float32 matrix and
    uses a seeded Generator for the 4 special-token vectors (the reference used
    the global numpy RNG; a seeded stream keeps runs reproducible).
    """
    words: List[str] = []
    vecs: List[np.ndarray] = []
    with open(fname, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split()
            if not parts:
                continue
            words.append(parts[0])
            vecs.append(np.asarray([float(v) for v in parts[1:]], dtype=np.float32))

    dim = vecs[0].shape[0]
    rng = np.random.default_rng(seed)
    for tok in SPECIAL_TOKENS:
        words.append(tok)
        vecs.append(rng.standard_normal(dim).astype(np.float32))

    word_to_index = {w: i for i, w in enumerate(words)}
    index_to_word = {i: w for i, w in enumerate(words)}
    return word_to_index, index_to_word, np.stack(vecs).astype(np.float32)


class Vocab:
    """Word <-> id maps + the GloVe embedding matrix.

    API parity with the reference GloveLoader (utils.py:54-98): get_id, get_word,
    get_sent_from_index, get_sents_from_indexes.
    """

    def __init__(self, glove_emb_file: str, seed: int = 0):
        self.word_to_index, self.index_to_word, self.vectors = load_glove_file(
            glove_emb_file, seed=seed
        )
        self.embed_size = int(self.vectors.shape[1])
        self.vocab_size = int(self.vectors.shape[0])
        self.sos_id = self.word_to_index["<sos>"]
        self.eos_id = self.word_to_index["<eos>"]
        self.pad_id = self.word_to_index["<pad>"]
        self.unk_id = self.word_to_index["<unk>"]

    # -- reference-parity accessors (utils.py:59-68) --
    def get_id(self, word: str) -> int:
        return self.word_to_index.get(word, self.unk_id)

    def get_word(self, idx: int) -> str:
        return self.index_to_word.get(int(idx), "<unk>")

    def get_sent_from_index(self, indexes: Sequence[int]) -> str:
        """Ids -> sentence, stopping at the first <eos> (utils.py:70-85)."""
        out = []
        for idx in indexes:
            word = self.get_word(int(idx))
            if word == "<eos>":
                break
            out.append(word)
        return " ".join(out)

    def get_sents_from_indexes(self, indexes: np.ndarray) -> List[str]:
        """Always a list of sentences: a 1-D input is one sentence and comes
        back as a one-element list (a bare str here would be iterated
        character-by-character by callers trusting the annotation)."""
        indexes = np.asarray(indexes)
        assert indexes.ndim < 3
        if indexes.ndim == 1:
            return [self.get_sent_from_index(indexes)]
        return [self.get_sent_from_index(row) for row in indexes]

    # -- encoding used by the data pipeline (reference dataset.py:65-71) --
    def encode(self, tokens: Sequence[str], max_len: int) -> np.ndarray:
        """Lowercase, map OOV -> <unk>, append <eos>, truncate/pad to max_len."""
        sent = [t.lower() if t.lower() in self.word_to_index else "<unk>" for t in tokens]
        sent.append("<eos>")
        sent = sent[:max_len]
        sent.extend("<pad>" for _ in range(max(0, max_len - len(sent))))
        return np.asarray([self.word_to_index[s] for s in sent], dtype=np.int32)


def tiny_vocab(words: Sequence[str], dim: int = 8, seed: int = 0) -> Vocab:
    """Build an in-memory Vocab without a GloVe file (for tests)."""
    import tempfile

    rng = np.random.default_rng(seed)
    path = os.path.join(tempfile.mkdtemp(), "glove_tiny.txt")
    with open(path, "w") as f:
        for w in words:
            vec = rng.standard_normal(dim)
            f.write(w + " " + " ".join(f"{v:.6f}" for v in vec) + "\n")
    return Vocab(path, seed=seed)
