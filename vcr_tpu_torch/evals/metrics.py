"""Caption quality metrics: a copy of ``vcr_tpu/evals/metrics.py``.

Pure Python, no external services:

* :func:`meteor15_single` is the METEOR 1.5 scoring formula (exact and
  Porter-stem matcher stages with weights 1.0 and 0.6, content/function-word
  weighting, alpha=0.85 beta=0.2 gamma=0.6, the jar's chunk-minimizing
  beam-search alignment of width 40); the synonym (0.8) and paraphrase (0.6)
  stages run behind pluggable tables (:func:`set_meteor_resources`) and stay
  inert without one. :func:`batch_meteor` averages it per sample over a
  batch: the model-selection metric.
* :func:`meteor_score` is the METEOR 1.0-parameter scorer (alpha=0.9, beta=3,
  gamma=0.5), kept for comparison.
* :func:`bleu4_score` / :func:`corpus_bleu`: smoothed sentence and corpus
  BLEU-4.
* :func:`cider_d`: CIDEr-D (tf-idf 1..4-gram cosine with a length penalty,
  x10).
* :func:`rouge_l` / :func:`corpus_rouge_l`: ROUGE-L, coco-caption semantics.
* :func:`corpus_embedding_metrics`: embedding average, vector extrema and
  greedy matching over the GloVe vectors.

The stem stage uses this package's copy of nltk's Porter stemmer
(:mod:`vcr_tpu_torch.evals.porter`), which stems every word as nltk does.
WordNet is nltk's corpus and is not read here: ``--meteor_synonyms wordnet``
leaves the synonym stage inert, as the JAX package does where the corpus is
not installed.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Tuple

from functools import lru_cache

from vcr_tpu_torch.evals.porter import PorterStemmer

_PORTER = PorterStemmer()


@lru_cache(maxsize=65536)
def _stem(word: str) -> str:
    # caption vocabularies are small; caching makes METEOR ~linear in tokens
    return _PORTER.stem(word)


def tokenize(text: str) -> List[str]:
    return text.lower().split()


# ---------------------------------------------------------------- METEOR

# Meteor 1.5's Aligner.java beam width (the jar's default). At caption
# lengths (<=30 tokens) this is effectively an exhaustive search.
_ALIGN_BEAM_SIZE = 40

# Pluggable matcher resources for the jar's stage-2/3 matchers. The jar ships
# a WordNet-derived synonym table and a paraphrase phrase table; both data
# files are not shipped with this package, so the
# STAGES are implemented here behind pluggable tables and stay inert (inert =
# bit-identical exact+stem behavior) until one is loaded via
# :func:`set_meteor_resources` / the file loaders below.
_SYNONYMS: Optional[Mapping[str, FrozenSet]] = None    # word -> synset ids
_PARAPHRASES: Optional[Dict[Tuple[str, ...], FrozenSet]] = None  # phrase -> phrases
_PARA_MAX_LEN = 1


def set_meteor_resources(synonyms: Optional[Mapping[str, Iterable]] = None,
                         paraphrases: Optional[Iterable[Tuple[Sequence[str], Sequence[str]]]] = None,
                         ) -> None:
    """Install (or with all-None args, clear) the synonym / paraphrase matcher
    resources.

    synonyms: mapping word -> iterable of synset ids; two words match at the
        synonym stage iff their id sets intersect (the jar's synonymy test).
    paraphrases: iterable of (phrase_a, phrase_b) token-sequence pairs,
        matched symmetrically at the paraphrase stage (the jar's phrase
        table). Phrases may be multi-word and of unequal length.
    """
    global _SYNONYMS, _PARAPHRASES, _PARA_MAX_LEN
    _SYNONYMS = ({w: frozenset(ids) for w, ids in synonyms.items()}
                 if synonyms is not None else None)
    if paraphrases is None:
        _PARAPHRASES, _PARA_MAX_LEN = None, 1
        return
    table: Dict[Tuple[str, ...], set] = defaultdict(set)
    for a, b in paraphrases:
        ta, tb = tuple(a), tuple(b)
        table[ta].add(tb)
        table[tb].add(ta)
    _PARAPHRASES = {k: frozenset(v) for k, v in table.items()}
    _PARA_MAX_LEN = max((len(p) for ps in _PARAPHRASES.items()
                         for p in (ps[0], *ps[1])), default=1)


def load_meteor_synonyms(path: str) -> int:
    """Load a synonym table (one `word<TAB>id id id...` line per word — the
    natural dump of the Meteor distribution's WordNet synsets file) and
    install it. Returns the number of words loaded."""
    table: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2 and parts[0]:
                table[parts[0].lower()] = parts[1].split()
    set_meteor_resources(synonyms=table, paraphrases=_paraphrase_pairs())
    return len(table)


def load_meteor_paraphrases(path: str) -> int:
    """Load a paraphrase table (one `phrase_a<TAB>phrase_b` line per pair,
    space-separated lowercase tokens — Meteor's paraphrase-en format minus
    the probability column) and install it. Returns the pair count."""
    pairs = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0] and parts[1]:
                pairs.append((parts[0].lower().split(), parts[1].lower().split()))
    syn = dict(_SYNONYMS) if _SYNONYMS is not None else None
    set_meteor_resources(synonyms=syn, paraphrases=pairs)
    return len(pairs)


def _paraphrase_pairs():
    if _PARAPHRASES is None:
        return None
    return [(a, b) for a, bs in _PARAPHRASES.items() for b in bs]


def configure_meteor_resources(synonyms: str = "", paraphrases: str = "") -> str:
    """CLI adapter (--meteor_synonyms / --meteor_paraphrases): "" leaves a
    stage inert; synonyms="wordnet" has no table here
    (:func:`wordnet_synonym_table`) and leaves the stage inert with a warning;
    anything else is a TSV path for the file loaders. Returns a one-line
    human-readable summary."""
    parts = []
    if synonyms == "wordnet":
        table = wordnet_synonym_table()
        if table is None:
            import warnings
            warnings.warn("--meteor_synonyms wordnet: nltk WordNet data is "
                          "not read; the synonym stage stays inert")
            parts.append("synonyms: wordnet unavailable (stage inert)")
        else:
            set_meteor_resources(synonyms=table,
                                 paraphrases=_paraphrase_pairs())
            parts.append(f"synonyms: wordnet ({len(table)} words)")
    elif synonyms:
        parts.append(f"synonyms: {load_meteor_synonyms(synonyms)} words")
    if paraphrases:
        parts.append(f"paraphrases: {load_meteor_paraphrases(paraphrases)} pairs")
    return "METEOR stages — " + "; ".join(parts) if parts else ""


def wordnet_synonym_table() -> Optional[Dict[str, FrozenSet]]:
    """No table: WordNet is nltk's corpus, which this package does not read.
    The JAX package's function returns None too where the corpus is not
    installed."""
    return None


# A match unit: (hyp_start, hyp_len, ref_start, ref_len, stage). Word-level
# stages (exact/stem/synonym) always have len 1/1; the paraphrase stage can
# cover multi-word spans of unequal length, as the jar's phrase matcher does.
Match = Tuple[int, int, int, int, int]


def _candidate_matches(hyp: List[str], ref: List[str]) -> List[List[Match]]:
    """Per hyp start index, every candidate match unit, each at its
    highest-priority (lowest-numbered) stage as the jar's matchers resolve
    overlaps: 0 exact, 1 Porter stem, 2 synonym (synset-id intersection),
    3 paraphrase (phrase table, span-level)."""
    h_stem = [_stem(w) for w in hyp]
    r_stem = [_stem(w) for w in ref]
    syn = _SYNONYMS
    cands: List[List[Match]] = []
    for i, hw in enumerate(hyp):
        row: List[Match] = []
        for j, rw in enumerate(ref):
            if hw == rw:
                row.append((i, 1, j, 1, 0))
            elif h_stem[i] == r_stem[j]:
                row.append((i, 1, j, 1, 1))
            elif syn is not None and syn.get(hw) and syn.get(rw) \
                    and not syn[hw].isdisjoint(syn[rw]):
                row.append((i, 1, j, 1, 2))
        cands.append(row)
    if _PARAPHRASES is not None:
        # Index every ref span that appears anywhere in the table, then emit
        # a candidate for each hyp span whose paraphrase set hits one.
        ref_spans: Dict[Tuple[str, ...], List[int]] = defaultdict(list)
        for j in range(len(ref)):
            for ln in range(1, min(_PARA_MAX_LEN, len(ref) - j) + 1):
                span = tuple(ref[j:j + ln])
                if span in _PARAPHRASES:
                    ref_spans[span].append(j)
        for i in range(len(hyp)):
            for ln in range(1, min(_PARA_MAX_LEN, len(hyp) - i) + 1):
                targets = _PARAPHRASES.get(tuple(hyp[i:i + ln]))
                if not targets:
                    continue
                for tgt in targets:
                    for j in ref_spans.get(tgt, ()):
                        cands[i].append((i, ln, j, len(tgt), 3))
    return cands


def _align_matches(hyp: List[str], ref: List[str]) -> List[Match]:
    """Meteor-1.5-faithful alignment (reference scoring jar semantics, see
    the reference's train_utils.py:97-111, which is scored by that jar).

    Beam search (width 40, the jar Aligner's default) over non-overlapping
    match-unit sets, preferring in order: (1) most words covered (hyp+ref),
    (2) fewest chunks, (3) smallest total start-distance sum|i - j|,
    (4) highest-priority match stages. Unlike greedy first-come matching
    (nltk's METEOR style), this finds the chunk-minimizing alignment that
    feeds the fragmentation penalty.
    Returns match units [(hyp_start, hyp_len, ref_start, ref_len, stage)].
    """
    cands = _candidate_matches(hyp, ref)
    if not any(cands):
        return []

    # Partial-alignment state, extended one hypothesis position at a time
    # (matches are appended in increasing hyp order, so a chunk continues
    # iff the previous unit ends exactly where this one begins, both sides):
    #   (used_ref_bitmask, matches, next_i, last_end, covered, chunks,
    #    dist, stage_sum)
    beam = [(0, (), 0, None, 0, 0, 0, 0)]
    for i in range(len(hyp)):
        nxt = []
        for state in beam:
            used, ms, ni, last, cov, ch, dist, ss = state
            if i < ni:  # inside a span this state already matched
                nxt.append(state)
                continue
            nxt.append((used, ms, i + 1, last, cov, ch, dist, ss))  # skip i
            for unit in cands[i]:
                _, hl, j, jl, st = unit
                span_mask = ((1 << jl) - 1) << j
                if used & span_mask:
                    continue
                cont = last == (i, j)
                nxt.append((used | span_mask, ms + (unit,), i + hl,
                            (i + hl, j + jl), cov + hl + jl,
                            ch + (0 if cont else 1),
                            dist + abs(i - j), ss + st))
        nxt.sort(key=lambda s: (-s[4], s[5], s[6], s[7]))
        beam = nxt[:_ALIGN_BEAM_SIZE]
    return list(beam[0][1])


def _chunks_m(matches: List[Match]) -> int:
    """Chunk count over match units: a unit continues the previous chunk iff
    it starts exactly where the previous one ends on both sides (a multi-word
    unit is internally one contiguous run by construction)."""
    if not matches:
        return 0
    sm = sorted(matches)
    chunks = 1
    for (i1, hl1, j1, jl1, _), (i2, _, j2, _, _) in zip(sm, sm[1:]):
        if not (i2 == i1 + hl1 and j2 == j1 + jl1):
            chunks += 1
    return chunks


def _covered(matches: List[Match]) -> Tuple[int, int]:
    """(hyp words covered, ref words covered) by a match-unit set."""
    return (sum(m[1] for m in matches), sum(m[3] for m in matches))


def meteor_single(hyp: str, ref: str,
                  alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5) -> float:
    h, r = tokenize(hyp), tokenize(ref)
    if not h or not r:
        return 0.0
    matches = _align_matches(h, r)
    if not matches:
        return 0.0
    cov_h, cov_r = _covered(matches)
    m_avg = (cov_h + cov_r) / 2  # == word-match count when all units are 1:1
    precision = cov_h / len(h)
    recall = cov_r / len(r)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    frag = _chunks_m(matches) / m_avg
    penalty = gamma * (frag ** beta)
    return (1 - penalty) * fmean


def meteor_score(hyp: str, refs: Sequence[str]) -> float:
    """Max over references, as METEOR defines multi-reference scoring."""
    return max((meteor_single(hyp, r) for r in refs), default=0.0)


# METEOR 1.5 (Denkowski & Lavie 2014, "Meteor Universal") — the scorer behind
# the reference's nlg-eval model-selection metric (train_utils.py:97-111).
# The jar ships a corpus-frequency-derived English function-word list; this
# embedded closed-class set (articles, prepositions, conjunctions, pronouns,
# auxiliaries, common adverbial particles) approximates it.
_FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either neither
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
yourselves themselves who whom whose which what
in on at by for with about against between into through during before after
above below to from up down of off over under again further once out
and or but nor so yet if then else when while as because although though
since unless until whether than
is am are was were be been being have has had having do does did doing
will would shall should may might must can could
not n't no nor never
there here very just only also too quite rather
's 'm 're 've 'll 'd . , ! ? ; : " ' ( )
""".split())

# English 'rank'-task parameters from the Meteor 1.5 distribution:
# alpha=.85 beta=.2 gamma=.6 delta=.75; matcher weights exact=1.0 stem=0.6
# synonym=0.8 paraphrase=0.6 (`-w '1.0 0.6 0.8 0.6'`). The synonym and
# paraphrase STAGES are implemented; their data files (WordNet synsets /
# paraphrase-en) are not shipped, so they stay inert until a table is
# installed via set_meteor_resources.
_M15_STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)


def meteor15_single(hyp: str, ref: str, alpha: float = 0.85, beta: float = 0.2,
                    gamma: float = 0.6, delta: float = 0.75) -> float:
    """METEOR 1.5 English scoring formula:

        P = Σ_i w_i·(δ·m_i(h_c) + (1−δ)·m_i(h_f)) / (δ·|h_c| + (1−δ)·|h_f|)
        R = likewise over the reference
        Fmean = P·R / (α·P + (1−α)·R)
        Pen = γ·(chunks / matches)^β
        score = (1 − Pen)·Fmean

    where h_c/h_f split the hypothesis into content/function words, m_i(·)
    counts words covered by stage-i match units (exact, stem, synonym,
    paraphrase — the latter two only when resources are installed), and
    `matches` is the hyp/ref average of covered words (they differ only for
    unequal-length paraphrase spans)."""
    h, r = tokenize(hyp), tokenize(ref)
    if not h or not r:
        return 0.0
    matches = _align_matches(h, r)
    if not matches:
        return 0.0

    def weighted(tokens, matched):  # matched: {idx: stage}
        num = sum(_M15_STAGE_WEIGHTS[st]
                  * (delta if tokens[i] not in _FUNCTION_WORDS else 1 - delta)
                  for i, st in matched.items())
        den = sum(delta if t not in _FUNCTION_WORDS else 1 - delta
                  for t in tokens)
        return num, den

    h_matched = {i + k: st for i, hl, _, _, st in matches for k in range(hl)}
    r_matched = {j + k: st for _, _, j, jl, st in matches for k in range(jl)}
    h_num, h_den = weighted(h, h_matched)
    r_num, r_den = weighted(r, r_matched)
    if h_den == 0 or r_den == 0:
        return 0.0
    p, rec = h_num / h_den, r_num / r_den
    if p == 0 or rec == 0:
        return 0.0
    fmean = p * rec / (alpha * p + (1 - alpha) * rec)
    cov_h, cov_r = _covered(matches)
    pen = gamma * (_chunks_m(matches) / ((cov_h + cov_r) / 2)) ** beta
    return (1 - pen) * fmean


def meteor15_score(hyp: str, refs: Sequence[str]) -> float:
    """Max over references (multi-reference METEOR)."""
    return max((meteor15_single(hyp, r) for r in refs), default=0.0)


def batch_meteor(hyps: Sequence[str], refs_list: Sequence[Sequence[str]],
                 scorer=meteor15_score) -> float:
    """Average per-sample METEOR over a batch — the reference's aggregation
    (train_utils.py:97-111). Defaults to the METEOR-1.5 scorer, matching the
    reference's nlg-eval jar semantics as closely as its data allows."""
    if not hyps:
        return 0.0
    return sum(scorer(h, rs) for h, rs in zip(hyps, refs_list)) / len(hyps)


# ---------------------------------------------------------------- BLEU

def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4_score(hyp: str, refs: Sequence[str], max_n: int = 4,
                smooth: bool = True) -> float:
    """Smoothed sentence BLEU-4 (add-epsilon smoothing on zero counts)."""
    h = tokenize(hyp)
    refs_tok = [tokenize(r) for r in refs]
    if not h:
        return 0.0
    log_precisions = 0.0
    for n in range(1, max_n + 1):
        h_ngrams = _ngrams(h, n)
        max_ref: Counter = Counter()
        for rt in refs_tok:
            for g, c in _ngrams(rt, n).items():
                max_ref[g] = max(max_ref[g], c)
        clipped = sum(min(c, max_ref[g]) for g, c in h_ngrams.items())
        total = max(sum(h_ngrams.values()), 1)
        if clipped == 0:
            if not smooth:
                return 0.0
            p = 1.0 / (2 * total)
        else:
            p = clipped / total
        log_precisions += math.log(p) / max_n
    # brevity penalty against the closest reference length
    ref_len = min((len(rt) for rt in refs_tok),
                  key=lambda rl: (abs(rl - len(h)), rl))
    bp = 1.0 if len(h) > ref_len else math.exp(1 - ref_len / max(len(h), 1))
    return bp * math.exp(log_precisions)


def corpus_bleu(hyps: Sequence[str], refs_list: Sequence[Sequence[str]],
                max_n: int = 4) -> float:
    """Corpus-level BLEU-4 (coco-caption style aggregation)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hyps, refs_list):
        h = tokenize(hyp)
        refs_tok = [tokenize(r) for r in refs]
        hyp_len += len(h)
        if refs_tok:
            ref_len += min((len(rt) for rt in refs_tok),
                           key=lambda rl: (abs(rl - len(h)), rl))
        for n in range(1, max_n + 1):
            h_ngrams = _ngrams(h, n)
            max_ref: Counter = Counter()
            for rt in refs_tok:
                for g, c in _ngrams(rt, n).items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in h_ngrams.items())
            totals[n - 1] += sum(h_ngrams.values())
    if hyp_len == 0:
        return 0.0
    log_p = 0.0
    for n in range(max_n):
        if clipped[n] == 0:
            return 0.0
        log_p += math.log(clipped[n] / max(totals[n], 1)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_p)


# ---------------------------------------------------------------- ROUGE-L

def _lcs_len(a: List[str], b: List[str]) -> int:
    """Longest-common-subsequence length, O(|a|·|b|) single-row DP."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(hyp: str, refs: Sequence[str], beta: float = 1.2) -> float:
    """Sentence ROUGE-L with coco-caption semantics (pycocoevalcap
    rouge.py calc_score): per-reference LCS precision/recall, MAX of each
    over the reference set, then F_beta with beta=1.2. The reference's
    nlg-eval harness exposes this metric (train.py:115-119 lists ROUGE_L in
    metrics_to_omit — i.e. available, deliberately skipped); externally
    anchored against Google's rouge_score package
    (same P/R; rouge_score fixes beta=1, so F is recomputed from its P/R)."""
    h = tokenize(hyp)
    if not h:
        return 0.0
    prec, rec = 0.0, 0.0
    for ref in refs:
        r = tokenize(ref)
        if not r:
            continue
        lcs = _lcs_len(r, h)
        prec = max(prec, lcs / len(h))
        rec = max(rec, lcs / len(r))
    if prec == 0.0 or rec == 0.0:
        return 0.0
    return (1 + beta ** 2) * prec * rec / (rec + beta ** 2 * prec)


def corpus_rouge_l(hyps: Sequence[str], refs_list: Sequence[Sequence[str]],
                   beta: float = 1.2) -> float:
    """Corpus ROUGE-L: mean of sentence scores (pycocoevalcap compute_score)."""
    if not hyps:
        return 0.0
    return sum(rouge_l(h, rs, beta) for h, rs in zip(hyps, refs_list)) / len(hyps)


# ------------------------------------------------- embedding-based metrics
#
# The reference's nlg-eval harness also offers three GloVe-embedding metrics
# (train.py:115-119 lists EmbeddingAverageCosineSimilairty [sic],
# VectorExtremaCosineSimilarity, GreedyMatchingScore in metrics_to_omit).
# These need only word vectors, which this framework already loads (Vocab).
# Implemented to the source papers' definitions — embedding average (Landauer
# & Dumais style mean-vector cosine), vector extrema (Forgues et al. 2014),
# greedy matching (Rus & Lintean 2012, symmetrized) — with this repo's
# multi-reference convention (max over refs, mean over corpus). nlg-eval's
# exact multi-reference column aggregation is not reproduced; SkipThoughtCS
# needs a pretrained encoder and is not offered.

def _embed_tokens(tokens: List[str], lookup) -> List:
    """lookup: word -> vector or None (OOV). Returns the non-OOV vectors."""
    vecs = []
    for t in tokens:
        v = lookup(t)
        if v is not None:
            vecs.append(v)
    return vecs


def _cosine(a, b) -> float:
    import numpy as np

    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def vocab_lookup(vocab):
    """word -> vector adapter over a Vocab (None for OOV)."""
    def lookup(word: str):
        idx = vocab.word_to_index.get(word)
        return None if idx is None else vocab.vectors[idx]
    return lookup


def embedding_average(hyp: str, refs: Sequence[str], lookup) -> float:
    """Cosine between the mean hyp word vector and the mean ref word vector,
    max over references (cosine is scale-invariant, so mean == nlg-eval's
    normalized sum)."""
    import numpy as np

    h = _embed_tokens(tokenize(hyp), lookup)
    if not h:
        return 0.0
    h_avg = np.mean(h, axis=0)
    best = 0.0
    for ref in refs:
        r = _embed_tokens(tokenize(ref), lookup)
        if r:
            best = max(best, _cosine(h_avg, np.mean(r, axis=0)))
    return best


def vector_extrema(hyp: str, refs: Sequence[str], lookup) -> float:
    """Cosine between per-dimension extrema vectors (the coordinate of max
    magnitude across the sentence's words, sign kept — Forgues et al. 2014),
    max over references."""
    import numpy as np

    def extrema(vecs):
        m = np.stack(vecs)
        hi, lo = m.max(axis=0), m.min(axis=0)
        return np.where(hi > -lo, hi, lo)

    h = _embed_tokens(tokenize(hyp), lookup)
    if not h:
        return 0.0
    h_ext = extrema(h)
    best = 0.0
    for ref in refs:
        r = _embed_tokens(tokenize(ref), lookup)
        if r:
            best = max(best, _cosine(h_ext, extrema(r)))
    return best


def greedy_matching(hyp: str, refs: Sequence[str], lookup) -> float:
    """Symmetrized greedy matching (Rus & Lintean 2012): G(a,b) = mean over
    a's words of the max cosine to any word of b; score = (G(h,r)+G(r,h))/2,
    max over references."""
    import numpy as np

    def norm_rows(vecs):
        m = np.stack(vecs).astype(np.float64)
        n = np.linalg.norm(m, axis=1, keepdims=True)
        n[n == 0.0] = 1.0
        return m / n

    h = _embed_tokens(tokenize(hyp), lookup)
    if not h:
        return 0.0
    hm = norm_rows(h)
    best = 0.0
    for ref in refs:
        r = _embed_tokens(tokenize(ref), lookup)
        if not r:
            continue
        rm = norm_rows(r)
        sims = hm @ rm.T                        # (|h|, |r|) cosines
        g_hr = float(sims.max(axis=1).mean())
        g_rh = float(sims.max(axis=0).mean())
        best = max(best, (g_hr + g_rh) / 2.0)
    return best


def corpus_embedding_metrics(hyps: Sequence[str],
                             refs_list: Sequence[Sequence[str]],
                             lookup) -> Dict[str, float]:
    """Mean-over-corpus of the three embedding metrics, one pass."""
    n = max(len(hyps), 1)
    out = {"EmbAverage": 0.0, "VectorExtrema": 0.0, "GreedyMatching": 0.0}
    for hyp, refs in zip(hyps, refs_list):
        out["EmbAverage"] += embedding_average(hyp, refs, lookup)
        out["VectorExtrema"] += vector_extrema(hyp, refs, lookup)
        out["GreedyMatching"] += greedy_matching(hyp, refs, lookup)
    return {k: v / n for k, v in out.items()}


# ---------------------------------------------------------------- CIDEr-D

def cider_d(hyps: Sequence[str], refs_list: Sequence[Sequence[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D over a corpus: tf-idf weighted n-gram cosine similarity with a
    gaussian length penalty, averaged over 1..4-grams, scaled by 10."""
    assert len(hyps) == len(refs_list)
    if not hyps:
        return 0.0

    # document frequencies from the reference sets
    doc_freq: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    refs_tok_all = []
    for refs in refs_list:
        refs_tok = [tokenize(r) for r in refs]
        refs_tok_all.append(refs_tok)
        for n in range(1, max_n + 1):
            seen = set()
            for rt in refs_tok:
                seen.update(_ngrams(rt, n).keys())
            for g in seen:
                doc_freq[n - 1][g] += 1
    num_docs = float(len(refs_list))

    def tfidf_vec(tokens: List[str], n: int) -> Tuple[Dict[tuple, float], float]:
        # RAW term counts x idf, exactly pycocoevalcap cider_scorer.py
        # counts2vec (vec[g] = float(term_freq) * (log N - log df)): CIDEr-D
        # does NOT length-normalize tf — cosine normalization cancels any
        # per-vector scale, but the min-clipped numerator does not, so a
        # tf/|c| variant skews the clip whenever hyp and ref lengths differ.
        counts = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        for g, c in counts.items():
            df = math.log(max(doc_freq[n - 1].get(g, 0), 1.0))
            w = c * (math.log(num_docs) - df)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    total = 0.0
    for hyp, refs_tok in zip(hyps, refs_tok_all):
        h = tokenize(hyp)
        score_n = [0.0] * max_n
        for n in range(1, max_n + 1):
            hv, hnorm = tfidf_vec(h, n)
            for rt in refs_tok:
                rv, rnorm = tfidf_vec(rt, n)
                # CIDEr-D: min-clipped numerator + length penalty
                num = sum(min(hv.get(g, 0.0), rv[g]) * rv[g] for g in rv)
                if hnorm > 0 and rnorm > 0:
                    sim = num / (hnorm * rnorm)
                else:
                    sim = 0.0
                delta = len(h) - len(rt)
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n - 1] += sim
            score_n[n - 1] /= max(len(refs_tok), 1)
        total += 10.0 * sum(score_n) / max_n
    return total / len(hyps)
