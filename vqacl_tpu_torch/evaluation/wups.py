"""WUPS scoring for NExT-QA open-ended answers (counterpart of
``vqacl_tpu/evaluation/wups.py``).

The reference imports ``get_wups`` from a ``metrix.py`` that is ABSENT
from the repo (VL-T5/nextqa/nextqa_data.py:21 — SURVEY
§2.5), so this is a reimplementation from the published definition
(Malinowski & Fritz, NeurIPS 2014; as used by NExT-QA's official
eval_oe): for token sets A (prediction) and T (ground truth),

  WUPS(A,T) = min( ∏_{a∈A} max_{t∈T} WUP'(a,t),
                   ∏_{t∈T} max_{a∈A} WUP'(a,t) )

where WUP'(a,t) = max WordNet Wu-Palmer similarity over the words'
synsets, down-weighted ×0.1 when below the threshold (NExT-QA uses
threshold 0.0 → no down-weighting, ``get_wups(..., 0)`` at
nextqa_data.py:999-1008).

Word-similarity backend resolution (full parity → graceful fallback):
1. the NLTK WordNet corpus, when importable AND its data is installed;
2. raw WNdb-3.0 database files (``index.noun``/``data.noun``), parsed
   directly by ``evaluation.wordnet_db`` — coverage == full WordNet,
   no NLTK data needed (``VQACL_WORDNET_DB`` or ``data/wordnet/``);
3. the vendored WordNet subgraph in ``evaluation.taxonomy`` (NExT-QA
   answer vocabulary, NLTK-equivalent algorithm); words outside it
   degrade to exact-token match.
The active backend is surfaced via ``wups_backend()`` and in the
evaluator's returned dict.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

from vqacl_tpu_torch.evaluation import taxonomy

_WN = None
_WN_CHECKED = False


def wordnet_available() -> bool:
    global _WN, _WN_CHECKED
    if not _WN_CHECKED:
        _WN_CHECKED = True
        try:
            from nltk.corpus import wordnet
            wordnet.synsets("dog")   # force-load; raises if corpus absent
            _WN = wordnet
        except Exception:
            _WN = None
    return _WN is not None


def _wndb():
    from vqacl_tpu_torch.evaluation import wordnet_db
    return wordnet_db.get_db()


def wups_backend() -> str:
    """Which word-similarity source WUPS is running on."""
    if wordnet_available():
        return "nltk-wordnet"
    if _wndb() is not None:
        return "wndb-files"
    return "vendored-taxonomy"


@functools.lru_cache(maxsize=131072)
def word_in_vocab(w: str) -> bool:
    """Does the active similarity backend know this word? Pairs where
    either side is out-of-vocabulary degrade to exact-token match inside
    an otherwise-real WUPS run — the evaluator reports the fraction
    (``wups_vocab_coverage``) so a degraded eval is visibly degraded."""
    if wordnet_available():
        return bool(_WN.synsets(w))
    db = _wndb()
    if db is not None:
        return bool(db.synsets(w))
    return bool(taxonomy.synsets(w))


@functools.lru_cache(maxsize=65536)
def word_similarity(a: str, b: str) -> float:
    """Max Wu-Palmer similarity over synset pairs.

    Source order: real WordNet corpus → parsed WNdb files → vendored
    taxonomy → exact match (per word pair — a covered pair scores true
    Wu-Palmer even when its neighbors in the sentence fall back)."""
    if a == b:
        return 1.0
    if wordnet_available():
        best = 0.0
        for x in _WN.synsets(a):
            for y in _WN.synsets(b):
                s = x.wup_similarity(y)
                if s is not None and s > best:
                    best = s
        return best
    db = _wndb()
    if db is not None:
        s = db.word_similarity(a, b)
        return 0.0 if s is None else s
    s = taxonomy.word_similarity(a, b)
    return 0.0 if s is None else s


def _one_side(tokens_a: Sequence[str], tokens_b: Sequence[str],
              thresh: float) -> float:
    prod = 1.0
    for a in tokens_a:
        best = max((word_similarity(a, b) for b in tokens_b), default=0.0)
        if best < thresh:
            best *= 0.1
        prod *= best
    return prod


def get_wups(pred: str, truth: str, thresh: float = 0.0,
             coverage: Optional[list] = None) -> float:
    """WUPS between two answer strings (already stopword-stripped by the
    caller, matching nextqa_data.py:986-989).

    ``coverage``, if given, is a mutable ``[covered, total]`` pair
    accumulated over the A×T word pairs this call scores: a pair counts
    covered when it is an exact match or both words are known to the
    similarity backend."""
    a = pred.split()
    t = truth.split()
    if not a or not t:
        return float(pred.strip() == truth.strip())
    if coverage is not None:
        for x in a:
            for y in t:
                coverage[1] += 1
                if x == y or (word_in_vocab(x) and word_in_vocab(y)):
                    coverage[0] += 1
    return min(_one_side(a, t, thresh), _one_side(t, a, thresh))


# NLTK English stopwords snapshot (nextqa/stopwords.txt equivalent — the
# reference ships the list as a data file, :53)
STOPWORDS = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your
yours yourself yourselves he him his himself she she's her hers herself it
it's its itself they them their theirs themselves what which who whom this
that that'll these those am is are was were be been being have has had
having do does did doing a an the and but if or because as until while of
at by for with about against between into through during before after
above below to from up down in out on off over under again further then
once here there when where why how all any both each few more most other
some such no nor not only own same so than too very s t can will just don
don't should should've now d ll m o re ve y ain aren aren't couldn
couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't haven haven't
isn isn't ma mightn mightn't mustn mustn't needn needn't shan shan't
shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
""".split())


def remove_stopwords(sentence: str) -> str:
    """nextqa_data.py:942-947 (nltk tokenize + stopword filter); plain
    split keeps it dependency-light — punctuation was already stripped
    by the VQA normalizer before this runs."""
    return " ".join(w for w in sentence.split() if w not in STOPWORDS)
