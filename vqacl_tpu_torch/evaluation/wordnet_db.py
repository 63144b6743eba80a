"""Full-WordNet backend for WUPS: parse standard WNdb database files
(counterpart of ``vqacl_tpu/evaluation/wordnet_db.py``).

The reference's NExT-QA eval scores WUPS with NLTK WordNet over the
*entire* noun inventory (nextqa_data.py:994-1008 via the repo-absent
``metrix.py``). A machine may have no corpus to download, but the
WordNet 3.0 database is public domain and ships in one canonical format
(``index.<pos>`` / ``data.<pos>`` — the "WNdb" files, identical to what
NLTK's ``nltk_data/corpora/wordnet/`` contains). This module parses
those files directly whenever they are present, giving WUPS coverage
~1.0 with zero third-party data dependencies:

  - set ``VQACL_WORDNET_DB=/path/to/dir`` (a dir containing
    ``index.noun``+``data.noun``; ``*.verb`` optional), or
  - drop the files in ``<repo>/data/wordnet/``, or
  - have any standard ``nltk_data/corpora/wordnet`` checkout around
    (all of NLTK's default search paths are probed).

Graph + Wu-Palmer algebra mirror NLTK's ``wup_similarity`` (and the
vendored ``evaluation.taxonomy``, which is a transcription of the same
graph): lcs = common hypernym maximizing min_depth, depth =
max_depth(lcs)+1, wup = 2·depth / (d1+depth + d2+depth). Tie-break
among equal-min-depth subsumers takes the max-max_depth one (NLTK takes
its name-sorted first; values coincide except in rare diamond ties —
``tests/test_wordnet_db.py`` checks NLTK equality over random pairs
when the real corpus is importable).

File format (WNDB(5)):
  index.noun:  lemma pos synset_cnt p_cnt [ptr...] sense_cnt
               tagsense_cnt offset [offset...]
  data.noun:   offset lex_filenum ss_type w_cnt (word lex_id)×w_cnt
               p_cnt (ptr_symbol offset pos src/tgt)×p_cnt ... | gloss
Hypernym pointers: ``@`` (hypernym) and ``@i`` (instance hypernym) —
NLTK's wup path uses hypernyms()+instance_hypernyms().
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import Dict, Optional, Tuple

_POS_FILES = {"n": "noun", "v": "verb"}


def _candidate_dirs():
    env = os.environ.get("VQACL_WORDNET_DB")
    if env:
        yield env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    yield os.path.join(repo, "data", "wordnet")
    # NLTK's default search paths (corpora/wordnet[31] checkouts)
    home = os.path.expanduser("~")
    bases = [os.path.join(home, "nltk_data"), "/usr/share/nltk_data",
             "/usr/local/share/nltk_data", "/usr/lib/nltk_data",
             "/usr/local/lib/nltk_data"]
    try:
        import nltk.data as _nd
        bases = list(_nd.path) + bases
    except Exception:
        pass
    for b in bases:
        for sub in ("corpora/wordnet", "corpora/wordnet31", ""):
            yield os.path.join(b, sub) if sub else b


def find_db_dir() -> Optional[str]:
    """First directory containing index.noun + data.noun, else None."""
    for d in _candidate_dirs():
        if (os.path.isfile(os.path.join(d, "index.noun"))
                and os.path.isfile(os.path.join(d, "data.noun"))):
            return d
    return None


class WordNetDB:
    """Hypernym DAG + lemma index parsed from WNdb files.

    Synset keys are ``"<pos><offset>"`` strings (offsets are unique per
    POS file only). Wu-Palmer runs within one POS; cross-POS pairs have
    no common subsumer and score None, matching NLTK.
    """

    def __init__(self, db_dir: str):
        self.dir = db_dir
        self.parents: Dict[str, Tuple[str, ...]] = {}
        self.lemma_index: Dict[str, Tuple[str, ...]] = {}
        for pos, fname in _POS_FILES.items():
            data = os.path.join(db_dir, f"data.{fname}")
            index = os.path.join(db_dir, f"index.{fname}")
            if os.path.isfile(data):
                self._parse_data(data, pos)
            if os.path.isfile(index):
                self._parse_index(index, pos)
        # per-instance caches (lru_cache on methods would leak instances)
        self._max_depth: Dict[str, int] = {}
        self._min_depth: Dict[str, int] = {}
        self._anc_cache: Dict[str, Dict[str, int]] = {}

    # ---- parsing ------------------------------------------------------
    def _parse_data(self, path: str, pos: str) -> None:
        parents = self.parents
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("  ") or not line.strip():
                    continue  # license header lines
                body = line.split("|", 1)[0].split()
                off = pos + body[0]
                w_cnt = int(body[3], 16)
                i = 4 + 2 * w_cnt
                p_cnt = int(body[i])
                i += 1
                hyps = []
                for _ in range(p_cnt):
                    sym, tgt_off, tgt_pos = body[i], body[i + 1], body[i + 2]
                    i += 4  # symbol offset pos source/target
                    if sym in ("@", "@i") and tgt_pos == pos:
                        hyps.append(tgt_pos + tgt_off)
                parents[off] = tuple(hyps)

    def _parse_index(self, path: str, pos: str) -> None:
        idx = self.lemma_index
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("  ") or not line.strip():
                    continue
                parts = line.split()
                lemma = parts[0]
                synset_cnt = int(parts[2])
                p_cnt = int(parts[3])
                offsets = parts[6 + p_cnt: 6 + p_cnt + synset_cnt]
                idx[lemma] = idx.get(lemma, ()) + tuple(
                    pos + o for o in offsets)

    # ---- graph algebra (same recurrences as evaluation.taxonomy) ------
    def max_depth(self, s: str) -> int:
        hit = self._max_depth.get(s)
        if hit is not None:
            return hit
        # iterative (WordNet noun chains reach depth ~19; recursion is
        # fine, but avoid surprises on cyclic/corrupt inputs)
        stack = [s]
        while stack:
            top = stack[-1]
            ps = self.parents.get(top, ())
            pending = [p for p in ps if p not in self._max_depth]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            self._max_depth[top] = (
                1 + max(self._max_depth[p] for p in ps)) if ps else 0
        return self._max_depth[s]

    def min_depth(self, s: str) -> int:
        hit = self._min_depth.get(s)
        if hit is not None:
            return hit
        stack = [s]
        while stack:
            top = stack[-1]
            ps = self.parents.get(top, ())
            pending = [p for p in ps if p not in self._min_depth]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            self._min_depth[top] = (
                1 + min(self._min_depth[p] for p in ps)) if ps else 0
        return self._min_depth[s]

    def _ancestor_dists(self, s: str) -> Dict[str, int]:
        hit = self._anc_cache.get(s)
        if hit is not None:
            return hit
        out = {s: 0}
        frontier = [(s, 0)]
        while frontier:
            node, d = frontier.pop()
            for p in self.parents.get(node, ()):
                if p not in out or out[p] > d + 1:
                    out[p] = d + 1
                    frontier.append((p, d + 1))
        if len(self._anc_cache) < 65536:
            self._anc_cache[s] = out
        return out

    def wup(self, s1: str, s2: str) -> Optional[float]:
        if s1 not in self.parents or s2 not in self.parents:
            return None
        a1, a2 = self._ancestor_dists(s1), self._ancestor_dists(s2)
        common = set(a1) & set(a2)
        if not common:
            return None
        best_md = max(self.min_depth(c) for c in common)
        subsumers = [c for c in common if self.min_depth(c) == best_md]
        sub = max(subsumers, key=self.max_depth)
        depth = self.max_depth(sub) + 1
        return 2.0 * depth / (a1[sub] + depth + a2[sub] + depth)

    def synsets(self, word: str) -> Tuple[str, ...]:
        w = word.lower().strip().replace(" ", "_")
        return self.lemma_index.get(w, ())

    def word_similarity(self, a: str, b: str) -> Optional[float]:
        sa, sb = self.synsets(a), self.synsets(b)
        if not sa or not sb:
            return None
        best = 0.0
        for x, y in itertools.product(sa, sb):
            s = self.wup(x, y)
            if s is not None and s > best:
                best = s
        return best


@functools.lru_cache(maxsize=1)
def get_db() -> Optional[WordNetDB]:
    """Singleton: the parsed DB, or None when no WNdb files are found."""
    d = find_db_dir()
    return WordNetDB(d) if d else None
