"""The port's WUPS evaluation (``evaluation/taxonomy.py``,
``wordnet_db.py``, ``wups.py``, ``cli/validate_wordnet.py``) against the
JAX package's.

The vendored taxonomy gives the same graph and the same Wu-Palmer
values over every pair of its vocabulary; ``WordNetDB`` over WNdb files
written from that graph (``tests/test_wordnet_db.py``'s writer) the same
depths and similarities; the backend resolution (taxonomy without files,
``wndb-files`` with ``VQACL_WORDNET_DB``), ``word_in_vocab``,
``get_wups`` with its coverage counts, the stopwords and
``remove_stopwords`` the same values under each backend; and
``validate_wordnet`` the same output lines and exit code as the JAX
CLI, run as a user runs it (a subprocess: the backend is resolved once
per process).
"""

import itertools
import os
import subprocess
import sys

import pytest

from test_wordnet_db import write_wndb_from_taxonomy
from vqacl_tpu.evaluation import taxonomy as JT
from vqacl_tpu.evaluation import wordnet_db as JDB
from vqacl_tpu.evaluation import wups as JW
from vqacl_tpu_torch.evaluation import taxonomy as TT
from vqacl_tpu_torch.evaluation import wordnet_db as TDB
from vqacl_tpu_torch.evaluation import wups as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTENCES = ["dog", "the cat", "man walking dog", "baby playing ball",
             "red car", "zzyzx", "a woman", "sofa couch", "two", ""]


def test_taxonomy_graph_and_all_pairs_match_jax():
    assert TT.PARENTS == JT.PARENTS and TT.LEMMAS == JT.LEMMAS
    vocab = TT.vocabulary()
    assert vocab == JT.vocabulary() and len(vocab) > 100
    for s in TT.PARENTS:
        assert TT.max_depth(s) == JT.max_depth(s)
        assert TT.min_depth(s) == JT.min_depth(s)
    for a, b in itertools.product(vocab, repeat=2):
        assert TT.word_similarity(a, b) == JT.word_similarity(a, b), (a, b)
    names = sorted(TT.PARENTS)
    for a, b in itertools.product(names[::3], names[1::3]):
        assert TT.wup(a, b) == JT.wup(a, b), (a, b)


@pytest.fixture()
def wndb(tmp_path):
    write_wndb_from_taxonomy(str(tmp_path))
    return str(tmp_path)


def test_wordnet_db_matches_jax(wndb):
    t, j = TDB.WordNetDB(wndb), JDB.WordNetDB(wndb)
    assert t.parents == j.parents and t.lemma_index == j.lemma_index
    for s in t.parents:
        assert t.max_depth(s) == j.max_depth(s)
        assert t.min_depth(s) == j.min_depth(s)
    vocab = [w.replace(" ", "_") for w in TT.vocabulary()]
    for a, b in itertools.product(vocab[::2], vocab[1::2]):
        assert t.word_similarity(a, b) == j.word_similarity(a, b), (a, b)
    assert t.word_similarity("cat", "dog") == pytest.approx(24 / 28)


def test_db_dir_candidates_match_jax(wndb, monkeypatch, tmp_path):
    """``VQACL_WORDNET_DB`` first, then ``<repo>/data/wordnet``, then
    NLTK's search paths: the same places in both packages."""
    monkeypatch.setenv("VQACL_WORDNET_DB", wndb)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert list(TDB._candidate_dirs()) == list(JDB._candidate_dirs())
    assert list(TDB._candidate_dirs())[:2] == [
        wndb, os.path.join(REPO, "data", "wordnet")]
    assert TDB.find_db_dir() == JDB.find_db_dir() == wndb


def _clear(mod, db):
    db.get_db.cache_clear()
    mod.word_in_vocab.cache_clear()
    mod.word_similarity.cache_clear()


def _wups_values(mod):
    out = []
    for a, b in itertools.product(SENTENCES, repeat=2):
        cov = [0, 0]
        out.append((mod.get_wups(a, b, 0.0, coverage=cov),
                    mod.get_wups(a, b, 0.9), tuple(cov)))
    return out


@pytest.mark.parametrize("backend", ["vendored-taxonomy", "wndb-files"])
def test_backend_and_get_wups_match_jax(backend, wndb, monkeypatch,
                                        tmp_path):
    if TW.wordnet_available() or JW.wordnet_available():
        pytest.skip("a real NLTK WordNet corpus is installed: the backend "
                    "order prefers it")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("VQACL_WORDNET_DB", wndb if backend == "wndb-files"
                       else str(tmp_path / "none"))
    for mod, db in ((TW, TDB), (JW, JDB)):
        _clear(mod, db)
    try:
        if backend == "vendored-taxonomy" and JDB.find_db_dir() is not None:
            pytest.skip("WNdb files lie on a default search path")
        assert TW.wups_backend() == JW.wups_backend() == backend
        for w in ("dog", "sofa", "blue", "zzyzx", "playing"):
            assert TW.word_in_vocab(w) == JW.word_in_vocab(w), w
        assert _wups_values(TW) == _wups_values(JW)
    finally:
        for mod, db in ((TW, TDB), (JW, JDB)):
            _clear(mod, db)


def test_stopwords_match_jax():
    assert TW.STOPWORDS == JW.STOPWORDS
    for s in ("the dog is on the table", "what does he do", "a", ""):
        assert TW.remove_stopwords(s) == JW.remove_stopwords(s)


def _validate(pkg, args, tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), JAX_PLATFORMS="cpu")
    env.pop("VQACL_WORDNET_DB", None)
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli.validate_wordnet", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)


@pytest.mark.parametrize("case", ["probe", "db_answers", "csv"])
def test_validate_wordnet_output_matches_jax(case, wndb, tmp_path):
    if case == "probe":
        args = []
    elif case == "db_answers":
        ans = tmp_path / "answers.txt"
        ans.write_text("dog cat\nbaby playing\nzzyzx the\n")
        args = [wndb, "--answers", str(ans)]
    else:
        path = tmp_path / "train_CW.csv"
        path.write_text("video,qid,question,answer,type,bigCate\n"
                        "1,0,why,the dog,CW,3\n2,1,what,red ball,CW,4\n")
        args = ["--csv", str(path)]
    t = _validate("vqacl_tpu_torch", args, tmp_path)
    j = _validate("vqacl_tpu", args, tmp_path)
    assert t.stdout == j.stdout and t.stdout.startswith("backend: ")
    assert t.returncode == j.returncode
    if case == "db_answers":
        assert "backend: wndb-files" in t.stdout
        assert "coverage: 0.800 (4/5" in t.stdout
