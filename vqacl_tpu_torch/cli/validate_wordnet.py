"""Validate the WUPS word-similarity backend and its vocabulary coverage.

(Counterpart of ``vqacl_tpu/cli/validate_wordnet.py``: the same probe
set, flags and output lines.)

The reference's NExT-QA eval scores WUPS over NLTK's *full* WordNet
noun inventory (``VL-T5/nextqa/nextqa_data.py:994-1008``).
This framework resolves the similarity source at runtime
(``evaluation/wups.py``): NLTK corpus → directly-parsed WNdb files
(``VQACL_WORDNET_DB`` or ``<repo>/data/wordnet/``) → vendored taxonomy
subgraph with exact-match fallback. This CLI makes that resolution — and
how much of an answer vocabulary the active backend actually knows —
visible in one step:

    python -m vqacl_tpu_torch.cli.validate_wordnet [DB_DIR] \
        [--answers answers.txt | --csv nextqa_train.csv ...]

With DB_DIR pointing at the public-domain WordNet 3.0 database files
(``index.noun``+``data.noun``, i.e. the contents of
``nltk_data/corpora/wordnet/`` or the WNdb tarball), expected output is
``backend: wndb-files`` with coverage 1.0 over the NExT-QA answer
vocabulary. With no corpus anywhere, it reports the vendored-taxonomy
backend and the (lower) coverage that eval-time telemetry
(``wups_vocab_coverage``) will show.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys


# Representative NExT-QA open-ended answers (frequent answers across the
# causal/temporal/descriptive splits) — the default probe set when no
# --answers/--csv vocabulary is supplied.
DEFAULT_PROBE = """
baby dog cat man woman girl boy child lady toy ball car bike camera
phone table chair floor ground grass water food cake milk bottle book
guitar piano drum swing slide stroller blanket towel shirt hat shoe
playing eating drinking walking running jumping sitting standing
sleeping crying laughing smiling dancing singing talking watching
holding pushing pulling throwing catching climbing falling riding
feeding cooking reading writing pointing waving clapping hugging
kitchen bedroom park beach playground street room house garden pool
happy sad excited scared tired hungry red blue green yellow white
black two three four five
""".split()


def load_vocab(args) -> list[str]:
    words: list[str] = []
    if args.answers:
        with open(args.answers) as f:
            words = [w for line in f for w in line.strip().lower().split()]
    elif args.csv is not None:
        if not args.csv:
            # e.g. --csv $(ls missing*.csv) with no matches: silently
            # validating the built-in probe would report bogus success
            raise SystemExit("--csv given but no files listed")
        for path in args.csv:
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    words.extend(str(row["answer"]).lower().split())
    else:
        words = list(DEFAULT_PROBE)
    return sorted(set(words))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("db_dir", nargs="?", default=None,
                    help="directory with index.noun/data.noun (sets "
                         "VQACL_WORDNET_DB for this check)")
    ap.add_argument("--answers", default=None,
                    help="text file of answers (whitespace-tokenized)")
    ap.add_argument("--csv", nargs="*", default=None,
                    help="NExT-QA csv(s) with an 'answer' column")
    args = ap.parse_args(argv)

    if args.db_dir:
        os.environ["VQACL_WORDNET_DB"] = args.db_dir
    # import AFTER the env var is set — backend resolution is cached
    from vqacl_tpu_torch.evaluation import wups
    from vqacl_tpu_torch.evaluation.wordnet_db import find_db_dir

    backend = wups.wups_backend()
    print(f"backend: {backend}")
    if backend == "wndb-files":
        print(f"wndb dir: {find_db_dir()}")
    elif args.db_dir:
        print(f"WARNING: {args.db_dir} did not resolve to a WNdb backend "
              f"(need index.noun + data.noun in the directory); "
              f"running on '{backend}' instead", file=sys.stderr)

    vocab = load_vocab(args)
    content = [w for w in vocab if w not in wups.STOPWORDS]
    known = [w for w in content if wups.word_in_vocab(w)]
    oov = [w for w in content if not wups.word_in_vocab(w)]
    cov = len(known) / max(len(content), 1)
    src = ("--answers" if args.answers else
           "--csv" if args.csv else "built-in probe set")
    print(f"vocab: {len(vocab)} words ({src}), "
          f"{len(content)} after stopword filter")
    print(f"coverage: {cov:.3f} ({len(known)}/{len(content)} known to "
          f"the backend; OOV pairs degrade to exact-token match)")
    if oov:
        print(f"oov sample: {' '.join(oov[:15])}")
    return 0 if cov == 1.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
