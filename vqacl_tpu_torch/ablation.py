"""Synthetic Table-1 surrogate on the port: Vanilla/EWC/MAS vs ER/DER vs
Ours (counterpart of ``scripts/ablation.py``).

The reference's headline benchmark is quality (paper Table 1 — SURVEY
§6): sequential finetuning forgets, parameter-importance regularizers
(EWC/MAS) reduce forgetting without memory, experience replay (ER)
recovers most accuracy, and the prototype model ("Ours") beats ER on
both final average accuracy (AP↑) and average forgetting (Forget↓).
This module reproduces the QUALITATIVE ordering end-to-end through the
port's ``VQACLTrainer`` on synthetic data with real forgetting pressure:

  - ``task_shift=1``: the SAME visual category maps to a DIFFERENT
    answer under each task, so each task's training overwrites earlier
    mappings unless the learner retains them;
  - ``category_in_text=False``: the question does NOT name the
    category, so answering requires identifying it from the VISUAL
    features — the regime where the paper's V-prototype retrieval (a
    nearest-class-mean signal appended to the encoder output) has a
    mechanism to help, as in real VQA.

All rows run the REAL pipeline — dual-level CL loop, group loaders,
exemplar buffer, the train/eval steps (on a card the encoder attention
in K1/K1′/K2, ``csrc/fused_attention_*.cu``), official VQA accuracy —
differing only in the framework's own switches:

  vanilla  memory=False  use_prototype=False    (Table 1 "Vanilla")
  ewc      〃 + cl_reg ewc                       (Table 1 "EWC")
  mas      〃 + cl_reg mas                       (Table 1 "MAS")
  er       memory=True   use_prototype=False    (Table 1 "ER")
  der      〃 + cl_reg der                       (Table 1 "DER")
  ours     memory=True   use_prototype=True     (Table 1 "Ours";
           + the SI memory loss, as in ``ROWS``)

The rows, hyperparameters, resume cache (same keys, same JSONL records),
statistics and claim criteria are ``scripts/ablation.py``'s; none is
retuned for the card. Departures: ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs the kernels' plain versions) takes
the place of the JAX platform switch; ``--md`` defaults to
``docs/ablation_torch.md``; ``--sensitivity`` defaults to no file; each
new cell also records the card (``nvidia-smi``'s name and power limit)
and the commit it ran on (``--commit``, by default git's), and the
document's header names them.

Usage: python -m vqacl_tpu_torch.ablation [--device cuda|cpu] [--tasks 5]
           [--n_train 1000] [--n_eval 500] [--epochs 3] [--m_size 100]
           [--seed 0] [--repeats 5] [--rows a,b] [--cache CELLS.jsonl]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from vqacl_tpu_torch.cl.tasks import ALL_TASKS
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.utils.config import Config, tiny_model_config
from vqacl_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SEED_LINES: list = []  # verbatim per-seed JSON, inlined into the doc
_SOURCES: dict = {}     # (card, commit) -> cells, named in the header

# args that change a cell's result — the cache key ties a stored cell to
# the exact sweep config so a resumed run can't mix configs. Keys are
# per-row: a der-α retune must not invalidate the vanilla/er/ours cells.
CFG_FIELDS = ("tasks", "n_train", "n_eval", "epochs", "m_size",
              "answer_vocab", "residue_centroids")
ROW_CFG_FIELDS = {
    "ours": ("lambda_q", "lambda_v"),
    "ewc": ("ewc_lambda", "fisher_batches"),
    "mas": ("mas_lambda", "fisher_batches"),
    "der": ("der_alpha",),
}


def cfg_key(a, row: str) -> dict:
    fields = CFG_FIELDS + ROW_CFG_FIELDS.get(row, ())
    return {f: getattr(a, f) for f in fields}


def load_cache(a) -> dict:
    """{(row, seed): result} for cells recorded under the same config, so
    an interrupted sweep resumes instead of restarting. Older cache
    records carry the full config dict; comparison uses only the fields
    relevant to that record's row."""
    cells = {}
    if a.cache and os.path.exists(a.cache):
        with open(a.cache) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    want = cfg_key(a, rec.get("row", ""))
                    got = rec.get("cfg", {})
                    if all(got.get(f) == v for f, v in want.items()):
                        cells[(rec["row"], rec["seed"])] = rec
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    # a sweep killed mid-append leaves a truncated last
                    # line; resume must survive it, not crash
                    print(f"WARNING: skipping malformed cache line "
                          f"{a.cache}:{ln} ({type(e).__name__})",
                          file=sys.stderr)
    return cells


ROWS = [
    ("vanilla", dict(memory=False, prototype=False)),
    ("ewc", dict(memory=False, prototype=False, cl_reg="ewc")),
    ("mas", dict(memory=False, prototype=False, cl_reg="mas")),
    ("er", dict(memory=True, prototype=False)),
    ("der", dict(memory=True, prototype=False, cl_reg="der")),
    # the reference ALWAYS adds the SI memory loss when replay memory is
    # on and prototypes are active (vqacl.py:448-450 adds
    # λ_Q·loss_memory_Q + λ_V·loss_memory_V whenever 'loss_memory' is in
    # results; modeling_t5_our.py:590-593 emits it iff memory=True), so
    # the Table-1 "Ours" row = prototypes + retrieval + SI anchor loss
    ("ours", dict(memory=True, prototype=True, memloss=True)),
]


def run_row(name: str, memory: bool, prototype: bool, a, seed: int,
            cl_reg: str = "none", memloss: bool = False, *,
            init_params=None, dropout_rate=None, lr=None, drive=None):
    """One (row, seed) cell on ``a.device``. ``init_params`` (the port's
    tree), ``dropout_rate`` and ``lr`` replace the seeded init, the tiny
    config's dropout and the surrogate's lr; ``drive(trainer)`` runs
    ``trainer.train()`` in the caller's stead and returns its metrics."""
    cfg = Config()
    cfg.model = tiny_model_config()
    cfg.model.vocab_size = 32200
    cfg.model.use_prototype = prototype
    if dropout_rate is not None:
        cfg.model.dropout_rate = dropout_rate
    cfg.train.memory = memory
    cfg.train.m_size = a.m_size
    cfg.train.lr = 1e-2 if lr is None else lr
    # reference-parity optimizer numerics for the quality surrogate (the
    # production default is bf16 moment storage — a perf choice; quality
    # rows should not depend on it)
    cfg.train.adam_dtype = "float32"
    cfg.train.batch_size = 16
    cfg.train.valid_batch_size = 16
    cfg.train.epochs = a.epochs
    cfg.train.seed = seed
    cfg.train.cl_reg = cl_reg
    cfg.train.use_memory_loss = memloss
    cfg.train.lambda_Q = a.lambda_q     # reference defaults (param.py:178-179)
    cfg.train.lambda_V = a.lambda_v
    if cl_reg in ("ewc", "mas"):
        cfg.train.reg_lambda = a.ewc_lambda if cl_reg == "ewc" \
            else a.mas_lambda
        cfg.train.fisher_batches = a.fisher_batches
    elif cl_reg in ("der", "derpp"):
        cfg.train.reg_lambda = a.der_alpha
    cfg.output = os.path.join(a.out, name)

    tok = VLT5Tokenizer()
    data = SyntheticDataModule(
        tok, tasks=ALL_TASKS[:a.tasks], n_train_per_task=a.n_train,
        n_val_per_task=16, n_test_per_task=a.n_eval,
        feat_dim=cfg.model.feat_dim, n_boxes=cfg.model.n_boxes,
        answer_vocab=a.answer_vocab, seed=seed, task_shift=1,
        category_in_text=False,
        residue_centroids=bool(a.residue_centroids))
    trainer = VQACLTrainer(cfg, data, tok, verbose=False,
                           dtype=torch.float32, device=a.device,
                           init_params=init_params)
    metrics = trainer.train() if drive is None else drive(trainer)
    mat = trainer.result_matrix.to_dict()
    tasks = ALL_TASKS[:a.tasks]
    diag = sum(mat[t][t] for t in tasks) / len(tasks)
    return {"row": name, "memory": memory, "prototype": prototype,
            "cl_reg": cl_reg, "memloss": memloss, "seed": seed,
            "Avg_acc": round(metrics["Avg_acc"], 3),
            "Avg_forget": round(metrics["Avg_forget"], 3),
            "diag_acc": round(diag, 3)}


def card_line(device) -> str:
    """The card as ``nvidia-smi`` names it (name, power limit), or the
    CPU's plain path."""
    if torch.device(device).type != "cuda":
        return "CPU (the kernels' plain PyTorch versions)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"


def commit_line() -> str:
    """This checkout's commit (``+ changes`` when the tree differs from
    it), or ``unknown`` outside a git checkout."""
    def git(*args):
        return subprocess.run(["git", "-C", REPO, *args],
                              capture_output=True, text=True,
                              timeout=30).stdout.strip()
    try:
        head = git("rev-parse", "--short", "HEAD")
        dirty = git("status", "--porcelain", "--untracked-files=no")
    except (OSError, subprocess.SubprocessError):
        head = ""
    if not head:
        return "unknown"
    return head + (" + changes" if dirty else "")


def _stats(xs):
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / len(xs)
    return m, math.sqrt(var)


def _paired_line(label: str, d) -> str:
    """One paired-delta bullet with its separation verdict. The SEM of
    a single pair is degenerate (population std of one delta is 0, so
    any nonzero mean would 'separate'); below 2 pairs no verdict is
    claimed."""
    dm, dsd = _stats(d)
    n = len(d)
    if n < 2:
        return (f"- paired per-seed delta, {label}: {dm:+.2f} "
                f"(n={n} — too few pairs for a verdict)")
    sem = dsd / math.sqrt(n - 1)
    sep = ("SEPARATES (paired)" if dm > 2 * sem else
           "REVERSED (paired)" if dm < -2 * sem else
           "not separated even paired")
    return (f"- paired per-seed delta, {label}: "
            f"{dm:+.2f} ± {sem:.2f} (SEM, n={n}) → {sep}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=5)
    ap.add_argument("--n_train", type=int, default=1000)
    ap.add_argument("--n_eval", type=int, default=500,
                    help="test QA per task (quantization = 100/n_eval %%)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--m_size", type=int, default=100,
                    help="exemplar buffer size. Default 100 = 10%% of "
                         "n_train per task — the reference-like regime "
                         "(its M=5000 covers ~4%% of a real task's "
                         "~130k QA)")
    ap.add_argument("--answer_vocab", type=int, default=4)
    ap.add_argument("--residue_centroids", type=int, default=1,
                    help="cluster category centroids by answer residue "
                         "so the visual signal is learnable within the "
                         "surrogate's step budget (see synthetic_module)")
    ap.add_argument("--lambda_q", type=float, default=0.01,
                    help="SI memory-loss weight for the 'ours' row "
                         "(reference param.py:178)")
    ap.add_argument("--lambda_v", type=float, default=0.1,
                    help="SI memory-loss weight for the 'ours' row "
                         "(reference param.py:179)")
    ap.add_argument("--ewc_lambda", type=float, default=100.0)
    ap.add_argument("--mas_lambda", type=float, default=1.0)
    ap.add_argument("--der_alpha", type=float, default=50.0,
                    help="DER distillation weight α, as scripts/ablation.py "
                         "retuned it for the surrogate (its --help holds "
                         "the sweep); not retuned here")
    ap.add_argument("--fisher_batches", type=int, default=10)
    ap.add_argument("--rows", default=None,
                    help="comma list to run a subset (e.g. ewc,mas); the "
                         "document is not rewritten")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5,
                    help="seeds per row (mean ± std reported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs: cuda (the kernels; "
                         "raises without a card) or cpu (their plain "
                         "versions)")
    ap.add_argument("--sensitivity", default=None,
                    help="cells.jsonl of a sweep at another buffer size; "
                         "rendered as a computed buffer-regime "
                         "sensitivity section")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "ablation"))
    ap.add_argument("--cache", default=None,
                    help="JSONL of completed cells (default "
                         "<out>/cells.jsonl); cells recorded under the "
                         "same config are reused instead of re-run, so "
                         "an interrupted sweep resumes")
    ap.add_argument("--md", default=os.path.join(REPO, "docs",
                                                 "ablation_torch.md"))
    ap.add_argument("--commit", default=None,
                    help="the commit recorded with each new cell (default: "
                         "this checkout's, from git)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    a = parse_args(argv)
    resolve_device(a.device)            # no card: raise before any work
    _SEED_LINES.clear()
    _SOURCES.clear()
    if a.cache is None:
        a.cache = os.path.join(a.out, "cells.jsonl")
    os.makedirs(a.out, exist_ok=True)
    cached = load_cache(a)
    if cached:
        print(f"resuming: {len(cached)} cached cells in {a.cache}",
              flush=True)
    card = commit = None

    rows = ROWS if not a.rows else \
        [r for r in ROWS if r[0] in a.rows.split(",")]
    # run claim-critical rows first so an interrupted sweep still leaves
    # a meaningful (incrementally rewritten) document
    prio = {"vanilla": 0, "er": 1, "ours": 2, "ewc": 3, "mas": 4, "der": 5}
    run_order = sorted(rows, key=lambda r: prio.get(r[0], 9))
    results = {}
    for name, sw in run_order:
        accs, fgts = [], []
        for r in range(a.repeats):
            res = cached.get((name, a.seed + r))
            if res is None:
                if card is None:
                    card = card_line(a.device)
                    commit = a.commit or commit_line()
                t0 = time.time()
                res = run_row(name, sw["memory"], sw["prototype"], a,
                              seed=a.seed + r,
                              cl_reg=sw.get("cl_reg", "none"),
                              memloss=sw.get("memloss", False))
                res["wall_s"] = round(time.time() - t0, 1)
                res["card"] = card
                res["commit"] = commit
                with open(a.cache, "a") as f:
                    f.write(json.dumps(
                        {**res, "cfg": cfg_key(a, name)}) + "\n")
            print(json.dumps(res), flush=True)
            accs.append(res["Avg_acc"])
            fgts.append(res["Avg_forget"])
            src = (res.get("card", "not recorded"),
                   res.get("commit", "not recorded"))
            _SOURCES[src] = _SOURCES.get(src, 0) + 1
            _SEED_LINES.append(json.dumps(
                {k: v for k, v in res.items() if k != "cfg"}))
        results[name] = (sw, accs, fgts)
        if not a.rows:
            write_doc(a, results)
            print(f"wrote {a.md} ({len(results)}/{len(ROWS)} rows)",
                  flush=True)
    if a.rows:
        print("(subset run — the document is not rewritten)")


def _sensitivity_lines(a) -> list:
    """Buffer-regime sensitivity: render another sweep's cells.jsonl
    (e.g. the M=500 saturated-replay regime) as a second COMPUTED table
    — same claim criterion, no hand-quoted numbers, so this section
    cannot drift from its data any more than the headline can."""
    if not a.sensitivity or not os.path.exists(a.sensitivity):
        return []
    by_row, m_sizes, n_trains = {}, set(), set()
    with open(a.sensitivity) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            by_row.setdefault(rec["row"], []).append(rec)
            m_sizes.add(rec.get("cfg", {}).get("m_size"))
            n_trains.add(rec.get("cfg", {}).get("n_train"))
    if not by_row:
        return []
    m_desc = "/".join(str(m) for m in sorted(x for x in m_sizes
                                             if x is not None))
    # coverage must use the sweep file's OWN n_train (its cfg records
    # carry it), not this run's — the two sweeps can differ
    nts = sorted(x for x in n_trains if x)
    nt = nts[0] if len(nts) == 1 else a.n_train
    out = [
        "",
        f"## Buffer-regime sensitivity (same sweep at M={m_desc})",
        "",
        f"Rendered from `{os.path.relpath(a.sensitivity)}` "
        "(per-seed cells of a prior sweep; all statistics below are "
        "computed from that file at generation time). At "
        f"M={m_desc} the buffer covers "
        f"{'/'.join(f'{100 * m / nt:.0f}%' for m in sorted(x for x in m_sizes if x))} "
        "of each task's train data — replay alone nearly solves the "
        "surrogate, so the prototype margin has no room to show "
        "(ceiling regime). The headline config above uses "
        f"M={a.m_size} ({100 * a.m_size / a.n_train:.0f}% coverage), "
        "closer to the reference's ~4% (M=5000 over ~130k QA/task).",
        "",
        "| row | seeds | AP (Avg_acc) ↑ | Forget ↓ |",
        "|---|---|---|---|",
    ]
    for name, _ in ROWS:
        recs = sorted(by_row.get(name, []), key=lambda r: r["seed"])
        if not recs:
            continue
        am, asd = _stats([r["Avg_acc"] for r in recs])
        fm, fsd = _stats([r["Avg_forget"] for r in recs])
        out.append(f"| {name} | {len(recs)} | {am:.2f} ± {asd:.2f} | "
                   f"{fm:.2f} ± {fsd:.2f} |")
    if {"ours", "er"} <= set(by_row):
        o = sorted(by_row["ours"], key=lambda r: r["seed"])
        e = sorted(by_row["er"], key=lambda r: r["seed"])
        es = {r["seed"]: r for r in e}
        pairs = [(r, es[r["seed"]]) for r in o if r["seed"] in es]
        out.append("")
        out.append(_paired_line(
            "AP (ours − er)",
            [ro["Avg_acc"] - re["Avg_acc"] for ro, re in pairs]))
        out.append(_paired_line(
            "Forget (er − ours)",
            [re["Avg_forget"] - ro["Avg_forget"] for ro, re in pairs]))
    return out


def write_doc(a, results) -> None:
    # ---- computed claim checks (the doc can't drift from the data) ----
    def mean_std(name):
        _, accs, fgts = results[name]
        return _stats(accs), _stats(fgts)

    def separated(hi, lo):
        """mean(hi) > mean(lo) with the gap clearing 1 combined std."""
        return hi[0] - lo[0] > hi[1] + lo[1]

    claims = []

    def claim(text, hi, lo):
        """hi should beat lo: PASS / REVERSED (lo wins, separated) /
        NOT SEPARATED (within 1 combined σ)."""
        status = ("PASS" if separated(hi, lo) else
                  "REVERSED" if separated(lo, hi) else "NOT SEPARATED")
        claims.append((text, status))

    have = set(results)
    if {"ours", "vanilla"} <= have:
        (ap_ours, fg_ours) = mean_std("ours")
        (ap_van, fg_van) = mean_std("vanilla")
        claim("Ours beats Vanilla on AP (gap > 1 combined σ)",
              ap_ours, ap_van)
        claim("Ours beats Vanilla on Forget (gap > 1 combined σ)",
              fg_van, fg_ours)
    if {"ours", "er"} <= have:
        (ap_ours, fg_ours) = mean_std("ours")
        (ap_er, fg_er) = mean_std("er")
        claim("Ours beats ER on AP (gap > 1 combined σ)", ap_ours, ap_er)
        claim("Ours beats ER on Forget (gap > 1 combined σ)",
              fg_er, fg_ours)
    if {"er", "vanilla"} <= have:
        claim("Replay (ER) beats Vanilla on AP (gap > 1 combined σ)",
              mean_std("er")[0], mean_std("vanilla")[0])
    # regularizer-row orderings from the paper's Table 1 (BASELINE.md):
    # ER 36.99 ≫ EWC 15.77 ≈ Vanilla 14.49; DER 35.35 ≫ Vanilla 14.49
    if {"er", "ewc"} <= have:
        claim("Replay (ER) beats EWC on AP (paper: 36.99 vs 15.77)",
              mean_std("er")[0], mean_std("ewc")[0])
    if {"der", "vanilla"} <= have:
        claim("DER beats Vanilla on AP (paper: 35.35 vs 14.49)",
              mean_std("der")[0], mean_std("vanilla")[0])
        claim("DER beats Vanilla on Forget (paper: 8.62 vs 30.80)",
              mean_std("vanilla")[1], mean_std("der")[1])
    n_cells = a.tasks * (a.tasks + 1) // 2
    sources = [f"{card} at commit {commit} ({n} cells)"
               for (card, commit), n in _SOURCES.items()]
    lines = [
        "# Synthetic Table-1 surrogate on the PyTorch port "
        "(qualitative ordering check)",
        "",
        "The same surrogate as `ABLATION.md` (`scripts/ablation.py`, the",
        "JAX package), run through the PyTorch port's `VQACLTrainer`: the",
        "FULL pipeline (dual-level CL loop, exemplar buffer, EWC/MAS",
        "consolidation, DER logit capture+distillation, the train/eval",
        "steps with the encoder attention in the hand-written kernels",
        "K1/K1′/K2 on a card, official VQA accuracy) on synthetic data",
        "with task-dependent answer mappings (`task_shift=1`) so",
        "sequential finetuning actually forgets, and with the category",
        "visible ONLY in the visual features (`category_in_text=False`)",
        "so prototype retrieval has signal to add. Category centroids",
        "cluster by answer residue (`residue_centroids`) so the visual",
        "signal is learnable inside the surrogate's ~100-step-per-task",
        "budget. Produced by `python -m vqacl_tpu_torch.ablation`; the",
        "claim checks below are COMPUTED from the measured numbers at",
        "generation time, with the JAX script's hyperparameters and",
        "criteria, nothing retuned.",
        "",
        "Measured on: " + ("; ".join(sources) or "no cells yet") + ".",
        "",
        f"Config: {a.tasks} tasks × {a.n_train} train QA, epochs "
        f"{a.epochs}, M={a.m_size}, {a.n_eval} test QA/task "
        f"({n_cells} matrix cells, quantization "
        f"{100.0 / a.n_eval:.2f}%), λ_EWC={a.ewc_lambda:g}, "
        f"λ_MAS={a.mas_lambda:g}, α_DER={a.der_alpha:g} (retuned on "
        f"the surrogate — the DER paper's 0.5 targets CIFAR-scale "
        f"logits; 1-seed sweep in scripts/ablation.py --help), "
        f"λ_Q={a.lambda_q:g}/λ_V={a.lambda_v:g} (ours row, SI memory "
        f"loss as in the reference), tiny model, f32, "
        f"{a.repeats} seeds, task_shift=1, category_in_text=False, "
        f"residue_centroids={bool(a.residue_centroids)}.",
        "",
        "| row | replay | prototypes | reg | AP (Avg_acc) ↑ | Forget ↓ |",
        "|---|---|---|---|---|---|",
    ]
    for name, _ in ROWS:
        if name not in results:
            continue
        sw, accs, fgts = results[name]
        (am, asd), (fm, fsd) = _stats(accs), _stats(fgts)
        lines.append(
            f"| {name} | {'✓' if sw['memory'] else '—'} | "
            f"{'✓' if sw['prototype'] else '—'} | "
            f"{sw.get('cl_reg', '—') if sw.get('cl_reg') else '—'} | "
            f"{am:.2f} ± {asd:.2f} | {fm:.2f} ± {fsd:.2f} |")
    lines += ["", "## Claims checked (paper Table 1 ordering, "
                  "BASELINE.md)", ""]
    for text, status in claims:
        lines.append(f"- {status}: {text}")
    n_pass = sum(1 for _, s in claims if s == "PASS")
    n_rev = sum(1 for _, s in claims if s == "REVERSED")
    lines += [
        "",
        f"{n_pass}/{len(claims)} claims hold at this scale"
        + (f"; {n_rev} reversed" if n_rev else "") + ". "
        + ("(No claim-pair rows completed yet.)" if not claims else
           "All checked orderings reproduce with separated error bars."
           if n_pass == len(claims) else
           "NOT SEPARATED = within 1 combined σ at "
           f"{a.repeats} seeds (not distinguished, not contradicted); "
           "REVERSED = the opposite ordering holds with separated "
           "error bars in this SYNTHETIC regime — an honest limit of "
           "the surrogate, discussed below."),
        "",
    ]
    # ---- surrogate power analysis: the minimum gap the 1-combined-σ
    # criterion can detect at this seed count, vs the paper's actual
    # Table-1 margin mapped onto the surrogate's scale ----
    if {"ours", "er"} <= have:
        ap_ours, fg_ours = mean_std("ours")     # each = (mean, std)
        ap_er, fg_er = mean_std("er")
        mdg_ap = ap_ours[1] + ap_er[1]
        mdg_fg = fg_ours[1] + fg_er[1]
        # paper Table 1 (BASELINE.md): Ours 38.77 AP vs ER 36.99 AP
        # (+4.8 % relative); Forget 3.96 vs 5.99 (−33.9 % relative)
        paper_ap_gap = (38.77 - 36.99) / 36.99 * ap_er[0]
        paper_fg_gap = (5.99 - 3.96) / 5.99 * fg_er[0]
        lines += [
            "",
            "## Surrogate power analysis (Ours vs ER)",
            "",
            "The claim criterion is mean-gap > 1 combined σ (σ_ours + "
            "σ_er). Measured at "
            f"{a.repeats} seeds:",
            "",
            "| metric | min detectable gap | paper's Table-1 margin at "
            "this scale | detectable? |",
            "|---|---|---|---|",
            f"| AP ↑ | {mdg_ap:.2f} pts | +{paper_ap_gap:.2f} pts "
            f"(+4.8 % of ER, scaled from 38.77 vs 36.99) | "
            f"{'yes' if paper_ap_gap > mdg_ap else 'NO — underpowered'} |",
            f"| Forget ↓ | {mdg_fg:.2f} pts | −{paper_fg_gap:.2f} pts "
            f"(−33.9 % of ER, scaled from 3.96 vs 5.99) | "
            f"{'yes' if paper_fg_gap > mdg_fg else 'NO — underpowered'} |",
            "",
            "Reading: if a column-3 margin is below the column-2 "
            "detection floor, a NOT SEPARATED verdict above is the "
            "expected outcome even when the paper-sized effect is real "
            "— the tie is a measured power limit of the surrogate at "
            "this seed count, not evidence against the mechanism. If "
            "the margin clears the floor and the verdict is still NOT "
            "SEPARATED, the surrogate genuinely does not reproduce the "
            "margin (see the limits section below). A PASS verdict "
            "while the paper-scale margin sits under the floor means "
            "the surrogate's measured effect is LARGER than the "
            "paper's relative margin — expected when the buffer is "
            "small enough that replay alone cannot span the visual "
            "categories, so prototype retrieval carries more of the "
            "answer signal than it does on real VQA v2 (qualitative "
            "ordering evidence, not a quantitative margin match).",
        ]
        # paired per-seed analysis: ours and er share each seed's data
        # and task sequence, so the same-seed delta removes the (large)
        # between-seed variance — the strongest honest test available
        _, accs_o, fgts_o = results["ours"]
        _, accs_e, fgts_e = results["er"]
        n = min(len(accs_o), len(accs_e))
        lines.append("")
        lines.append(_paired_line(
            "AP (ours − er)", [accs_o[i] - accs_e[i] for i in range(n)]))
        lines.append(_paired_line(
            "Forget (er − ours)",
            [fgts_e[i] - fgts_o[i] for i in range(n)]))
    lines += [
        "",
        "Per-seed values of the headline table above (diag_acc = mean "
        "matrix diagonal, i.e. accuracy right after training each task; "
        "wall_s on the host clock):",
        "",
        "```",
        *_SEED_LINES,
        "```",
    ]
    lines += _sensitivity_lines(a)
    lines += [
        "",
        "## What this surrogate can and cannot show",
        "",
        "It CAN show, end-to-end through the port's trainer on the card:",
        "sequential finetuning catastrophically forgets under",
        "task-dependent answer mappings; experience replay recovers most",
        "of it; the EWC/MAS/DER regularizers and the SS/SI prototype",
        "machinery (retrieval + EMA banks + the reference's λ_Q/λ_V SI",
        "anchor loss) run and train. Whether the paper's 'Ours beats ER'",
        "margin reproduces here is exactly what the computed claim checks",
        "+ power analysis above report — do not quote an ordering from",
        "this section; quote those. The paper's full margin lives on REAL",
        "visual category structure over 80 COCO classes; quantitatively",
        "validating Table 1 itself requires the real VQA v2 artifacts",
        "(absent in this environment — see PARITY.md).",
        "",
    ]
    with open(a.md, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {a.md}")


if __name__ == "__main__":
    main()
