"""Phase 14 of ``chip_smoke.py``: the protocol scripts."""

import json
import os
import shutil
import time

import numpy as np
import torch

from smoke.cl import drive_cl, record_answers
from smoke.harness import (CL_LOSS_RTOL, Context, HERE, attention, fail, log,
                           run_ranks, since)
from vqacl_tpu_torch import ablation, soak
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.ops import fused_attention as fa, launches
from vqacl_tpu_torch.utils.config import tiny_model_config

# (a) the Table-1 surrogate's rows at seed 0 with scripts/ablation.py's
# defaults (vqacl_tpu_torch.ablation: tiny widths, f32, so K1/K1′/K2 take
# their scalar f32 route), each a process of this script in rank mode,
# side by side, the argv beyond the defaults (none), and the orderings
# the rows must show as (hi, lo, metric, margin): hi's metric at least
# lo's plus the margin (Forget: lower is better, so the vanilla row is
# hi). Each margin is about half the smallest single-seed gap of
# ABLATION.md's per-seed lines (38.2, 48.5 and 23.5 points)
P14_ROWS = ("vanilla", "er", "ours")
P14_ARGV = ()
P14_ORDERINGS = (("ours", "vanilla", "Avg_acc", 20.0),
                 ("vanilla", "ours", "Avg_forget", 25.0),
                 ("er", "vanilla", "Avg_acc", 10.0))
# (b) the "ours" row cut short, on the card and on the CPU from one init
# at dropout 0: its argv, and the lr at which its per-step losses are
# held to CL_LOSS_RTOL. At the surrogate's own lr of 1e-2 the training
# amplifies f32 rounding: on the CPU alone a 1e-7 relative change of the
# init moves the cut row's losses by up to ~5e-4 within its 17 steps, at
# 1e-3 by ~1e-7 (tests/test_torch_ablation.py::
# test_cut_row_amplifies_rounding_at_the_surrogates_lr). So at 1e-2 the
# card and the CPU must give the same result matrix, answers and metrics,
# and at 1e-3 also the same losses within CL_LOSS_RTOL
P14_CUT_ARGV = ("--tasks", "2", "--n_train", "64", "--epochs", "1")
P14_CUT_LR = 1e-3
P14_DIR = os.path.join(HERE, "build", "chip_smoke", "phase14")


def p14_orderings(rows):
    """[(text, holds)] for each (hi, lo, metric, margin) of
    ``P14_ORDERINGS`` over ``rows`` ({row: its cell})."""
    out = []
    for hi, lo, metric, margin in P14_ORDERINGS:
        a, b = rows[hi][metric], rows[lo][metric]
        out.append((f"{hi} {metric} {a:.3f} >= {lo} {b:.3f} + {margin:g} "
                    f"(gap {a - b:+.3f})", bool(a - b >= margin)))
    return out


def p14_matrix_complete(matrix, n_tasks):
    """True when the lower triangle of ``matrix`` (row i: the test after
    task i) holds n(n+1)/2 evaluated, finite cells and nothing above it
    was evaluated."""
    m = np.asarray(matrix, dtype=np.float64)
    if m.shape != (n_tasks, n_tasks) or not np.isfinite(m).all():
        return False
    low = np.tril_indices(n_tasks)
    return bool((m[low] >= 0).all()
                and (m[np.triu_indices(n_tasks, 1)] == -1).all())


def p14_on_route(label, rec, route):
    """Every launch of a run (``rec["launches"]``) on ``route`` ("scalar"
    or "mma"): its launches by route, ``rec["route_launches"]``."""
    routes = rec["route_launches"]
    log(f"{label}: launches by route K1 {routes[0]} K1' {routes[1]} "
        f"K2 {routes[2]}")
    if [r[route] for r in routes] != list(rec["launches"]):
        fail(f"{label}: not every launch on the {fa.ROUTE_NAMES[route]} "
             f"route: {routes}")


def p14_cell(name, a, label, ctx=None, **kw):
    """One surrogate cell through ``ablation.run_row``, driven by
    ``drive_cl`` (with a ``ctx``, the launches counted, checked against
    the counts and recorded by route) → (its result, drive_cl's record
    with the answers of every predict)."""
    sw = dict(ablation.ROWS)[name]
    recs = {}

    def drive(trainer):
        answers = record_answers(trainer)
        before = launches.read()
        recs["rec"] = drive_cl(trainer, label, ctx)
        if ctx is not None:
            w = since(before)
            recs["rec"]["route_launches"] = [w.routes(fn)
                                             for fn in attention()]
        recs["rec"]["answers"] = answers
        return recs["rec"]["metrics"]

    t0 = time.perf_counter()
    res = ablation.run_row(name, sw["memory"], sw["prototype"], a,
                           seed=a.seed, cl_reg=sw.get("cl_reg", "none"),
                           memloss=sw.get("memloss", False), drive=drive,
                           **kw)
    res["wall_s"] = time.perf_counter() - t0
    return res, recs["rec"]


def p14_row(spec, rank):
    """Rank mode, phase 14 (a): surrogate row ``spec["rows"][rank]`` at
    seed 0 on the card, its launches checked → its record."""
    torch.set_num_threads(1)       # a tiny f32 row: the host's dispatch
    name = spec["rows"][rank]
    a = ablation.parse_args(["--device", "cuda", "--out",
                             os.path.join(spec["work"], name),
                             *spec["argv"]])
    res, rec = p14_cell(name, a, f"p14_{name}", Context())
    p14_on_route(f"p14_{name}", rec, "scalar")
    log(f"p14_{name}: Avg_acc {res['Avg_acc']} Avg_forget "
        f"{res['Avg_forget']} diag_acc {res['diag_acc']} wall "
        f"{res['wall_s']:.3f} s; launches K1/K1'/K2 "
        f"{'/'.join(map(str, rec['launches']))}")
    return {**res, **{k: rec[k] for k in (
        "launches", "expected_launches", "counts", "route_launches",
        "train_step_ms_median", "predict_batch_ms_median", "wall_share")}}


def p14_cut(ctx):
    """Phase 14 (b): the cut "ours" row on the card (counted) and on the
    CPU from one init at dropout 0, at the surrogate's lr and at
    ``P14_CUT_LR`` → record."""
    cut = ablation.parse_args(["--out", os.path.join(P14_DIR, "cut"),
                               *P14_CUT_ARGV])
    init = vlt5.init_vlt5_params(cut.seed, tiny_model_config(
        vocab_size=32200), device="cpu")
    out = {}
    for lr in (None, P14_CUT_LR):
        tag = "surrogate_lr" if lr is None else f"lr_{lr:g}"
        runs = {}
        for dev in ("cuda", "cpu"):
            cut.device = dev
            label = f"p14_cut_ours_{tag}_{dev}"
            runs[dev] = p14_cell("ours", cut, label, ctx
                                 if dev == "cuda" else None,
                                 init_params=init, dropout_rate=0.0, lr=lr)
            if dev == "cuda":
                p14_on_route(label, runs[dev][1], "scalar")
        (card_res, card), (cpu_res, cpu) = runs["cuda"], runs["cpu"]
        err = max(abs(x - y) / abs(y) for x, y in zip(card["losses"],
                                                       cpu["losses"]))
        metrics = ("Avg_acc", "Avg_forget", "diag_acc")
        same = {"steps": len(card["losses"]) == len(cpu["losses"]),
                "result_matrix": card["result_matrix"]
                == cpu["result_matrix"],
                "answers": card["answers"] == cpu["answers"],
                "metrics": [card_res[m] for m in metrics]
                == [cpu_res[m] for m in metrics]}
        held = lr is not None
        if held:
            same["losses"] = err <= CL_LOSS_RTOL
        log(f"p14 cut ours row ({' '.join(P14_CUT_ARGV)}, lr "
            f"{'1e-2 (the surrogate' + chr(39) + 's)' if lr is None else f'{lr:g}'}"
            f", dropout 0, one init), card vs CPU: {len(card['losses'])} / "
            f"{len(cpu['losses'])} steps, loss max rel err {err:.3e}"
            + (f" (tol {CL_LOSS_RTOL:g})" if held else
               " (recorded: rounding amplified at this lr)")
            + f"; equal: {json.dumps(same)}; Avg_acc {card_res['Avg_acc']}"
            f" / {cpu_res['Avg_acc']}; wall {card_res['wall_s']:.3f} / "
            f"{cpu_res['wall_s']:.3f} s")
        out[tag] = {"loss_rel_err": err, "equal": same,
                    "launches": card["launches"], "counts": card["counts"],
                    "expected_launches": card["expected_launches"],
                    "card": card_res, "cpu": cpu_res}
        if not all(same.values()):
            fail(f"p14: the cut ours row ({tag}) on the card differs from "
                 f"the CPU run")
    return out


def p14_soak(ctx):
    """Phase 14 (c): the small soak at t5-base through
    ``vqacl_tpu_torch.soak.run``, its launches counted → record."""
    before = launches.read()
    t0 = time.perf_counter()
    srec = soak.run(full=False, out=os.path.join(P14_DIR, "soak"),
                    device="cuda", verbose=False)
    srec["phase_s"] = time.perf_counter() - t0
    w = since(before)
    ctx.count(w)
    srec["launches"] = list(w.k)
    srec["route_launches"] = [w.routes(fn) for fn in attention()]
    n = len(srec["task_wall_s"])
    complete = p14_matrix_complete(srec["result_matrix"], n)
    log(f"p14 soak: {n} tasks, {n * (n + 1) // 2}-cell matrix complete "
        f"{complete}, Avg_acc {srec['Avg_acc']} Avg_forget "
        f"{srec['Avg_forget']}, launches {srec['launches']} (expected "
        f"{srec['expected_launches']}), {srec['phase_s']:.3f} s")
    p14_on_route("p14_soak", srec, "mma")
    if not complete or not np.isfinite([srec["Avg_acc"],
                                        srec["Avg_forget"]]).all():
        fail(f"p14 soak: the matrix or metrics are not complete and "
             f"finite: {srec['result_matrix']}")
    if srec["launches"] != srec["expected_launches"] \
            or min(srec["launches"]) <= 0:
        fail(f"p14 soak: launches {srec['launches']}, expected "
             f"{srec['expected_launches']}, each above zero")
    rec = {k: v for k, v in srec.items() if k != "result_matrix"}
    rec["matrix_complete"] = complete
    return rec


def protocol_runs(ctx):
    """The protocol scripts as a user runs them. (a) The Table-1 surrogate's
    ``P14_ROWS`` (vanilla, er, ours) at seed 0 through
    ``vqacl_tpu_torch.ablation.run_row`` with the JAX script's defaults (5
    tasks x 1000 train QA, 3 epochs, M = 100, 500 test QA, f32 at tiny
    widths), each row a process of chip_smoke.py in rank mode, the three
    side by side with (b): each row's Avg_acc, Avg_forget, diag_acc and
    wall, its K1/K1′/K2 launches equal to what its train, replay, importance
    and predict counts imply, every one on the ``scalar f32`` route (phase 2
    checks the surrogate's encoder shape, 4 heads of 8 over 10 positions, in
    f32), and the orderings ``P14_ORDERINGS`` (ours AP >= vanilla AP + 20,
    vanilla Forget >= ours Forget + 25, er AP >= vanilla AP + 10). (b) The
    "ours" row cut to ``P14_CUT_ARGV`` (two tasks x 64 train QA, one epoch)
    from one init at dropout 0, on the card and on the CPU, at the
    surrogate's lr (1e-2) and at ``P14_CUT_LR`` (1e-3): equal result
    matrices, answers and metrics at both, per-step losses within
    ``CL_LOSS_RTOL`` at 1e-3 (at 1e-2 the training amplifies f32 rounding
    past it: the losses' error is recorded). (c) The small soak at t5-base
    through ``vqacl_tpu_torch.soak.run`` (ten tasks x 1000 train QA, M =
    1000, the bf16 device cache), alone: the 55-cell matrix complete, finite
    metrics, launches equal to its counts, every one on the ``mma.sync
    bf16`` route; the card's busy share over three train steps (the soak's
    ``torch.profiler`` window).

    Counted: the cut row's and the soak's launches, and those the rows'
    processes report."""
    shutil.rmtree(P14_DIR, ignore_errors=True)
    os.makedirs(P14_DIR)
    log(f"p14 surrogate: rows {list(P14_ROWS)}, seed 0, the surrogate's "
        f"defaults{' with ' + ' '.join(P14_ARGV) if P14_ARGV else ''} "
        f"(f32, tiny widths), one process each, side by side with (b)")
    spec = {"phase": 14, "rows": list(P14_ROWS), "argv": list(P14_ARGV),
            "work": P14_DIR}
    ranks, secs, cut = run_ranks(
        P14_DIR, "p14_rows", len(P14_ROWS), spec, echo=("p14_",),
        meanwhile=lambda: p14_cut(ctx))
    rows = dict(zip(P14_ROWS, ranks))
    orderings = p14_orderings(rows)
    for text, holds in orderings:
        log(f"p14 ordering: {text} -> {'ok' if holds else 'FAILS'}")
    log(f"p14 surrogate rows in {secs:.1f} s (side by side)")
    if not all(h for _, h in orderings):
        fail("p14: the surrogate's rows do not show the Table-1 orderings")
    for r in ranks:
        ctx.reported("launches", r["launches"])
    soak = p14_soak(ctx)
    shutil.rmtree(P14_DIR, ignore_errors=True)
    k = ctx.launched().k
    log(f"phase 14 launches K1={k[0]} K1'={k[1]} K2={k[2]}")
    return {"protocol_runs": {"surrogate": {"rows": rows,
                                            "orderings": orderings,
                                            "rows_s": secs},
                              "cut": cut, "soak": soak},
            "protocol_runs_launches": list(k)}
