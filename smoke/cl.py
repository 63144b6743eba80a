"""Phase 7 of ``chip_smoke.py``, the continual-learning loop, and
``drive_cl``, which phases 8, 10, 12, 13 and 14 also drive their CL runs
through."""

import json
import os
import tempfile
import time

import numpy as np
import torch

from smoke.harness import (CL_IMAGES, CL_ITEMS, CL_LOSS_RTOL, CL_M_SIZE,
                           CL_TASKS, CL_TINY, CL_TINY_BATCH, EVAL_BATCH,
                           Launches, P7_CKPT, P7_DIR, TRAIN_BATCH, check_adamw,
                           fail, log, since)
from vqacl_tpu_torch.cl.comp_trainer import CompVQACLTrainer
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.utils.config import Config, tiny_model_config

# the EWC and DER++ runs train on CL_REG_TRAIN items per task; EWC's
# importance batches per task
CL_REG_TRAIN = 160
CL_FISHER_BATCHES = 2


def drive_cl(trainer, label, ctx=None, layers=None, train=None):
    """Run ``trainer.train()`` (or ``train()``, a caller that runs it,
    such as a CLI's ``run``) as a user calls it, then read the
    trainer's own records: ``wall_s`` and ``task_wall_s`` (host clock),
    ``times_ms`` (each step and batch between CUDA events recorded around
    it without a sync; each save's host copy) and ``step_losses``. With
    a ``ctx`` the kernel launches of the run are counted into it and
    checked against its steps and batches: K1′ and K2 once per encoder
    layer (``layers``: the model's by default) in every train, replay and
    importance step, K1 once per layer in every predict and DER capture
    batch, each above zero; with ``merged_qkv`` (the trainer resolves
    "auto" to it) every one of them on strided q/k/v; the fused
    optimizer's pair in every train and replay step (``check_adamw``).
    Checks finite losses and a finite result matrix → record."""
    num_layers = layers or trainer.cfg.model.num_layers
    before = launches.read()
    t0 = time.perf_counter()
    metrics = (train or trainer.train)()
    wall = time.perf_counter() - t0
    lw = since(before) if ctx else Launches()
    k1, k1p, k2 = lw.k
    strided = list(lw.strided)
    merged = trainer.cfg.model.merged_qkv is True
    c, times = trainer.counts, trainer.times_ms
    losses = trainer.step_losses["train"] + trainer.step_losses["replay"]
    steps = c["train_steps"] + c["replay_steps"]
    want_k1p = num_layers * (steps + c["importance_batches"])
    want_k1 = num_layers * (c["predict_batches"] + c["capture_batches"])
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
    ms = lambda x: "-" if x is None else f"{x:.3f}"
    train_ms = times["train_steps"] + times["replay_steps"]
    clock = "between CUDA events, no sync per call" \
        if trainer.device.type == "cuda" else "on the host clock"
    w = trainer.wall_s
    matrix = trainer.result_matrix.matrix().tolist()
    rec = {"wall_s": wall, "task_wall_s": dict(trainer.task_wall_s),
           "counts": dict(c), "launches": [k1, k1p, k2],
           "strided_launches": strided, "merged_qkv": merged,
           "expected_launches": [want_k1, want_k1p, want_k1p],
           "train_step_ms_median": med(train_ms),
           "replay_step_ms_median": med(times["replay_steps"]),
           "predict_batch_ms_median": med(times["predict_batches"]),
           "steps_per_s": steps / max(w["train"], 1e-9),
           "wall_share": {k: w[k] / wall for k in
                          ("train", "predict", "loader", "checkpoint")},
           "checkpoint_s": w["checkpoint"],
           "checkpoint_save_ms": times["saves"],
           "importance_batch_ms": times["importance_batches"],
           "capture_batch_ms": times["capture_batches"],
           "checkpoint_write_s": trainer._ckpt_writer.write_s,
           "losses": losses, "result_matrix": matrix,
           "Avg_acc": metrics.get("Avg_acc",
                                  metrics.get("standard", {}).get("Avg_acc")),
           "metrics": metrics}
    log(f"{label}: wall {wall:.3f} s, per task "
        + ", ".join(f"{t} {s:.3f} s" for t, s in trainer.task_wall_s.items())
        + f"; {steps} train+replay steps ({c['train_steps']} + "
        f"{c['replay_steps']}), median {ms(rec['train_step_ms_median'])} ms "
        f"(replay steps alone {ms(rec['replay_step_ms_median'])} ms), "
        f"{rec['steps_per_s']:.3f} steps/s of train time; "
        f"{c['predict_batches']} predict batches, median "
        f"{ms(rec['predict_batch_ms_median'])} ms (steps and batches "
        f"{clock}); importance batches "
        f"{c['importance_batches']} ("
        f"{', '.join(f'{t:.3f}' for t in times['importance_batches']) or '-'}"
        f" ms), DER capture batches {c['capture_batches']} ("
        f"{', '.join(f'{t:.3f}' for t in times['capture_batches']) or '-'}"
        f" ms)")
    log(f"{label}: wall shares " + json.dumps(rec["wall_share"])
        + f"; checkpoint {w['checkpoint']:.3f} s (saves, each the host copy: "
        f"{', '.join(f'{t:.3f}' for t in times['saves'])} ms; the rest the "
        f"final drain), background writes {rec['checkpoint_write_s']:.3f} s; "
        f"launches K1={k1} "
        f"K1'={k1p} K2={k2} (expected {want_k1}/{want_k1p}/{want_k1p}), "
        f"merged_qkv={merged}: strided {strided[0]}/{strided[1]}/"
        f"{strided[2]}")
    log(f"{label}: result matrix {matrix} Avg_acc {rec['Avg_acc']}")
    if ctx and ((k1, k1p, k2) != (want_k1, want_k1p, want_k1p)
                or min(k1, k1p, k2) <= 0):
        fail(f"{label}: launches K1/K1'/K2 {k1}/{k1p}/{k2}, expected "
             f"{want_k1}/{want_k1p}/{want_k1p}, each above zero")
    if ctx and merged and strided != [k1, k1p, k2]:
        fail(f"{label}: merged_qkv, but strided launches {strided} of "
             f"{[k1, k1p, k2]}")
    if ctx:    # the norm pass runs unless the layout gives ‖g‖
        ctx.count(lw)
        rec["adamw_launches"] = check_adamw(
            label, lw, steps, 1 if trainer._layout is not None else 2, ctx)
    if not losses or not all(np.isfinite(losses)):
        fail(f"{label}: a loss is not finite: {losses}")
    if not np.isfinite(np.asarray(matrix)).all() \
            or not np.isfinite(rec["Avg_acc"]):
        fail(f"{label}: the result matrix is not finite: {matrix}")
    return rec


def tiny_cl_config(lr, batch):
    """The tiny f32 CL runs' config: tiny widths at dropout 0, ``lr``,
    train and eval ``batch``, one epoch, replay memory of 16."""
    cfg = Config()
    cfg.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0)
    cfg.train.lr = lr
    cfg.train.batch_size = cfg.train.valid_batch_size = batch
    cfg.train.epochs = 1
    cfg.train.m_size = 16
    return cfg


def tiny_cl_data(tok, m, items):
    """``CL_TASKS`` of synthetic data at the model config ``m``'s
    features, ``items`` (train, val, test) per task, four answers."""
    return SyntheticDataModule(
        tok, tasks=CL_TASKS, n_train_per_task=items[0],
        n_val_per_task=items[1], n_test_per_task=items[2],
        feat_dim=m.feat_dim, n_boxes=m.n_boxes, answer_vocab=4, seed=0)


def record_answers(trainer) -> list:
    """The answers of every ``trainer.predict`` from now on, as a list."""
    answers, predict = [], trainer.predict

    def recording(loader):
        answers.append(predict(loader))
        return answers[-1]

    trainer.predict = recording
    return answers


def cl_loop(ctx):
    """The continual-learning loop: ``VQACLTrainer`` on the random-init
    t5-base of phase 3 (bf16 compute, f32 master weights, dropout 0.1,
    train batch 80, eval batch 100) over two tasks of
    ``SyntheticDataModule`` data (feat_dim 2048, 36 boxes, a pool of 256
    images; 400 train, 100 val and 100 test items per task), one epoch,
    replay memory of 200; then the same with ``cl_reg`` "ewc" (two
    importance batches per task) and "derpp" at 160 train items per task.
    Each run is the loop as a user calls it and prints, from the
    trainer's own records, its wall time per task, the median train step
    and predict batch (CUDA events recorded around each call, no sync per
    call), the checkpoint save time, the host-time shares and K1/K1′/K2
    launches, which must equal what its steps and batches imply (K1 also
    at the DER capture's train batch, checked in phase 2); then a tiny f32
    ``CompVQACLTrainer`` run (comp_cate G5) on the card against the same
    run on the CPU: equal result matrices and answers, per-step losses
    within ``CL_LOSS_RTOL``.

    The runs' launches are counted; the ER run's last checkpoint is kept
    for phase 9 (``P7_CKPT``)."""
    cl = {}
    n_tr, n_va, n_te = CL_ITEMS
    tok = ctx.tok
    for name, reg in (("er", "none"), ("ewc", "ewc"), ("derpp", "derpp")):
        ccfg = Config()
        ccfg.train.batch_size = TRAIN_BATCH
        ccfg.train.valid_batch_size = EVAL_BATCH
        ccfg.train.epochs = 1
        ccfg.train.memory = True
        ccfg.train.m_size = CL_M_SIZE
        ccfg.train.cl_reg = reg
        ccfg.train.fisher_batches = CL_FISHER_BATCHES
        cm = ccfg.model
        t0 = time.time()
        cdata = SyntheticDataModule(
            tok, tasks=CL_TASKS,
            n_train_per_task=n_tr if reg == "none" else CL_REG_TRAIN,
            n_val_per_task=n_va, n_test_per_task=n_te, feat_dim=cm.feat_dim,
            n_boxes=cm.n_boxes, n_images=CL_IMAGES, seed=0)
        with tempfile.TemporaryDirectory() as out:
            ccfg.output = out
            trainer = VQACLTrainer(ccfg, cdata, tok, verbose=False,
                                   device="cuda", init_params=ctx.params,
                                   dtype=torch.bfloat16)
            log(f"cl_{name}: t5-base bf16 compute, f32 master weights, "
                f"dropout {cm.dropout_rate}, batch {TRAIN_BATCH}, eval batch "
                f"{EVAL_BATCH}, tasks {list(CL_TASKS)}, "
                f"{len(cdata.train_items(CL_TASKS[0]))} "
                f"train items per task, m_size {CL_M_SIZE}, cl_reg {reg}, "
                f"merged_qkv {cm.merged_qkv} (the trainer's resolve of "
                f"'auto'); set-up {time.time() - t0:.1f} s")
            cl[name] = drive_cl(trainer, f"cl_{name}", ctx, cm.num_layers)
            if name == "er":   # phase 9 exports its last checkpoint
                os.makedirs(P7_DIR, exist_ok=True)
                os.replace(os.path.join(out, f"{CL_TASKS[-1]}_LAST.npz"),
                           P7_CKPT)
        del trainer
        torch.cuda.empty_cache()

    # a tiny f32 run on the card == the same run on the CPU
    tcl = tiny_cl_config(1e-3, CL_TINY_BATCH)
    tcl.train.comp_cate = "G5"
    tcm = tcl.model
    tinit = vlt5.init_vlt5_params(4, tcm, device="cpu")
    tiny_runs = {}
    for dev in ("cuda", "cpu"):
        tdata = tiny_cl_data(tok, tcm, CL_TINY)
        with tempfile.TemporaryDirectory() as out:
            tcl.output = out
            trainer = CompVQACLTrainer(tcl, tdata, tok, verbose=False,
                                       device=dev, init_params=tinit,
                                       dtype=torch.float32)
            answers = record_answers(trainer)
            rec = drive_cl(trainer, f"cl_tiny_f32_{dev}",
                           ctx if dev == "cuda" else None, tcm.num_layers)
            rec["answers"] = answers
            rec["comp"] = trainer.result_matrix_comp.to_dict()
            rec["noncomp"] = trainer.result_matrix_noncomp.to_dict()
            tiny_runs[dev] = rec
    card_run, cpu_run = tiny_runs["cuda"], tiny_runs["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                        cpu_run["losses"]))
    same = {k: card_run[k] == cpu_run[k] for k in ("result_matrix", "comp",
                                                   "noncomp", "answers")}
    log(f"cl tiny f32 CompVQACLTrainer (comp_cate G5), card vs CPU: "
        f"{len(card_run['losses'])} / {len(cpu_run['losses'])} steps, loss "
        f"max rel err {tiny_err:.3e} (tol {CL_LOSS_RTOL:g}); equal: "
        f"{json.dumps(same)}; Avg_acc {card_run['Avg_acc']}")
    if len(card_run["losses"]) != len(cpu_run["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same.values()):
        fail("the tiny f32 CL run on the card differs from the CPU run")
    return {"cl": {k: {key: v for key, v in r.items() if key != "metrics"}
                   for k, r in cl.items()},
            "cl_tiny": {"loss_rel_err": tiny_err, "equal": same,
                        "launches": card_run["launches"]}}
