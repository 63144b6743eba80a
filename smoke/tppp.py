"""Phase 13 of ``chip_smoke.py``: tensor and pipeline parallelism."""

import collections
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from smoke.cl import drive_cl, record_answers, tiny_cl_config, tiny_cl_data
from smoke.dp import (P12_TINY, P12_TINY_BATCH, P12_TINY_LR, _digest,
                      _tree_diff, all_reduce_ms, timed_steps)
from smoke.harness import (CL_LOSS_RTOL, CL_TASKS, Context, DROPOUT,
                           GRAD_REL_TOL, TRAIN_BATCH, check_adamw, fail, log,
                           run_ranks, since, train_setup)
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.parallel.mesh import MeshContext, make_mesh
from vqacl_tpu_torch.parallel.multihost import barrier
from vqacl_tpu_torch.parallel.sharding import TpLayout
from vqacl_tpu_torch.train.optim import tree_leaves
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_train_step
from vqacl_tpu_torch.utils.config import Config

P13_TP_STEPS = 3
P13_PP_STEPS = 2
P13_PP_MICRO = 4
# the parts, each a group of ranks on the one card over gloo: name →
# mesh axes
P13_PARTS = (("tp", {"tp": 2}), ("pp", {"pp": 2}),
             ("tppp", {"tp": 2, "pp": 2}))
# a mesh step's loss vs one process's from the same state, relative: in
# bf16 the tp partial sums are rounded to bf16 before their all_reduce
# and the one process rounds the whole product once; the pipelined
# stacks add the same terms in the same order
P13_LOSS_RTOL = 1e-2
# the parameters after the steps, as |p_mesh − p_one| / |p_one − p_0|:
# phase 4's gradient bound, as phase 12 holds its ranks (Adam divides
# each gradient entry by its own scale, so an entry near zero that the
# bf16 roundings move turns into a whole update of its parameter)
P13_PARAM_RTOL = GRAD_REL_TOL["bfloat16"]
P13_TINY = P12_TINY          # (d)'s items per task


def p13_tiny_trainer(mesh, out):
    """Phase 13's tiny f32 ER trainer (phase 12's settings) on ``mesh``:
    its tp and pp, the "tp" layout at tp > 1, ``P13_PP_MICRO``
    microbatches; ``out`` its output → (trainer, the list its predicts
    append their answers to)."""
    tok = VLT5Tokenizer()
    tcl = tiny_cl_config(P12_TINY_LR, P12_TINY_BATCH)
    tcl.mesh.tp, tcl.mesh.pp = mesh.tp, mesh.pp
    tcl.mesh.pp_micro = P13_PP_MICRO
    tcl.mesh.param_layout = "tp" if mesh.tp > 1 else "replicated"
    tcl.output = out
    tcm = tcl.model
    trainer = VQACLTrainer(
        tcl, tiny_cl_data(tok, tcm, P13_TINY), tok, verbose=False,
        init_params=vlt5.init_vlt5_params(4, tcm, device="cpu"),
        dtype=torch.float32, mesh_ctx=mesh)
    answers = record_answers(trainer)
    return trainer, answers


def p13_rank(ctx, spec):
    """The work of one rank of phase 13's part ``spec["part"]``: t5-base
    train steps at the global batch over the mesh (``ctx``: tp, pp or
    both) from the same state as a one-process run (rank 0 runs that
    too); with tp the "tp" layout (each rank its Megatron slices of the
    parameters and moments), with pp ``P13_PP_MICRO`` microbatches; in
    the tp and pp parts a tiny f32 ER run on the mesh, on the card and
    on the CPU (``tensor_pipeline`` holds it to one process's). → a
    JSON-able record."""
    part, dev = spec["part"], ctx.device
    rec = {"rank": ctx.rank, "part": part, "backend": ctx.backend,
           "mesh": [ctx.dp, ctx.tp, ctx.pp],
           "index": [ctx.dp_index, ctx.tp_index, ctx.pp_stage]}
    base, params0, proto0, tx, tbatch = train_setup(dev)
    m = base.model
    mom = 2 if base.train.adam_dtype in ("bfloat16", "bf16") else 4
    one_rank = MeshContext(device=dev)       # no group: one process

    def steps(dropout, mesh, n):
        """``n`` steps → (full parameters, record)."""
        cfg = Config()
        cfg.model.dropout_rate = dropout
        if mesh.pp > 1:
            cfg.model.pp_mesh, cfg.model.pp_micro = mesh, P13_PP_MICRO
        tpl = TpLayout(mesh, params0) if mesh.tp > 1 else None
        p = params0 if tpl is None else tpl.shard(params0)
        state = TrainState.create(p, tx, proto0, seed=0, warmup_iters=1.0,
                                  t_total=1000.0)
        step = make_train_step(cfg, dtype=torch.bfloat16, device=dev,
                               mesh_ctx=mesh if mesh.distributed else None,
                               tp=tpl)
        stats0 = collections.Counter(ctx.stats)
        before = launches.read()
        state, losses, times = timed_steps(
            step, state, tbatch, n, *((mesh, barrier) if mesh.distributed
                                      else ()))
        delta = {k: (ctx.stats[k] - stats0.get(k, 0)) / n
                 for k in ctx.stats if k.startswith("all_reduce_")}
        full = state.params if tpl is None else tpl.gather(state.params)
        w = since(before)
        r = {"losses": losses, "step_ms": times, "launches": w.k,
             "adamw_launches": check_adamw(
                 f"{part} rank {ctx.rank}: steps", w, n,
                 1 if tpl is not None else 2),
             "offset_launches": w.offsets, "head_offset_launches": w.heads,
             "all_reduce_per_step": delta,
             "state_bytes": sum(x.numel() * x.element_size() for t in (
                 state.params, state.opt_state.mu, state.opt_state.nu)
                 for x in tree_leaves(t))}
        if tpl is not None:     # the tp-sliced leaves' params and moments
            r["sharded_state_bytes"] = sum(
                x.numel() * (4 + 2 * mom) for x, d in zip(
                    tree_leaves(params0), tpl.dims) if d is not None)
        if not all(np.isfinite(losses)):
            fail(f"{part} rank {ctx.rank}: a loss is not finite: {losses}")
        return full, r

    n = P13_TP_STEPS if part == "tp" else P13_PP_STEPS
    rates = (0.0, DROPOUT) if part == "tp" else (0.0,)
    moved = lambda full: _tree_diff(full, params0, tree_leaves)  # noqa: E731
    for rate in rates:
        key = f"d{rate:g}"
        one = None
        if ctx.rank == 0:
            one, rec[f"one_{key}"] = steps(rate, one_rank, n)
        full, rec[key] = steps(rate, ctx, n)
        rec[key]["digest"] = _digest(full, tree_leaves)
        if one is not None:
            rec[key]["rel_to_one"] = _tree_diff(full, one, tree_leaves) \
                / moved(one)
        del one, full
        torch.cuda.empty_cache()
    if part == "pp":
        # the gradient bucket's all_reduce alone over dp × pp (one flat f32
        # buffer of every parameter)
        nparams = sum(p.numel() for p in tree_leaves(params0))
        rec["bucket_ms"] = all_reduce_ms(ctx, nparams, "dpp")
        rec["bucket_bytes"] = nparams * 4
        mb = TRAIN_BATCH // P13_PP_MICRO
        rec["handoff_bytes"] = {
            "encoder": ctx.pp * mb * m.encoder_len * m.d_model * 2,
            "decoder": ctx.pp * mb * m.target_max_length * m.d_model * 2}
        rec["ticks"] = P13_PP_MICRO + ctx.pp - 1
    del params0
    torch.cuda.empty_cache()
    if part == "tppp":
        return rec
    # (d) the tiny f32 ER run on the mesh, on the card and on the CPU (the
    # one-process run it is held to runs in the script's own process: a
    # trainer here would take part in the group's collectives)
    tiny = {}
    for where in ("cuda", "cpu"):
        mesh = ctx if where == "cuda" else make_mesh(tp=ctx.tp, pp=ctx.pp,
                                                     device="cpu")
        trainer, answers = p13_tiny_trainer(
            mesh, os.path.join(spec["work"], f"{part}_tiny_{where}"))
        # K1′/K2 per step (and K1 per predict batch) on a rank: its
        # stage's layers once per microbatch
        per = trainer.cfg.model.num_layers // mesh.pp \
            * (P13_PP_MICRO if mesh.pp > 1 else 1)
        before = launches.read()
        r = drive_cl(trainer, f"p13_tiny_{part}_{where}_rank{ctx.rank}",
                     Context() if where == "cuda" else None, per)
        w = since(before)
        tiny[where] = {
            "result_matrix": r["result_matrix"], "losses": r["losses"],
            "answers": [{str(k): v for k, v in a.items()} for a in answers],
            "launches": r["launches"], "counts": r["counts"],
            "head_offset_launches": w.heads if where == "cuda" else None,
            "offset_launches": w.offsets if where == "cuda" else None,
            "digest": _digest(trainer._full_params(), tree_leaves),
            "wall_s": r["wall_s"]}
        del trainer
    rec["tiny"] = tiny
    return rec


def tensor_pipeline(ctx):
    """Tensor and pipeline parallelism, each part a group of ranks of
    chip_smoke.py on the one card over gloo, against the same steps run in
    one process from the same init and batch (global batch 80, bf16, f32
    master weights): (a) tp = 2 with the "tp" layout (6 heads and d_ff 1536
    per rank), ``P13_TP_STEPS`` steps at dropout 0 and 0.1; (b) pp = 2 over
    ``P13_PP_MICRO`` microbatches of 20, replicated, ``P13_PP_STEPS`` steps
    at dropout 0; (c) tp = 2 x pp = 2 on four ranks, "tp" layout, dropout 0.
    Each: losses within ``P13_LOSS_RTOL`` and parameters within phase 4's
    bound of one process's, bit-equal across the ranks; K1′ and K2 per step
    per rank (a stage's layers once per microbatch), the second tp rank's
    over its heads (``head_offset_launches``); the all_reduce bytes per step
    per group, step ms beside one process's; (a) parameter + moment bytes
    per rank against one process's (the tp-sliced leaves by half); (b) ticks
    per stack, hand-off bytes per tick and the dp x pp gradient bucket's
    bytes and ms. (d) A tiny f32 ER run of two tasks at tp = 2 and at pp =
    2, on the card and on the CPU, with the one-process run's result matrix
    and answers, and rank 0's checkpoint loaded by the one-process trainer
    with the mesh run's parameters. (e) In phase 2: K1′ and K2 over heads
    6-11 with ``(Hc = 12, h0 = 6)`` at the train shape equal bit for bit to
    those heads of one launch over all 12 (o, p, dq, dk, dv, the dbias
    panel, the keep mask) and within the phase 2 tolerance of the plain
    versions.

    Counted: the launches the ranks report of their mesh steps and tiny mesh
    runs on the card, K1′/K2's at a row offset and over a rank's heads among
    them. Phase 2's head-offset check (e) goes into the record."""
    m = Config().model
    L = m.num_layers
    work = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    parts = {}
    try:
        for part, mesh in P13_PARTS:
            n = 1
            for v in mesh.values():
                n *= v
            ranks, secs = run_ranks(
                work, f"p13_{part}", n,
                {"phase": 13, "part": part, "mesh": mesh, "work": work},
                ("p13_tiny",))
            parts[part] = {"ranks": ranks, "s": secs}
        # (d)'s one-process run on the card, and each mesh run's last
        # checkpoint (rank 0's) loaded by that trainer
        trainer, answers = p13_tiny_trainer(
            MeshContext(device=torch.device("cuda")),
            os.path.join(work, "tiny_one"))
        r = drive_cl(trainer, "p13_tiny_one")
        one_tiny = {"result_matrix": r["result_matrix"],
                    "losses": r["losses"],
                    "answers": [{str(k): v for k, v in a.items()}
                                for a in answers], "ckpt": {}}
        for part in ("tp", "pp"):
            trainer.cfg.output = os.path.join(work, f"{part}_tiny_cuda")
            loaded, _ = trainer._load(CL_TASKS[-1])
            one_tiny["ckpt"][part] = (_digest(loaded, tree_leaves),
                                      sorted(os.listdir(trainer.cfg.output)))
        del trainer
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rec = {}
    for part, mesh in P13_PARTS:
        ranks = parts[part]["ranks"]
        tp, pp = mesh.get("tp", 1), mesh.get("pp", 1)
        n = P13_TP_STEPS if part == "tp" else P13_PP_STEPS
        r0 = ranks[0]
        out = {"ranks_s": parts[part]["s"]}
        for key in [k for k in ("d0", f"d{DROPOUT:g}") if k in r0]:
            one = r0[f"one_{key}"]
            digests = {r[key]["digest"] for r in ranks}
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                r0[key]["losses"], one["losses"]))
            rel = r0[key]["rel_to_one"]
            # K1′ and K2 per step on a rank: its stage's layers once per
            # microbatch (K1 only in eval)
            k = L // pp * (P13_PP_MICRO if pp > 1 else 1)
            per_step = [0, k, k]
            ar = r0[key]["all_reduce_per_step"]
            log(f"p13_{part}_{key}: {len(ranks)} ranks (tp {tp}, pp {pp}) "
                f"on one card over {r0['backend']}, global batch "
                f"{TRAIN_BATCH}, bf16, {n} steps"
                + (f", pp_micro {P13_PP_MICRO}" if pp > 1 else "")
                + f": losses {r0[key]['losses']} (one process "
                f"{one['losses']}, max rel err {loss_err:.3e}, tol "
                f"{P13_LOSS_RTOL:g}); |p_mesh - p_one| / |p_one - p_0| = "
                f"{rel:.3e} (tol {P13_PARAM_RTOL:g}); params "
                f"bit-equal across ranks: {len(digests) == 1}; step ms rank 0 "
                f"{[round(t, 3) for t in r0[key]['step_ms']]} (one process "
                f"{[round(t, 3) for t in one['step_ms']]}); all_reduce per "
                f"step rank 0: "
                + ", ".join(f"{g} {ar.get(f'all_reduce_{g}_bytes', 0):.0f} B "
                            f"in {ar.get(f'all_reduce_{g}_calls', 0):g}"
                            for g in ("tp", "pp", "dpp", "dp"))
                + f"; launches per rank K1/K1'/K2 "
                f"{[r[key]['launches'] for r in ranks]}, head offset "
                f"K1'/K2 {[r[key]['head_offset_launches'] for r in ranks]}, "
                f"row offset {[r[key]['offset_launches'] for r in ranks]}")
            if len(digests) != 1:
                fail(f"p13_{part}_{key}: the ranks' parameters differ")
            if not loss_err <= P13_LOSS_RTOL or not rel <= P13_PARAM_RTOL:
                fail(f"p13_{part}_{key}: not within the bounds of the "
                     f"one-process run")
            for r in ranks:
                t_idx = r["index"][1]
                want = [x * n for x in per_step]
                want_head = [per_step[1] * n] * 2 if t_idx > 0 else [0, 0]
                # under pp every microbatch past the first starts at a
                # Philox row offset
                off = per_step[1] * n * (P13_PP_MICRO - 1) // P13_PP_MICRO \
                    if pp > 1 else 0
                if list(r[key]["launches"]) != want \
                        or list(r[key]["head_offset_launches"]) != want_head \
                        or list(r[key]["offset_launches"]) != [off, off]:
                    fail(f"p13_{part}_{key}: rank {r['rank']} launches "
                         f"{r[key]['launches']}, head offsets "
                         f"{r[key]['head_offset_launches']}, offsets "
                         f"{r[key]['offset_launches']}; expected {want}, "
                         f"{want_head}, {[off, off]}")
                for attr in ("launches", "offset_launches",
                             "head_offset_launches"):
                    ctx.reported(attr, r[key][attr])
            out[key] = {"losses": r0[key]["losses"],
                        "one_losses": one["losses"], "loss_rel_err": loss_err,
                        "rel_to_one": rel,
                        "step_ms": [r[key]["step_ms"] for r in ranks],
                        "one_step_ms": one["step_ms"],
                        "all_reduce_per_step": ar,
                        "state_bytes": r0[key]["state_bytes"],
                        "one_state_bytes": one["state_bytes"]}
            if tp > 1:
                want_bytes = one["state_bytes"] \
                    - r0[key]["sharded_state_bytes"] // tp
                ratio = r0[key]["state_bytes"] / one["state_bytes"]
                log(f"p13_{part}_{key}: param + moment bytes per rank "
                    f"{r0[key]['state_bytes']} vs one process "
                    f"{one['state_bytes']} (ratio {ratio:.4f})")
                if r0[key]["state_bytes"] != want_bytes:
                    fail(f"p13_{part}_{key}: per-rank state bytes "
                         f"{r0[key]['state_bytes']}, expected {want_bytes}")
                out[key]["state_ratio"] = ratio
        if pp > 1 and "bucket_ms" in r0:
            bms = sorted(r0["bucket_ms"])[1]
            log(f"p13_{part}: {r0['ticks']} ticks per stack, hand-off bytes "
                f"per tick {json.dumps(r0['handoff_bytes'])}; the dp x pp "
                f"gradient bucket {r0['bucket_bytes']} B over "
                f"{r0['backend']}: {bms:.3f} ms (all "
                f"{[round(t, 3) for t in r0['bucket_ms']]}); a record of "
                f"the host-staged path, not a scaling number")
            out.update(ticks=r0["ticks"], handoff_bytes=r0["handoff_bytes"],
                       bucket_ms=r0["bucket_ms"],
                       bucket_bytes=r0["bucket_bytes"])
        if "tiny" in r0:
            t_card, t_cpu = r0["tiny"]["cuda"], r0["tiny"]["cpu"]
            t_one = one_tiny
            ckpt_digest, ckpt_files = one_tiny["ckpt"][part]
            same = {"card_cpu": t_card["result_matrix"]
                    == t_cpu["result_matrix"]
                    and t_card["answers"] == t_cpu["answers"],
                    "card_one": t_card["result_matrix"]
                    == t_one["result_matrix"]
                    and t_card["answers"] == t_one["answers"],
                    "ranks": all(r["tiny"]["cuda"]["result_matrix"]
                                 == t_card["result_matrix"] for r in ranks),
                    "checkpoint": ckpt_digest == t_card["digest"]}
            err = max(abs(a - b) / abs(b) for a, b in zip(t_card["losses"],
                                                          t_one["losses"]))
            log(f"p13_tiny_{part}: VQACLTrainer ER at tp {tp}, pp {pp} (f32, "
                f"{len(t_card['losses'])} steps) vs the CPU run and one "
                f"process on the card: loss max rel err {err:.3e} (tol "
                f"{CL_LOSS_RTOL:g}); equal {json.dumps(same)}; rank 0's "
                f"checkpoint files {ckpt_files}; "
                f"launches per rank "
                f"{[r['tiny']['cuda']['launches'] for r in ranks]}, head "
                f"offset {[r['tiny']['cuda']['head_offset_launches'] for r in ranks]}")
            if not all(same.values()) or not err <= CL_LOSS_RTOL:
                fail(f"p13_tiny_{part}: the mesh run differs from the CPU "
                     f"or the one-process run")
            for r in ranks:
                for attr in ("launches", "offset_launches",
                             "head_offset_launches"):
                    ctx.reported(attr, r["tiny"]["cuda"][attr])
            out["tiny"] = {"equal": same, "loss_rel_err": err,
                           "launches": [r["tiny"]["cuda"]["launches"]
                                        for r in ranks]}
        rec[part] = out
    rec["head_offset_check"] = ctx.head_off
    k = ctx.launched()
    return {"tensor_pipeline": rec, "tensor_pipeline_launches": list(k.k),
            "tensor_pipeline_offset_launches": k.offsets,
            "tensor_pipeline_head_offset_launches": k.heads}
