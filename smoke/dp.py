"""Phase 12 of ``chip_smoke.py``: data parallelism."""

import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from smoke.cl import drive_cl, record_answers, tiny_cl_config, tiny_cl_data
from smoke.harness import (CL_LOSS_RTOL, CL_TINY, CL_TINY_BATCH, Context,
                           DROPOUT, GRAD_REL_TOL, P12_TIMEOUT, TRAIN_BATCH,
                           check_adamw, fail, log, run_ranks, since,
                           train_setup)
from smoke.kernels import check_offset_attention
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.ops import fused_attention as fa, launches
from vqacl_tpu_torch.parallel.mesh import make_mesh, shard_batch
from vqacl_tpu_torch.parallel.multihost import barrier
from vqacl_tpu_torch.parallel.sharding import FsdpLayout
from vqacl_tpu_torch.train.optim import tree_leaves
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_train_step
from vqacl_tpu_torch.utils.config import Config

P12_RANKS = 2
P12_STEPS = 3
# (a)'s one-rank group; the ranks of (b)-(d) share the one card over gloo,
# since NCCL refuses two ranks on one device
P12_ONE_RANK_BACKEND = "nccl"
# (d)'s lr, items per task and global batch (phase 13's tiny runs too)
P12_TINY_LR = 1e-4
P12_TINY = CL_TINY
P12_TINY_BATCH = CL_TINY_BATCH


def timed_steps(step, state, batch, n, mesh=None, meet=None):
    """``n`` steps of ``step`` from ``state`` on ``batch`` (the rows of
    ``mesh``'s rank when given; ``meet``, a barrier, before each), each
    between synchronisations → (state, losses, ms per step)."""
    losses, times = [], []
    for _ in range(n):
        b = batch if mesh is None else shard_batch(mesh, batch)
        if meet is not None:
            meet("step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    return state, losses, times


def all_reduce_ms(mesh, n, *group):
    """Three all_reduces of one flat f32 buffer of ``n`` elements over the
    mesh's ranks (``group``: the mesh's group name), each between a
    barrier and a synchronisation → ms of each."""
    buf = torch.zeros(n, dtype=torch.float32, device=mesh.device)
    ar = []
    for _ in range(3):
        barrier("all_reduce")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce(buf, *group)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    return ar


def _tree_diff(a, b, tree_leaves):
    """‖a − b‖ over two trees of tensors, in f32."""
    return float(sum(((x.float() - y.float()) ** 2).sum()
                     for x, y in zip(tree_leaves(a), tree_leaves(b))) ** 0.5)


def _digest(tree, tree_leaves):

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def p12_rank(ctx, spec):
    """The work of one rank of (b)-(d) (``rank_main``): t5-base train
    steps at the global batch over the mesh, replicated at dropout 0 and
    0.1 and under FSDP, each from the same state; on the last rank the
    kernels at its row offset; the tiny f32 CL run with the sharded device
    cache on the card and on the CPU. → a JSON-able record."""
    dev = ctx.device
    rec = {"rank": ctx.rank, "backend": ctx.backend}
    base, params0, proto0, tx, tbatch = train_setup(dev)
    m = base.model
    nparams = sum(p.numel() for p in tree_leaves(params0))

    def steps(dropout, mesh, layout=None):
        cfg = Config()
        cfg.model.dropout_rate = dropout
        p = params0 if layout is None else layout.shard(params0)
        state = TrainState.create(p, tx, proto0, seed=0, warmup_iters=1.0,
                                  t_total=1000.0)
        step = make_train_step(cfg, dtype=torch.bfloat16, device=dev,
                               mesh_ctx=mesh, fsdp=layout)
        stats0 = dict(ctx.stats)
        before = launches.read()
        state, losses, times = timed_steps(
            step, state, tbatch, P12_STEPS, mesh,
            None if mesh is None else barrier)
        w = since(before)
        adamw_n = check_adamw(f"rank {ctx.rank}: p12 steps", w, P12_STEPS,
                              1 if layout is not None else 2)
        full = state.params if layout is None else layout.gather(state.params)
        r = {"losses": losses, "step_ms": times, "launches": w.k,
             "offset_launches": w.offsets, "adamw_launches": adamw_n,
             "all_reduce_bytes_per_step": (
                 ctx.stats["all_reduce_bytes"]
                 - stats0.get("all_reduce_bytes", 0)) / P12_STEPS,
             "all_reduce_calls_per_step": (
                 ctx.stats["all_reduce_calls"]
                 - stats0.get("all_reduce_calls", 0)) / P12_STEPS,
             "state_bytes": sum(x.numel() * x.element_size() for t in (
                 state.params, state.opt_state.mu, state.opt_state.nu)
                 for x in tree_leaves(t))}
        if not all(np.isfinite(losses)):
            fail(f"rank {ctx.rank}: a loss is not finite: {losses}")
        return full, r

    moved = lambda full: _tree_diff(full, params0, tree_leaves)  # noqa: E731
    # (b) dropout 0: equal across ranks, near the one-process run
    one, rec["one_process_d0"] = steps(0.0, None)
    full, rec["dp_d0"] = steps(0.0, ctx)
    rec["dp_d0"]["digest"] = _digest(full, tree_leaves)
    rec["dp_d0"]["rel_to_one"] = _tree_diff(full, one, tree_leaves) \
        / moved(one)
    del one, full
    # (b) dropout 0.1; its parameters are (c)'s reference
    ref, rec["dp_d01"] = steps(DROPOUT, ctx)
    rec["dp_d01"]["digest"] = _digest(ref, tree_leaves)
    # the gradient bucket's all_reduce alone (one flat f32 buffer)
    rec["all_reduce_ms"] = all_reduce_ms(ctx, nparams)
    rec["all_reduce_buffer_bytes"] = nparams * 4
    # (c) FSDP at dropout 0.1 from the same state
    layout = FsdpLayout(ctx, params0)
    full, rec["fsdp_d01"] = steps(DROPOUT, ctx, layout)
    rec["fsdp_d01"]["digest"] = _digest(full, tree_leaves)
    rec["fsdp_d01"]["rel_to_replicated"] = _tree_diff(full, ref,
                                                       tree_leaves) \
        / moved(ref)
    rec["fsdp_d01"]["sharded_leaves"] = sum(
        "dp" in s for s in tree_leaves(layout.specs))
    rec["fsdp_d01"]["leaves"] = len(tree_leaves(layout.specs))
    # the state bytes of the sharded leaves (f32 params, two moments)
    mom = 2 if base.train.adam_dtype in ("bfloat16", "bf16") else 4
    rec["fsdp_d01"]["sharded_state_bytes"] = sum(
        p.numel() * (4 + 2 * mom) for p, s in zip(
            tree_leaves(params0), tree_leaves(layout.specs)) if "dp" in s)
    del full, ref, layout
    torch.cuda.empty_cache()
    # the kernels at this rank's shapes and offset (comparison launches,
    # outside the counted runs)
    if ctx.rank == ctx.dp - 1 and ctx.rank > 0:
        B = TRAIN_BATCH // ctx.dp
        rec["offset_check"] = check_offset_attention(
            fa, B, m.encoder_len, m.encoder_len, m.num_heads, m.d_kv,
            m.max_text_length, "bfloat16", DROPOUT, m.max_text_length)
    # (d) the tiny f32 CL loop with the row-sharded device cache, on the
    # card and on the CPU (the same group: gloo takes both)
    tok = VLT5Tokenizer()
    tiny = {}
    for where, out in (("cuda", spec["tiny_out_cuda"]),
                       ("cpu", spec["tiny_out_cpu"])):
        mesh = ctx if where == "cuda" else make_mesh(device="cpu")
        tcl = tiny_cl_config(P12_TINY_LR, P12_TINY_BATCH)
        tcl.data.device_cache = tcl.data.device_cache_sharded = True
        tcl.output = out
        tcm = tcl.model
        trainer = VQACLTrainer(
            tcl, tiny_cl_data(tok, tcm, P12_TINY), tok, verbose=False,
            init_params=vlt5.init_vlt5_params(4, tcm, device="cpu"),
            dtype=torch.float32, mesh_ctx=mesh)
        answers = record_answers(trainer)
        before = launches.read()
        r = drive_cl(trainer, f"dp_tiny_f32_{where}_rank{ctx.rank}",
                     Context() if where == "cuda" else None, tcm.num_layers)
        c = trainer._cache
        tiny[where] = {
            "result_matrix": r["result_matrix"], "losses": r["losses"],
            "answers": [{str(k): v for k, v in a.items()} for a in answers],
            "launches": r["launches"], "counts": r["counts"],
            "offset_launches": since(before).offsets if where == "cuda"
            else None, "cache_rows": c.rows, "cache_n": c.n,
            "lookup_bytes": c.lookup_bytes, "lookups": c.lookups,
            "table_bytes": c.nbytes, "wall_s": r["wall_s"]}
        del trainer
    rec["tiny"] = tiny
    return rec


def data_parallel(ctx):
    """Data parallelism. (a) A one-rank NCCL mesh (``make_mesh`` over a file
    store): ``P12_STEPS`` t5-base train steps at batch 80, bf16, dropout 0.1
    through the trainer's step path (``shard_batch``,
    ``make_train_step(mesh_ctx=...)``) give the meshless step's losses and
    parameters bit for bit, 12 K1′ + 12 K2 per step. (b) ``P12_RANKS`` ranks
    on the one card over gloo (NCCL refuses two ranks on one device), each
    chip_smoke.py in rank mode (``p12_rank``): global batch 80 (40 per
    rank), bf16, ``P12_STEPS`` steps from the same state at dropout 0 (the
    ranks' parameters bit-equal, within phase 4's bound of a one-process run
    from the same state) and 0.1; 12 K1′ + 12 K2 per step per rank, the
    second rank's at its Philox row offset; the all_reduce bytes per step
    and one gradient bucket's all_reduce ms (staged through the host by
    gloo: a record, not a scaling number); on the second rank K1′ and K2 at
    its offset equal bit for bit to the same rows of one launch over the
    whole batch, the keep mask to the plain version's and to the one
    launch's rows, the outputs to the plain versions within the phase 2
    tolerance. (c) The same steps under FSDP: parameters within phase 4's
    bound of (b)'s, parameter + moment bytes per rank half of (b)'s. (d) A
    tiny f32 ``VQACLTrainer`` ER run on the two ranks with the row-sharded
    device cache, on the card and on the CPU (the same gloo group): equal
    result matrices and answers, losses within ``CL_LOSS_RTOL``, the
    lookups' all_reduce bytes. Nothing here runs on more than one card.

    Counted: the launches of (a) in this process and those the ranks report
    of (b)-(d), K1′/K2's at a row offset among them."""
    rec = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    try:
        # (a) a one-rank mesh through the trainer's step path: the same
        # loss and parameters, bit for bit, as the meshless step
        ctx1 = make_mesh(dp=1, device="cuda:0",
                         backend=P12_ONE_RANK_BACKEND,
                         init_method=f"file://{work}/one", rank=0,
                         world_size=1, timeout_s=P12_TIMEOUT)
        cfg, params0, proto0, tx, tbatch = train_setup()
        m = cfg.model

        def three(mesh):
            state = TrainState.create(params0, tx, proto0, seed=0,
                                      warmup_iters=1.0, t_total=1000.0)
            step = make_train_step(cfg, dtype=torch.bfloat16,
                                   device="cuda", mesh_ctx=mesh)
            return timed_steps(step, state, tbatch, P12_STEPS, mesh)

        (s_mesh, l_mesh, t_mesh), w = ctx.counted(lambda: three(ctx1))
        a_launches = list(w.k)
        s_one, l_one, t_one = three(None)
        same = l_mesh == l_one and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(s_mesh.params),
                                              tree_leaves(s_one.params)))
        rec["one_rank"] = {"backend": ctx1.backend, "losses": l_mesh,
                           "step_ms": t_mesh, "meshless_step_ms": t_one,
                           "bit_equal": same, "launches": a_launches,
                           "all_reduce_calls": ctx1.stats[
                               "all_reduce_calls"]}
        log(f"dp_one_rank: {ctx1.backend} mesh of 1, bs {TRAIN_BATCH} bf16 "
            f"dropout {m.dropout_rate}, {P12_STEPS} steps: losses {l_mesh}, "
            f"step ms {[round(t, 3) for t in t_mesh]} (meshless "
            f"{[round(t, 3) for t in t_one]}); loss and parameters "
            f"bit-equal to the meshless step: {same}; launches "
            f"K1/K1'/K2 {a_launches}; all_reduce calls "
            f"{ctx1.stats['all_reduce_calls']}")
        if not same:
            fail("the one-rank mesh's steps differ from the meshless steps")
        want = [0, m.num_layers * P12_STEPS, m.num_layers * P12_STEPS]
        if a_launches != want:
            fail(f"dp_one_rank: launches {a_launches}, expected {want}")
        del s_mesh, s_one, params0
        dist.destroy_process_group()
        torch.cuda.empty_cache()

        # (b)-(d): the ranks, each a process of this script on the card
        spec = {"tiny_out_cuda": os.path.join(work, "tiny_cuda"),
                "tiny_out_cpu": os.path.join(work, "tiny_cpu")}
        ranks, ranks_s = run_ranks(work, "p12", P12_RANKS, spec,
                                   ("offset_check", "dp_tiny"))
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    r0, r1 = ranks[0], ranks[-1]
    L = m.num_layers
    per_rank = [0, L * P12_STEPS, L * P12_STEPS]
    # (b)
    for key in ("dp_d0", "dp_d01", "fsdp_d01"):
        digests = {r[key]["digest"] for r in ranks}
        log(f"dp_{key}: {P12_RANKS} ranks on one card over "
            f"{r0['backend']}, global batch {TRAIN_BATCH} "
            f"({TRAIN_BATCH // P12_RANKS} per rank), bf16, {P12_STEPS} steps:"
            f" losses {r0[key]['losses']}; step ms rank 0 "
            f"{[round(t, 3) for t in r0[key]['step_ms']]}, rank 1 "
            f"{[round(t, 3) for t in r1[key]['step_ms']]}; all_reduce "
            f"{r0[key]['all_reduce_bytes_per_step']:.0f} B in "
            f"{r0[key]['all_reduce_calls_per_step']:g} calls per step; "
            f"params bit-equal across ranks: {len(digests) == 1}; launches "
            f"per rank K1/K1'/K2 {[r[key]['launches'] for r in ranks]}, "
            f"offset K1'/K2 {[r[key]['offset_launches'] for r in ranks]}")
        if len(digests) != 1:
            fail(f"dp_{key}: the ranks' parameters differ")
        for r in ranks:
            if list(r[key]["launches"]) != per_rank:
                fail(f"dp_{key}: rank {r['rank']} launches "
                     f"{r[key]['launches']}, expected {per_rank}")
            want_off = per_rank[1] if r["rank"] > 0 else 0
            if list(r[key]["offset_launches"]) != [want_off, want_off]:
                fail(f"dp_{key}: rank {r['rank']} offset launches "
                     f"{r[key]['offset_launches']}, expected {want_off}")
        if r0[key]["losses"] != r1[key]["losses"] \
                or not all(np.isfinite(r0[key]["losses"])):
            fail(f"dp_{key}: the ranks' losses differ or are not finite")
    rel = r0["dp_d0"]["rel_to_one"]
    one = r0["one_process_d0"]
    log(f"dp_d0: |p_dp - p_one| / |p_one - p_0| = {rel:.3e} (tol "
        f"{GRAD_REL_TOL['bfloat16']:g}); one-process losses "
        f"{one['losses']} vs {r0['dp_d0']['losses']}; one-process step ms "
        f"{[round(t, 3) for t in one['step_ms']]}")
    if not rel <= GRAD_REL_TOL["bfloat16"]:
        fail("dp_d0: the two-rank parameters are not within phase 4's "
             "bound of the one-process run's")
    ar = sorted(r0["all_reduce_ms"])[1]
    log(f"dp all_reduce: one flat f32 bucket of "
        f"{r0['all_reduce_buffer_bytes']} B over {r0['backend']} between "
        f"two ranks on one card: {ar:.3f} ms (all: "
        f"{[round(t, 3) for t in r0['all_reduce_ms']]}); a record of the "
        f"host-staged path, not a scaling number")
    # the kernels at rank 1's offset
    off = r1["offset_check"]
    if not all(off["same"].values()):
        fail("rank 1's kernels at its offset differ from the one launch")
    # (c)
    frel = r0["fsdp_d01"]["rel_to_replicated"]
    ratio = r0["fsdp_d01"]["state_bytes"] / r0["dp_d01"]["state_bytes"]
    halves = r0["dp_d01"]["state_bytes"] \
        - r0["fsdp_d01"]["sharded_state_bytes"] // P12_RANKS
    log(f"dp_fsdp: {r0['fsdp_d01']['sharded_leaves']} of "
        f"{r0['fsdp_d01']['leaves']} leaves sharded; |p_fsdp - p_repl| / "
        f"|p_repl - p_0| = {frel:.3e} (tol {GRAD_REL_TOL['bfloat16']:g}); "
        f"param + moment bytes per rank {r0['fsdp_d01']['state_bytes']} vs "
        f"replicated {r0['dp_d01']['state_bytes']} (ratio {ratio:.4f})")
    if not frel <= GRAD_REL_TOL["bfloat16"]:
        fail("dp_fsdp: parameters not within phase 4's bound of (b)'s")
    # each sharded leaf and its moments by half, the rest whole: half of
    # the state at t5-base, where all but ~0.1 % of it shards
    if r0["fsdp_d01"]["state_bytes"] != halves or not ratio <= 0.52:
        fail(f"dp_fsdp: per-rank state bytes {r0['fsdp_d01']['state_bytes']}"
             f" (ratio {ratio:.4f}), expected {halves}")
    # (d)
    t_card, t_cpu = r0["tiny"]["cuda"], r0["tiny"]["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(t_card["losses"],
                                                        t_cpu["losses"]))
    same_tiny = {"result_matrix": t_card["result_matrix"]
                 == t_cpu["result_matrix"],
                 "answers": t_card["answers"] == t_cpu["answers"],
                 "ranks": all(r["tiny"]["cuda"]["result_matrix"]
                              == t_card["result_matrix"] for r in ranks)}
    per_lookup = t_card["lookup_bytes"] / max(t_card["lookups"], 1)
    log(f"dp_tiny_f32: VQACLTrainer ER at dp {P12_RANKS}, sharded device "
        f"cache ({t_card['cache_rows']} of {t_card['cache_n']} rows per "
        f"rank, {t_card['table_bytes']} B), card vs CPU: "
        f"{len(t_card['losses'])} / {len(t_cpu['losses'])} steps, loss max "
        f"rel err {tiny_err:.3e} (tol {CL_LOSS_RTOL:g}); equal "
        f"{json.dumps(same_tiny)}; lookup all_reduce {per_lookup:.0f} B per "
        f"lookup ({t_card['lookups']} lookups); launches rank 0 "
        f"{t_card['launches']}, rank 1 {r1['tiny']['cuda']['launches']}")
    if len(t_card["losses"]) != len(t_cpu["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same_tiny.values()):
        fail("dp_tiny_f32: the dp run on the card differs from the CPU run")
    for r in ranks:
        for run in (r["dp_d0"], r["dp_d01"], r["fsdp_d01"],
                    r["tiny"]["cuda"]):
            ctx.reported("launches", run["launches"])
            ctx.reported("offset_launches", run["offset_launches"])
    rec.update({
        "ranks_s": ranks_s, "backend": r0["backend"],
        "one_process_step_ms": r0["one_process_d0"]["step_ms"],
        "two_rank_step_ms": {k: [r[k]["step_ms"] for r in ranks]
                             for k in ("dp_d0", "dp_d01", "fsdp_d01")},
        "losses": {k: r0[k]["losses"] for k in ("dp_d0", "dp_d01",
                                                 "fsdp_d01")},
        "rel_to_one_process": rel, "fsdp_rel_to_replicated": frel,
        "all_reduce_ms": r0["all_reduce_ms"],
        "all_reduce_buffer_bytes": r0["all_reduce_buffer_bytes"],
        "all_reduce_bytes_per_step": r0["dp_d01"][
            "all_reduce_bytes_per_step"],
        "state_bytes": {"replicated": r0["dp_d01"]["state_bytes"],
                        "fsdp": r0["fsdp_d01"]["state_bytes"]},
        "offset_check": off,
        "tiny": {"loss_rel_err": tiny_err, "equal": same_tiny,
                 "lookup_bytes_per_lookup": per_lookup,
                 "lookups": t_card["lookups"],
                 "cache_rows": t_card["cache_rows"],
                 "launches": [r["tiny"]["cuda"]["launches"]
                              for r in ranks]}})
    k = ctx.launched()
    return {"data_parallel": rec, "data_parallel_launches": list(k.k),
            "data_parallel_offset_launches": k.offsets}
