"""Phases 3, 4 and 5 of ``chip_smoke.py``: the eval and training slices
and serving at t5-base."""

import json
import threading
import time

import numpy as np
import torch

from smoke.harness import (EVAL_BATCH, GRAD_REL_TOL, SMALL_PARAM_TOL,
                           TRAIN_BATCH, _grads, check_adamw, fail, log, since,
                           train_setup)
from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.data.features import MemoryFeatureStore
from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.convert import to_device
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import fused_attention as fa, launches
from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves, tree_map
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import (make_eval_step, make_loss_eval_step,
                                        make_train_step)
from vqacl_tpu_torch.utils.config import Config, tiny_model_config

EVAL_STEPS = 3
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
# the loss-eval step through the fused decoder vs the unfused decoder,
# relative: bf16 rounds p before p·v in the kernel and after the f32
# softmax in the plain path; f32 differs only in summation order
LOSS_EVAL_RTOL = {"bfloat16": 5e-3, "float32": 1e-5}
# remat replays the block's own arithmetic on the same inputs, so the
# gradients agree to the last bit; the bound leaves room for nothing else
REMAT_GRAD_RTOL = 1e-6


def init_slice(ctx):
    """The random-init t5-base (seeded) and prototype banks every later
    phase starts from, and the tokenizer, into ``ctx.params``,
    ``ctx.proto`` and ``ctx.tok``."""
    m = Config().model
    params = vlt5.init_vlt5_params(0, m, device="cuda")
    # without this a random decoder keeps predicting its start token (pad)
    params["shared"][m.pad_token_id] = 0.0
    g = torch.Generator(device="cuda").manual_seed(1)
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cuda")
    ctx.params, ctx.tok = params, VLT5Tokenizer()
    ctx.proto = proto._replace(
        q_proto=torch.randn(m.n_ques_types, m.d_model, generator=g,
                            device="cuda"),
        v_proto=torch.randn(m.n_categories, m.d_model, generator=g,
                            device="cuda"))


def tiny_eval_inputs():
    """The small f32 reference's makings on the CPU: (tiny config, its
    seeded parameters, prototype banks, one collated eval batch of 8)."""
    tiny = Config()
    tiny.model = tm = tiny_model_config(vocab_size=32200)
    tp = vlt5.init_vlt5_params(3, tm, device="cpu")
    tp["shared"][tm.pad_token_id] = 0.0
    return tiny, tp, ProtoState.create(
        tm.n_ques_types, tm.n_categories, tm.d_model, device="cpu"), collate(
        SyntheticVQA(8, seed=2, feat_dim=tm.feat_dim, n_boxes=tm.n_boxes,
                     text_len=tm.max_text_length).examples,
        max_text_length=tm.max_text_length, n_boxes=tm.n_boxes,
        feat_dim=tm.feat_dim, with_targets=False)["tensors"]


def tiny_train_inputs(small):
    """Three f32 train steps' makings on the CPU for the tiny config
    ``small``: (its seeded parameters, prototype banks, three batches of
    8, its optimizer transform)."""
    sm = small.model
    return (vlt5.init_vlt5_params(5, sm, device="cpu"),
            ProtoState.create(sm.n_ques_types, sm.n_categories, sm.d_model,
                              device="cpu"),
            [b["tensors"] for b in SyntheticVQA(
                24, seed=6, feat_dim=sm.feat_dim, n_boxes=sm.n_boxes,
                text_len=sm.max_text_length, vocab_size=sm.vocab_size,
                answer_vocab=8).batches(8, seed=1)],
            make_transform(small.train))


def eval_slice(ctx):
    """The eval slice: random-init t5-base (seeded), cast for inference,
    bf16, ``make_eval_step`` at batch 100 on a synthetic batch; the
    launch counts over the timed steps; the encoder through the kernel
    against the unfused encoder; f32 tokens on the card against the CPU
    plain path on a tiny config.

    The timed steps' launches are counted."""
    cfg = Config()
    m = cfg.model
    t0 = time.time()
    init_slice(ctx)
    proto = ctx.proto
    cast = vlt5.cast_params_for_inference(ctx.params, torch.bfloat16)
    pool = SyntheticVQA(EVAL_BATCH, seed=0)
    batch = collate(pool.examples, with_targets=False)["tensors"]
    log(f"slice: t5-base random init + cast in {time.time() - t0:.1f} s")

    ev = make_eval_step(cfg, dtype=torch.bfloat16, device="cuda")
    tokens = ev(cast, proto, batch)             # warm-up
    torch.cuda.synchronize()
    before = launches.read()
    times = []
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        tokens = ev(cast, proto, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    w = since(before)
    ctx.count(w)
    eval_launches, eval_k1p, eval_k2 = w.k
    per_step = eval_launches / EVAL_STEPS
    ctx.eval_step_ms = eval_step_ms = sorted(times)[len(times) // 2]
    log(f"eval_step: bs {EVAL_BATCH} bf16 eval_step_ms={eval_step_ms:.3f} "
        f"(all: {', '.join(f'{t:.3f}' for t in times)}) "
        f"fused_attention launches={eval_launches} ({per_step:g}/step)")
    if eval_launches != m.num_layers * EVAL_STEPS:
        fail(f"expected {m.num_layers} kernel launches per eval step, got "
             f"{per_step:g}")
    if eval_k1p or eval_k2:
        fail(f"the eval step launched K1' {eval_k1p} and K2 {eval_k2} times")

    tok = tokens.cpu().numpy()
    T = m.gen_max_length - 1
    if tok.shape != (EVAL_BATCH, T) or tok.dtype != np.int32 \
            or tok.min() < 0 or tok.max() >= m.vocab_size:
        fail(f"eval tokens {tok.dtype} {tok.shape} "
             f"range [{tok.min()}, {tok.max()}]")
    for row in tok:
        hit = np.flatnonzero(row == m.eos_token_id)
        if hit.size and (row[hit[0] + 1:] != m.pad_token_id).any():
            fail(f"tokens after EOS are not pad: {row}")
    log(f"eval tokens: {len(np.unique(tok))} distinct ids, rows with EOS "
        f"{int((tok == m.eos_token_id).any(axis=1).sum())}/{EVAL_BATCH}, "
        f"first rows {tok[:2, :6].tolist()}")

    # encoder through the kernel vs the unfused plain-attention encoder
    dev_batch = {k: torch.from_numpy(batch[k]).cuda()
                 for k in ("input_ids", "vis_feats", "boxes")}
    with torch.inference_mode():
        h_k, _ = vlt5.encode(cast, m, **dev_batch, dtype=torch.bfloat16)
        m_plain = Config().model
        m_plain.fused_attention = False
        h_p, _ = vlt5.encode(cast, m_plain, **dev_batch,
                             dtype=torch.bfloat16)
    enc_err = float((h_k.float() - h_p.float()).abs().max())
    enc_scale = float(h_p.float().abs().max())
    enc_rel = enc_err / enc_scale
    cfg_plain = Config()
    cfg_plain.model = m_plain
    tok_plain = make_eval_step(cfg_plain, dtype=torch.bfloat16,
                               device="cuda")(cast, proto, batch)
    rows_equal = float((tok_plain.cpu().numpy() == tok).all(axis=1).mean())
    log(f"encoder: kernel vs plain attention max_abs_err={enc_err:.4e} "
        f"max|plain|={enc_scale:.4e} rel={enc_rel:.3e} (tol 3e-2); "
        f"decoded rows equal {rows_equal:.3f} (tol >= 0.9)")
    if not enc_rel <= 3e-2:
        fail("encoder output through the kernel disagrees with plain")
    if rows_equal < 0.9:
        fail("decoded tokens through the kernel disagree with plain")

    # small-input reference: f32 tokens on the card == CPU plain path
    tiny, tp_cpu, tproto, tb = tiny_eval_inputs()
    tok_cpu = make_eval_step(tiny, dtype=torch.float32, device="cpu")(
        tp_cpu, tproto, tb).numpy()
    tok_gpu = make_eval_step(tiny, dtype=torch.float32, device="cuda")(
        to_device(tp_cpu, "cuda"), tproto.to("cuda"), tb).cpu().numpy()
    log(f"small f32 reference: card tokens == CPU plain tokens: "
        f"{bool((tok_cpu == tok_gpu).all())} ({tok_gpu[:2].tolist()})")
    if not (tok_cpu == tok_gpu).all():
        fail("f32 tokens on the card differ from the CPU plain path")

    del cast, h_k, h_p
    torch.cuda.empty_cache()
    return {"eval_step_ms": eval_step_ms, "eval_batch": EVAL_BATCH,
            "launches_per_eval_step": per_step, "encoder_rel_err": enc_rel,
            "rows_equal": rows_equal}


def train_slice(ctx):
    """The training slice: random-init t5-base, f32 master weights, bf16
    compute, dropout 0.1, ``make_train_step`` at batch 80 on one
    synthetic batch; ``train_step_ms``, the launch counts per step, every
    metric finite and the loss falling; at dropout 0 the parameter
    gradients through the kernels against the unfused encoder's; three
    f32 train steps on a tiny config on the card against the CPU plain
    path.
    4b. The same with the fused decoder (``fused_decoder``): the decoder's
    causal self-attention and cross-attention through K1′/K2 too (36
    launches of each per step), gradients against the unfused decoder,
    three tiny f32 steps on the card against the CPU, and
    ``make_loss_eval_step`` through K1 (36 launches per step) against the
    unfused decoder's loss.
    4c. Block recompute: one step from one state and one generator seed
    with ``remat`` False, "full" and "dots" gives the same loss,
    gradients and generator state; K1′ replays in the backward pass
    (72 launches per step); the peak device memory of each mode.

    The timed train steps' launches, the bf16 loss-eval step's and the
    fused optimizer's are counted."""
    t0 = time.time()
    tcfg, tparams, tproto0, tx, tbatch = train_setup()
    tm_ = tcfg.model
    gb = {k: torch.from_numpy(v).cuda() for k, v in tbatch.items()}
    log(f"train: t5-base f32 master weights, bf16 compute, dropout "
        f"{tm_.dropout_rate}, batch {TRAIN_BATCH}, lr {tcfg.train.lr}, "
        f"adam {tcfg.train.adam_impl}/{tcfg.train.adam_dtype}; set-up "
        f"{time.time() - t0:.1f} s")

    def drive_train(run_cfg, label, per_step):
        """TRAIN_WARMUP + TRAIN_STEPS train steps on one batch from the
        seeded init; checks the launches per step (K1 0, K1′ and K2
        ``per_step``; counted), finite metrics, a falling loss → (state,
        record)."""
        # warm-up of one step: step 0 is HF's zero update, every later
        # step runs at the configured lr
        state = TrainState.create(tparams, tx, tproto0, seed=0,
                                  warmup_iters=1.0, t_total=1000.0)
        step = make_train_step(run_cfg, dtype=torch.bfloat16, device="cuda")
        all_metrics = []
        for _ in range(TRAIN_WARMUP):
            state, met = step(state, tbatch)
            all_metrics.append({k: float(v) for k, v in met.items()})
        torch.cuda.synchronize()
        before = launches.read()
        ttimes = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, met = step(state, tbatch)
            torch.cuda.synchronize()
            ttimes.append((time.perf_counter() - t0) * 1e3)
            all_metrics.append({k: float(v) for k, v in met.items()})
        w = since(before)
        ctx.count(w)
        k1, k1p, k2 = w.k
        adamw_n = check_adamw(label, w, TRAIN_STEPS, 2, ctx)
        losses = [mt["loss"] for mt in all_metrics]
        ms = sorted(ttimes)[len(ttimes) // 2]
        log(f"{label}: bs {TRAIN_BATCH} bf16 train_step_ms={ms:.3f} (all: "
            f"{', '.join(f'{t:.3f}' for t in ttimes)}) launches over "
            f"{TRAIN_STEPS} steps: K1={k1} K1'={k1p} K2={k2} "
            f"fused_adamw={adamw_n}")
        log(f"{label} losses: {', '.join(f'{x:.4f}' for x in losses)}; last "
            f"metrics {json.dumps(all_metrics[-1])}")
        if not all(np.isfinite(v) for mt in all_metrics for v in mt.values()):
            fail(f"{label}: a train-step metric is not finite")
        if (k1, k1p, k2) != (0, per_step * TRAIN_STEPS,
                             per_step * TRAIN_STEPS):
            fail(f"{label}: expected 0 K1 and {per_step} K1'/K2 launches per "
                 f"train step, got {k1}/{k1p}/{k2} over {TRAIN_STEPS} steps")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail(f"{label}: the loss did not fall on a fixed batch: {losses}")
        if float(state.step) != TRAIN_WARMUP + TRAIN_STEPS:
            fail(f"{label}: train state step {int(state.step)}")
        return state, {"train_step_ms": ms, "train_step_ms_all": ttimes,
                       "losses": losses, "launches": (k1, k1p, k2),
                       "adamw_launches": adamw_n}

    def grad_check(params, m_kernel, m_plain, what):
        """Parameter gradients at dropout 0, kernels vs plain attention,
        in bf16 at the train batch and in f32 at batch 8."""
        rel = {}
        for dname, nb in (("bfloat16", TRAIN_BATCH), ("float32", 8)):
            dtp = getattr(torch, dname)
            part = {k: v[:nb] for k, v in gb.items()}
            lf, gf = _grads(vlt5, tree_leaves, tree_map, params, m_kernel,
                            part, tproto0, dtp)
            lu, gu = _grads(vlt5, tree_leaves, tree_map, params, m_plain,
                            part, tproto0, dtp)
            rel[dname] = float((gf - gu).norm() / gu.norm())
            log(f"grad check {what} {dname} bs {nb}: loss kernel {lf:.6f} "
                f"plain {lu:.6f}; |g_kernel - g_plain| / |g_plain| = "
                f"{rel[dname]:.3e} (tol {GRAD_REL_TOL[dname]:g})")
            if not rel[dname] <= GRAD_REL_TOL[dname]:
                fail(f"{dname} gradients through the kernels disagree with "
                     f"the {what}")
            del gf, gu
        return rel

    def small_train_reference(fused_decoder):
        """Three f32 train steps of a tiny config on the card == the CPU
        plain path (dropout 0). cuBLAS and the CPU sum in other orders,
        and the Adam direction m/(√v+ε) magnifies that for gradient
        entries near ε, so parameters are held to 3 % of one lr-1e-3
        update (a wrong gradient or Adam term moves them by a whole
        update) → (loss rel err, param max abs err)."""
        small = Config()
        small.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0,
                                        fused_decoder=fused_decoder)
        small.train.lr = 1e-3
        sp, spro, sbatches, stx = tiny_train_inputs(small)
        s_cpu = TrainState.create(sp, stx, spro, seed=0, warmup_iters=1.0,
                                  t_total=40.0)
        s_gpu = TrainState.create(to_device(sp, "cuda"), stx,
                                  spro.to("cuda"), seed=0, warmup_iters=1.0,
                                  t_total=40.0)
        step_cpu = make_train_step(small, dtype=torch.float32, device="cpu")
        step_gpu = make_train_step(small, dtype=torch.float32, device="cuda")
        loss_err = 0.0
        for b in sbatches:
            s_cpu, mc = step_cpu(s_cpu, b)
            s_gpu, mg = step_gpu(s_gpu, b)
            loss_err = max(loss_err, abs(float(mg["loss"])
                                         - float(mc["loss"]))
                           / abs(float(mc["loss"])))
        pc, pg = tree_leaves(s_cpu.params), tree_leaves(s_gpu.params)
        param_err = max(float((a - b.cpu()).abs().max())
                        for a, b in zip(pc, pg))
        log(f"small f32 train reference (fused_decoder={fused_decoder}): 3 "
            f"steps card vs CPU plain path: loss rel err {loss_err:.3e} "
            f"(tol 1e-5), param max abs err {param_err:.3e} (tol "
            f"{SMALL_PARAM_TOL:g})")
        if not (loss_err <= 1e-5 and param_err <= SMALL_PARAM_TOL):
            fail("f32 train steps on the card differ from the CPU plain path")
        return loss_err, param_err

    state, train = drive_train(tcfg, "train_step", tm_.num_layers)
    train_k1, train_k1p, train_k2 = train["launches"]
    # gradients through K1'/K2 vs the unfused encoder, at dropout 0
    m_unf = Config().model
    m_unf.fused_attention = False
    grad_rel = grad_check(state.params, tm_, m_unf, "unfused encoder")
    del state
    torch.cuda.empty_cache()
    small_loss_err, small_param_err = small_train_reference(False)

    # ---- 4b. the fused decoder (K4) ---------------------------------------
    fcfg = Config()
    fcfg.model.fused_decoder = True
    fm = fcfg.model
    # per step: 12 encoder blocks + 12 decoder self- + 12 cross-attentions
    fd_per_step = fm.num_layers + 2 * fm.num_decoder_layers
    state, fd_train = drive_train(fcfg, "train_step_fused_decoder",
                                  fd_per_step)
    fd_k1, fd_k1p, fd_k2 = fd_train["launches"]
    log(f"train_step_ms: unfused decoder {train['train_step_ms']:.3f}, fused "
        f"decoder {fd_train['train_step_ms']:.3f}")
    m_dec_unf = Config().model          # fused encoder, plain decoder
    fd_grad_rel = grad_check(state.params, fm, m_dec_unf, "unfused decoder")
    fd_small = small_train_reference(True)
    # the loss-eval step: K1 in the encoder and in both decoder attentions
    # (the bf16 step's launches counted)
    fd_eval = {}
    for dname, nb in (("bfloat16", TRAIN_BATCH), ("float32", 8)):
        dtp = getattr(torch, dname)
        part = {k: v[:nb] for k, v in tbatch.items()}
        plain_cfg = Config()
        loss_u = float(make_loss_eval_step(plain_cfg, dtype=dtp,
                                           device="cuda")(
            state.params, state.proto, part))
        ev = make_loss_eval_step(fcfg, dtype=dtp, device="cuda")
        ev(state.params, state.proto, part)          # warm-up
        torch.cuda.synchronize()
        before = launches.read()
        loss_f = float(ev(state.params, state.proto, part))
        w = since(before)
        if dname == "bfloat16":
            ctx.count(w)
        counts = w.k
        rel = abs(loss_f - loss_u) / abs(loss_u)
        fd_eval[dname] = {"loss_fused": loss_f, "loss_unfused": loss_u,
                          "rel": rel, "launches": counts}
        log(f"loss_eval fused decoder {dname} bs {nb}: loss {loss_f:.6f} vs "
            f"unfused decoder {loss_u:.6f}, rel {rel:.3e} (tol "
            f"{LOSS_EVAL_RTOL[dname]:g}); launches K1={counts[0]} "
            f"K1'={counts[1]} K2={counts[2]}")
        if counts != (fd_per_step, 0, 0):
            fail(f"expected {fd_per_step} K1 launches and no K1'/K2 per "
                 f"loss-eval step, got {counts}")
        if not (np.isfinite(loss_f) and rel <= LOSS_EVAL_RTOL[dname]):
            fail("the fused decoder's eval loss disagrees with the unfused "
                 "decoder's")

    # ---- 4c. remat: block recompute --------------------------------------
    remat = {}
    base_params = state.params
    for mode in (False, "full", "dots"):
        rstate = TrainState.create(base_params, tx, tproto0, seed=7,
                                   warmup_iters=1.0, t_total=1000.0)
        rstep = make_train_step(fcfg, dtype=torch.bfloat16, device="cuda",
                                remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_bytes = torch.cuda.memory_allocated()
        before = launches.read()
        rstate, met = rstep(rstate, tbatch)
        torch.cuda.synchronize()
        w = since(before)
        counts = w.k
        check_adamw(f"remat={mode}", w, 1, 2, ctx)
        step_peak = torch.cuda.max_memory_allocated() - before_bytes
        upd = tree_leaves(rstate.params)
        step_gen_state = rstate.generator.get_state()
        del rstate, rstep
        gen = torch.Generator(device="cuda").manual_seed(7)
        peak = {}
        loss_g, flat = _grads(vlt5, tree_leaves, tree_map, base_params, fm,
                              gb, tproto0, torch.bfloat16, generator=gen,
                              remat=mode, peak=peak)
        r = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
             "gen_state": step_gen_state, "grad_loss": loss_g,
             "grad_gen_state": gen.get_state(), "launches": counts,
             "step_peak_above_state_bytes": step_peak,
             "fwd_bwd_peak_bytes": peak["bytes"]}
        log(f"remat={mode}: loss {r['loss']:.6f} grad_norm "
            f"{r['grad_norm']:.6f} launches K1={counts[0]} K1'={counts[1]} "
            f"K2={counts[2]}; max_memory_allocated above the start: forward"
            f"+backward {peak['bytes'] / 2 ** 30:.3f} GiB, whole step "
            f"(optimizer included) {step_peak / 2 ** 30:.3f} GiB")
        if mode is False:
            r0, flat0, upd0 = r, flat, upd
            remat[mode] = r
            continue
        grad_err = float((flat - flat0).norm() / flat0.norm())
        params_equal = all(torch.equal(a, b) for a, b in zip(upd, upd0))
        same_gen = torch.equal(r["gen_state"], r0["gen_state"]) \
            and torch.equal(r["grad_gen_state"], r0["grad_gen_state"])
        r["grad_rel_err"] = grad_err
        remat[mode] = r
        log(f"remat={mode} vs none: loss equal {r['loss'] == r0['loss']}, "
            f"|g - g0| / |g0| = {grad_err:.3e} (tol {REMAT_GRAD_RTOL:g}), "
            f"updated parameters equal {params_equal}, generator state "
            f"equal {same_gen}")
        if not (r["loss"] == r0["loss"] and r["grad_loss"] == r0["grad_loss"]
                and grad_err <= REMAT_GRAD_RTOL and same_gen):
            fail(f"remat={mode} changed the step")
        # every fused block's forward replays once in the backward pass
        if r["launches"] != (0, 2 * fd_per_step, fd_per_step):
            fail(f"remat={mode}: expected K1'={2 * fd_per_step} and "
                 f"K2={fd_per_step} per step, got {r['launches']}")
        del flat, upd
    if r0["launches"] != (0, fd_per_step, fd_per_step):
        fail(f"remat=False: launches {r0['launches']}")
    remat_summary = {str(k): {
        key: v.get(key, 0.0) for key in (
            "loss", "launches", "fwd_bwd_peak_bytes",
            "step_peak_above_state_bytes", "grad_rel_err")}
        for k, v in remat.items()}
    del state, remat, base_params, tparams, flat0, upd0
    torch.cuda.empty_cache()
    return {
        "train_step_ms": train["train_step_ms"],
        "train_step_ms_all": train["train_step_ms_all"],
        "train_batch": TRAIN_BATCH, "train_losses": train["losses"],
        "launches_per_train_step": {
            "K1": train_k1 / TRAIN_STEPS, "K1p": train_k1p / TRAIN_STEPS,
            "K2": train_k2 / TRAIN_STEPS},
        "grad_rel_err": grad_rel, "small_train_loss_rel_err": small_loss_err,
        "small_train_param_err": small_param_err,
        "fused_decoder": {
            "train_step_ms": fd_train["train_step_ms"],
            "train_step_ms_all": fd_train["train_step_ms_all"],
            "train_losses": fd_train["losses"],
            "launches_per_train_step": {
                "K1": fd_k1 / TRAIN_STEPS, "K1p": fd_k1p / TRAIN_STEPS,
                "K2": fd_k2 / TRAIN_STEPS},
            "grad_rel_err": fd_grad_rel,
            "small_train_loss_rel_err": fd_small[0],
            "small_train_param_err": fd_small[1],
            "loss_eval": fd_eval, "kernel_times": ctx.dec_times},
        "remat": remat_summary}


def serving(ctx):
    """Serving: ``VQAServer`` over a ``VQAPredictor`` answers concurrent
    ``submit()`` calls with no errors.

    K1 once per layer per batch."""
    cfg = Config()
    store = MemoryFeatureStore()
    imgs = SyntheticVQA(32, seed=4).examples
    for i, ex in enumerate(imgs):
        store.put(f"img{i}", ex["vis_feats"], ex["boxes"])
    pred = VQAPredictor(cfg, ctx.params, ctx.proto, ctx.tok, store,
                        batch_size=16, dtype=torch.bfloat16, device="cuda")
    n_clients, per_client = 16, 3
    with VQAServer(pred, max_wait_ms=5.0) as srv:
        srv.submit("warm up?", "img0").result(timeout=300)
        warm = srv.stats()
        before = launches.read()
        answers, errors = [], []
        start = threading.Barrier(n_clients)

        def client(c):
            start.wait()
            for r in range(per_client):
                i = (c * per_client + r) % len(imgs)
                try:
                    answers.append(srv.submit(
                        f"what is in image {i}?", f"img{i}").result(
                            timeout=300))
                except Exception as e:       # recorded, fails the run
                    errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        serve_launches = since(before).of(fa.fused_attention)
        st = srv.stats()
    batches = st["batches"] - warm["batches"]
    log(f"serving: {len(answers)} answers from {n_clients} clients x "
        f"{per_client} in {wall:.3f} s; stats {json.dumps(st)}; "
        f"fused_attention launches={serve_launches} over {batches} batches")
    if any(t.is_alive() for t in threads):
        fail("serving clients did not finish")
    if errors or st["errors"] or len(answers) != n_clients * per_client:
        fail(f"serving errors: {errors[:3]} stats {st}")
    if not all(isinstance(a, str) for a in answers):
        fail("serving returned non-string answers")
    if serve_launches != cfg.model.num_layers * batches:
        fail(f"serving launched the kernel {serve_launches} times over "
             f"{batches} batches")
    return {"serve": st, "serve_wall_s": wall}
