"""Phase 9 of ``chip_smoke.py``: the model extensions."""

import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch

from smoke.harness import (BEAM, DROPOUT, EVAL_BATCH, GRAD_REL_TOL, HERE,
                           P7_CKPT, P7_DIR, SMALL_PARAM_TOL, TRAIN_BATCH,
                           _events_ms, _grads, check_adamw, fail, log)
from smoke.kernels import check_stride_refused, check_strided
from smoke.steps import tiny_train_inputs
from vqacl_tpu_torch.cli import export_pth
from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.models import bart, hf_import, vlt5
from vqacl_tpu_torch.models.convert import to_device
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import fused_attention as fa
from vqacl_tpu_torch.train import checkpoint as ckpt
from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves, tree_map,
                                         tree_unflatten)
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_eval_step, make_train_step
from vqacl_tpu_torch.utils.config import (Config, resolve_merged_qkv,
                                          tiny_model_config)

# rounds of train steps timed in turns (separate, merged, merged,
# separate); the classifier head's answers, optimizer steps and lr
MERGED_ROUNDS = 3
CLS_ANSWERS = 3129
CLS_STEPS = 5
CLS_LR = 1e-4
# VL-BART at bart-base's published widths (HF facebook/bart-base config:
# d_model 768, 6+6 layers, 12 heads, ffn 3072, vocab 50265, 1024
# positions), with VL-T5's region input (36 regions x 2048) and the
# text/answer lengths of the VQA configuration; random weights
BART_CFG = dict(vocab_size=50265, d_model=768, num_heads=12, d_ff=3072,
                num_layers=6, num_decoder_layers=6,
                max_position_embeddings=1024, pad_token_id=1,
                eos_token_id=2, decoder_start_token_id=2, dropout_rate=0.1,
                feat_dim=2048, pos_dim=4, n_images=2,
                use_vis_order_embedding=True, use_vis_layer_norm=True,
                individual_vis_layer_norm=True, layer_norm_epsilon=1e-5,
                use_vision=True, n_boxes=36, text_len=20, target_len=10)
BART_TINY = dict(BART_CFG, vocab_size=128, d_model=32, num_heads=4, d_ff=64,
                 num_layers=2, num_decoder_layers=2,
                 max_position_embeddings=64, dropout_rate=0.0, feat_dim=16,
                 n_boxes=4, text_len=6, target_len=5)
# f32 on the card vs the CPU: the same products summed in other orders
F32_CARD_RTOL = 1e-5


def _bart_inputs(c, B, seed):
    """(input_ids with ragged pad, attention mask, region feats, boxes,
    labels with -100 pad) on the card for a BART config namespace."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, c.vocab_size, (B, c.text_len), generator=g,
                        device="cuda")
    n = torch.randint(2, c.text_len + 1, (B,), generator=g, device="cuda")
    pos = torch.arange(c.text_len, device="cuda")[None]
    ids = torch.where(pos < n[:, None], ids, c.pad_token_id)
    feats = torch.randn(B, c.n_boxes, c.feat_dim, generator=g, device="cuda")
    x1y1 = 0.5 * torch.rand(B, c.n_boxes, 2, generator=g, device="cuda")
    boxes = torch.cat([x1y1, x1y1 + 0.4 * torch.rand(
        B, c.n_boxes, 2, generator=g, device="cuda")], dim=-1).clamp(0, 1)
    labels = torch.randint(3, c.vocab_size, (B, c.target_len), generator=g,
                           device="cuda")
    labels[:, c.target_len // 2:] = -100
    return ids, (ids != c.pad_token_id).float(), feats, boxes, labels


def model_extensions(ctx):
    """The model extensions at t5-base. K1, K1′ and K2 on strided views of
    the merged projection layouts (q|k|v [B,S,3·768], cross k|v [B,Sk,2·768], a
    12-layer cross-K/V fold) at the eval, train and decoder shapes, rates 0
    and 0.1, bf16 and f32, each bit-equal to the same kernel on dense
    copies, K2 also into one merged gradient buffer, and each strided launch
    counted; strided beside dense times; a bf16 row stride that is not a
    multiple of 8 refused with ValueError before any launch.
    ``make_train_step`` with ``merged_qkv`` (and with the fused decoder and
    ``folded_cross_kv``) at batch 80, bf16, dropout 0.1, timed in turns with
    the separate path (``MERGED_ROUNDS`` rounds of separate, merged, merged,
    separate), 12 (36) strided K1′ and K2 per step, loss and gradients at
    dropout 0 within phase 4's bound of the separate path's; greedy and beam
    tokens with merged and folded projections equal to the separate path's
    at batch 100; tiny f32 merged + folded runs on the card equal to the
    CPU. The classifier head (``CLS_ANSWERS`` answers, batch 80, bf16):
    ``CLS_STEPS`` HF-AdamW steps over (params, head) on soft targets, the
    loss falling, 12 K1′ and K2 per step; ``classifier_logits`` at batch 100
    through K1, timed. Weights: t5-base through ``.pth``,
    ``model.safetensors`` (written by the port's own writer, read by
    ``load_t5_base``), ``export_pth`` on phase 7's ER checkpoint and the DCP
    directory checkpoint, each bit-equal, with seconds and bytes, and the
    eval step's tokens on the re-imported weights equal. VL-BART at
    bart-base's widths (``BART_CFG``): encode + decode forward at batch 80,
    bf16, finite and timed; a tiny f32 run on the card equal to the CPU
    within ``F32_CARD_RTOL``. Phase 7's loop resolves ``merged_qkv`` to True
    (as JAX's trainer does), so its launch checks also require every launch
    strided.

    Runs on phase 3's t5-base; phase 7's ER checkpoint (``P7_CKPT``) is
    removed at the end. The merged train steps, decodes and classifier
    head's runs are counted."""
    try:
        return _model_extensions(ctx.params, ctx.proto, ctx, P7_CKPT)
    finally:
        shutil.rmtree(P7_DIR, ignore_errors=True)


def _model_extensions(params, proto, ctx, phase7_ckpt):



    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    def counted(fn):
        """``fn()`` with its launches counted → (output, (K1, K1′, K2),
        strided (K1, K1′, K2), the window)."""
        res, w = ctx.counted(fn)
        return res, w.k, w.strided, w

    def config(merged, folded=False, fused_decoder=False, model=None):
        c = Config()
        if model is not None:
            c.model = model
        c.model.merged_qkv = merged
        c.model.folded_cross_kv = folded
        c.model.fused_decoder = fused_decoder
        return c

    base = Config().model
    H, dk, S, T = base.num_heads, base.d_kv, base.encoder_len, \
        base.target_max_length
    Lt = base.max_text_length
    n_dec = base.num_decoder_layers

    # ---- 9a. K1, K1′ and K2 on strided views ----------------------------
    strided_rows = {}
    for rate in (0.0, DROPOUT):
        timed = rate == DROPOUT
        strided_rows[f"train_{rate}"] = check_strided(
            fa, "train_shape", TRAIN_BATCH, S, S, H, dk, Lt, "bfloat16", rate,
            "self", timed=timed)
        strided_rows[f"decoder_self_{rate}"] = check_strided(
            fa, "decoder_self", TRAIN_BATCH, T, T, H, dk, T, "bfloat16", rate,
            "self", causal=True, timed=timed)
        strided_rows[f"decoder_cross_{rate}"] = check_strided(
            fa, "decoder_cross", TRAIN_BATCH, T, S + 2, H, dk, 0, "bfloat16",
            rate, "cross", timed=timed)
        check_strided(fa, "decoder_cross_folded", TRAIN_BATCH, T, S + 2, H,
                      dk, 0, "bfloat16", rate, "folded")
        check_strided(fa, "odd_width_f32", 3, 13, 13, 4, 8, 5, "float32",
                      rate, "self")
        check_strided(fa, "rect_f32", 8, 10, 58, H, dk, 0, "float32", rate,
                      "cross")
    strided_rows["eval_timed"] = check_strided(
        fa, "eval_shape", EVAL_BATCH, S, S, H, dk, Lt, "bfloat16", 0.0,
        "self", timed=True)
    for kind, shape in (("decoder_self_eval", (T, T, T, "self", True)),
                        ("decoder_cross_eval", (T, S + 2, 0, "cross",
                                                False))):
        Tq, Sk, L_, layout, causal = shape
        strided_rows[kind] = check_strided(
            fa, kind, TRAIN_BATCH, Tq, Sk, H, dk, L_, "bfloat16", 0.0,
            layout, causal=causal, timed=True)
    check_stride_refused(fa)
    out["strided"] = {k: v for k, v in strided_rows.items() if v}

    # ---- 9b. merged and folded train steps at t5-base --------------------
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    gb = {k: torch.from_numpy(v).cuda() for k, v in tbatch.items()}
    sep_cfg, mer_cfg = config(False), config(True)
    fd_sep, fd_mer = config(False, fused_decoder=True), \
        config(True, folded=True, fused_decoder=True)
    tx = make_transform(sep_cfg.train)
    proto0 = ProtoState.create(base.n_ques_types, base.n_categories,
                               base.d_model, device="cuda")
    train = {}
    for label, c_sep, c_mer, per_step in (
            ("encoder", sep_cfg, mer_cfg, base.num_layers),
            ("fused_decoder", fd_sep, fd_mer, base.num_layers + 2 * n_dec)):
        steps = {"separate": make_train_step(c_sep, dtype=bf16,
                                             device="cuda"),
                 "merged": make_train_step(c_mer, dtype=bf16, device="cuda")}
        states = {n: TrainState.create(params, tx, proto0, seed=0,
                                       warmup_iters=1.0, t_total=1000.0)
                  for n in steps}
        ms = {n: [] for n in steps}
        losses = {n: [] for n in steps}
        merged_counts = []
        for r in range(MERGED_ROUNDS + 1):       # round 0 warms up
            for n in ("separate", "merged", "merged", "separate"):
                t0 = time.perf_counter()
                (states[n], met), k, ks, w = counted(
                    lambda n=n: steps[n](states[n], tbatch))
                check_adamw(f"merged_qkv {label} {n}", w, 1, 2, ctx)
                if r:
                    ms[n].append((time.perf_counter() - t0) * 1e3)
                losses[n].append(float(met["loss"]))
                if n == "merged":
                    merged_counts.append((k, ks))
        want = ((0, per_step, per_step), (0, per_step, per_step))
        med = lambda xs: sorted(xs)[len(xs) // 2]
        rec = {"train_step_ms": {n: med(v) for n, v in ms.items()},
               "train_step_ms_all": ms, "losses": losses,
               "launches_per_merged_step": merged_counts[-1]}
        log(f"merged_qkv {label}: bs {TRAIN_BATCH} bf16 dropout "
            f"{base.dropout_rate} train_step_ms separate "
            f"{rec['train_step_ms']['separate']:.3f} merged "
            f"{rec['train_step_ms']['merged']:.3f} (in turns: separate "
            f"{', '.join(f'{t:.3f}' for t in ms['separate'])}; merged "
            f"{', '.join(f'{t:.3f}' for t in ms['merged'])}); launches per "
            f"merged step K1/K1'/K2 {list(merged_counts[-1][0])}, strided "
            f"{list(merged_counts[-1][1])} (expected {list(want[1])}); "
            f"losses separate {', '.join(f'{x:.4f}' for x in losses['separate'])}"
            f"; merged {', '.join(f'{x:.4f}' for x in losses['merged'])}")
        if any(tuple(map(tuple, c)) != want for c in merged_counts):
            fail(f"merged_qkv {label}: launches per step {merged_counts}, "
                 f"expected {want}")
        if not all(np.isfinite(v).all() for v in losses.values()) \
                or not np.mean(losses["merged"][-3:]) < np.mean(
                    losses["merged"][:3]):
            fail(f"merged_qkv {label}: losses not finite or not falling: "
                 f"{losses}")
        # at dropout 0: the merged path against the separate one
        lu, gu = _grads(vlt5, tree_leaves, tree_map, params, c_sep.model, gb,
                        proto0, bf16)
        lm, gm = _grads(vlt5, tree_leaves, tree_map, params, c_mer.model, gb,
                        proto0, bf16)
        rec["loss_rel"] = abs(lm - lu) / abs(lu)
        rec["grad_rel"] = float((gm - gu).norm() / gu.norm())
        tol = GRAD_REL_TOL["bfloat16"]
        log(f"merged_qkv {label} vs separate at dropout 0, bf16 bs "
            f"{TRAIN_BATCH}: loss {lm:.6f} vs {lu:.6f} (rel "
            f"{rec['loss_rel']:.3e}), |g_merged - g_separate| / "
            f"|g_separate| = {rec['grad_rel']:.3e} (tol {tol:g})")
        if not (rec["loss_rel"] <= tol and rec["grad_rel"] <= tol):
            fail(f"merged_qkv {label}: loss or gradients off the separate "
                 f"path's")
        del gu, gm, states
        train[label] = rec
    out["train"] = train
    torch.cuda.empty_cache()

    # greedy and beam tokens: merged and folded cross-K/V precompute vs
    # separate, bf16 at the eval batch
    cast = vlt5.cast_params_for_inference(params, bf16)
    ebatch = collate(SyntheticVQA(EVAL_BATCH, seed=0).examples,
                     with_targets=False)["tensors"]
    decode = {}
    for beams in (1, BEAM):
        toks = {}
        for n, c in (("separate", config(False)), ("merged", config(True)),
                     ("folded", config(True, folded=True))):
            step = make_eval_step(c, dtype=bf16, device="cuda",
                                  num_beams=beams)
            tk, k, ks, _ = counted(lambda: step(cast, proto, ebatch))
            toks[n] = tk.cpu().numpy()
            if k != (base.num_layers, 0, 0) or ks != (
                    base.num_layers if c.model.merged_qkv else 0, 0, 0):
                fail(f"decode {n}: launches {k}, strided {ks}")
        eq = {n: bool((toks[n] == toks["separate"]).all())
              for n in ("merged", "folded")}
        decode["greedy" if beams == 1 else f"beam{beams}"] = eq
        log(f"decode {'greedy' if beams == 1 else f'beam {beams}'} bs "
            f"{EVAL_BATCH} bf16: tokens equal to the separate path's: "
            f"{json.dumps(eq)}; rows equal merged "
            f"{float((toks['merged'] == toks['separate']).all(1).mean()):.3f}"
            f", folded "
            f"{float((toks['folded'] == toks['separate']).all(1).mean()):.3f}")
        if not all(eq.values()):
            fail("merged or folded decode tokens differ from the separate "
                 "path's")
    out["decode_tokens_equal"] = decode

    # tiny f32: merged + folded card == CPU (three train steps, tokens)
    tiny = {}
    for fused_decoder in (False, True):
        small = config(True, folded=True, fused_decoder=fused_decoder,
                       model=tiny_model_config(vocab_size=32200,
                                               dropout_rate=0.0))
        small.train.lr = 1e-3
        sp, spro, sb, stx = tiny_train_inputs(small)
        runs = {}
        for dev in ("cuda", "cpu"):
            st = TrainState.create(to_device(sp, dev), stx, spro.to(dev),
                                   seed=0, warmup_iters=1.0, t_total=40.0)
            step = make_train_step(small, dtype=f32, device=dev)
            ls = []
            for b in sb:
                st, met = step(st, b)
                ls.append(float(met["loss"]))
            ev = {nb: make_eval_step(small, dtype=f32, device=dev,
                                     num_beams=nb)(
                st.params, st.proto, sb[0]).cpu().numpy()
                for nb in (1, 3)}
            runs[dev] = (ls, tree_leaves(st.params), ev)
        (lg, pg, eg), (lc, pc, ec) = runs["cuda"], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        param_err = max(float((a.cpu() - b).abs().max())
                        for a, b in zip(pg, pc))
        same = all((eg[nb] == ec[nb]).all() for nb in eg)
        tiny[f"fused_decoder={fused_decoder}"] = {
            "loss_rel_err": loss_err, "param_err": param_err,
            "tokens_equal": bool(same)}
        log(f"small f32 merged+folded (fused_decoder={fused_decoder}): 3 "
            f"steps card vs CPU: loss rel err {loss_err:.3e} (tol 1e-5), "
            f"param max abs err {param_err:.3e} (tol {SMALL_PARAM_TOL:g}); "
            f"greedy and beam-3 tokens equal {same}")
        if not (loss_err <= 1e-5 and param_err <= SMALL_PARAM_TOL and same):
            fail("merged+folded f32 on the card differs from the CPU")
    out["tiny_merged_folded"] = tiny

    # ---- 9c. the classifier head ----------------------------------------
    ccfg = Config()
    resolve_merged_qkv(ccfg.model)
    cm = ccfg.model
    head = vlt5.init_classifier_head(1, cm, CLS_ANSWERS, device="cuda")
    tree = {"params": params, "head": head}
    cls_tx = make_transform(ccfg.train)
    opt = cls_tx.init(tree)
    rng = np.random.default_rng(9)
    tgt = np.zeros((TRAIN_BATCH, CLS_ANSWERS), np.float32)
    for r in range(TRAIN_BATCH):       # VQA soft scores on 1-3 answers
        n = int(rng.integers(1, 4))
        tgt[r, rng.choice(CLS_ANSWERS, n, replace=False)] = rng.choice(
            [0.3, 0.6, 0.9, 1.0], n)
    tgt = torch.from_numpy(tgt).cuda()

    def cls_step(tree, opt):
        live = tree_map(lambda p: p.detach().requires_grad_(), tree)
        hidden, mask = vlt5.encode(live["params"], cm, gb["input_ids"],
                                   gb["vis_feats"], gb["boxes"], dtype=bf16)
        logits = vlt5.classifier_logits(live["head"], cm, live["params"],
                                        hidden, mask, dtype=bf16)
        loss = vlt5.classifier_bce_loss(logits, tgt)
        leaves = tree_leaves(live)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = tree_unflatten(tree, [torch.zeros_like(p) if x is None else x
                                  for p, x in zip(leaves, gs)])
        with torch.no_grad():
            upd, opt = cls_tx.update(g, opt, tree)
            tree = tree_map(lambda p, u: p - CLS_LR * u, tree, upd)
        return tree, opt, float(loss.detach())

    cls_losses, cls_counts, cls_ms = [], [], []
    for _ in range(CLS_STEPS):
        t0 = time.perf_counter()
        (tree, opt, loss), k, ks, _ = counted(lambda: cls_step(tree, opt))
        cls_ms.append((time.perf_counter() - t0) * 1e3)
        cls_losses.append(loss)
        cls_counts.append((k, ks))
    L = cm.num_layers
    with torch.no_grad():
        ccast = vlt5.cast_params_for_inference(tree["params"], bf16)
        eb = {k: torch.from_numpy(ebatch[k]).cuda()
              for k in ("input_ids", "vis_feats", "boxes")}

        def cls_eval():
            hidden, mask = vlt5.encode(ccast, cm, **eb, dtype=bf16)
            return vlt5.classifier_logits(tree["head"], cm, ccast, hidden,
                                          mask, dtype=bf16)

        cls_eval()
        (logits, eval_ms), k_eval, ks_eval, _ = counted(
            lambda: _events_ms(cls_eval, 3))
    out["classifier"] = {"losses": cls_losses, "step_ms": cls_ms,
                         "eval_ms": eval_ms, "launches_per_step": cls_counts,
                         "eval_launches": [k_eval, ks_eval]}
    log(f"classifier head: {CLS_ANSWERS} answers, bs {TRAIN_BATCH} bf16, "
        f"HF-AdamW lr {CLS_LR:g} over (params, head): BCE "
        f"{', '.join(f'{x:.5f}' for x in cls_losses)}; step ms (host clock) "
        f"{', '.join(f'{t:.3f}' for t in cls_ms)}; launches per step "
        f"K1/K1'/K2 {list(cls_counts[-1][0])} strided "
        f"{list(cls_counts[-1][1])}; eval bs {EVAL_BATCH}: classifier_logits "
        f"{tuple(logits.shape)} in {', '.join(f'{t:.3f}' for t in eval_ms)} "
        f"ms (CUDA events), launches {list(k_eval)} strided {list(ks_eval)}")
    if any(c != ((0, L, L), (0, L, L)) for c in cls_counts) \
            or k_eval != (3 * L, 0, 0) or ks_eval != (3 * L, 0, 0):
        fail("classifier head: unexpected kernel launches")
    if not (np.isfinite(cls_losses).all() and cls_losses[-1] < cls_losses[0]
            and bool(torch.isfinite(logits).all())):
        fail(f"classifier head: loss did not fall: {cls_losses}")
    del tree, opt, ccast
    torch.cuda.empty_cache()

    # ---- 9d. weight import and export, the directory checkpoint ---------
    work = os.path.join(HERE, "build", "chip_smoke", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ref_leaves = {k: v.cpu() for k, v in ckpt._flat_tensors(params).items()}

    def bit_equal(tree):
        flat = ckpt._flat_tensors(tree)
        return set(flat) == set(ref_leaves) and all(
            torch.equal(flat[k].cpu(), ref_leaves[k]) for k in flat)

    def du(path):
        if os.path.isfile(path):
            return os.path.getsize(path)
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)

    io = {}

    def timed_io(name, save, load, path):
        t0 = time.perf_counter()
        save()
        t1 = time.perf_counter()
        got = load()
        t2 = time.perf_counter()
        io[name] = {"save_s": t1 - t0, "load_s": t2 - t1, "bytes": du(path)}
        return got

    pth = os.path.join(work, "t5_base.pth")
    back = timed_io("pth", lambda: hf_import.save_reference_pth(
        params, pth, base), lambda: hf_import.load_reference_pth(pth, base),
        pth)
    eq_pth = bit_equal(back)
    st_dir = os.path.join(work, "t5_base_safetensors")
    os.makedirs(st_dir)
    back_st = timed_io("safetensors", lambda: hf_import.write_safetensors(
        hf_import.to_state_dict(params, base),
        os.path.join(st_dir, "model.safetensors")),
        lambda: hf_import.load_t5_base(base, st_dir), st_dir)
    eq_st = bit_equal(back_st)
    # the eval step's tokens with the re-imported weights
    ev = make_eval_step(Config(), dtype=bf16, device="cuda")
    tok_orig = ev(cast, proto, ebatch).cpu().numpy()
    tok_back = ev(vlt5.cast_params_for_inference(to_device(back_st, "cuda"),
                                                 bf16), proto,
                  ebatch).cpu().numpy()
    same_tok = bool((tok_orig == tok_back).all())
    del back, back_st
    # export_pth on phase 7's checkpoint: the .pth holds its parameters
    exp = os.path.join(work, "phase7_export.pth")
    t0 = time.perf_counter()
    export_pth.main([phase7_ckpt, exp])
    export_s = time.perf_counter() - t0
    p7, _, _ = ckpt.load_checkpoint(phase7_ckpt)
    e7 = hf_import.load_reference_pth(exp, base)
    f7, fe = ckpt._flat_tensors(p7), ckpt._flat_tensors(e7)
    eq_export = set(f7) == set(fe) and all(torch.equal(f7[k], fe[k])
                                           for k in f7)
    io["export_pth"] = {"save_s": export_s, "bytes": du(exp)}
    del p7, e7, f7, fe
    # the directory checkpoint (torch.distributed.checkpoint)
    dcp_dir = os.path.join(work, "dcp")
    dp, dproto, dstep = timed_io(
        "dcp", lambda: ckpt.save_checkpoint_dcp(dcp_dir, params, proto, 7),
        lambda: ckpt.load_checkpoint_dcp(dcp_dir), dcp_dir)
    eq_dcp = bit_equal(dp) and dstep == 7 and all(
        torch.equal(a.cpu(), b) for a, b in zip(proto, dproto))
    del dp, dproto
    shutil.rmtree(work, ignore_errors=True)
    out["io"] = io
    out["io_equal"] = {"pth": eq_pth, "safetensors": eq_st,
                       "eval_tokens": same_tok, "export_pth": eq_export,
                       "dcp": eq_dcp}
    log("weights: " + "; ".join(
        f"{n} {r['bytes']} bytes, save {r['save_s']:.3f} s"
        + (f", load {r['load_s']:.3f} s" if "load_s" in r else "")
        for n, r in io.items())
        + f"; bit-equal / equal: {json.dumps(out['io_equal'])}")
    if not all(out["io_equal"].values()):
        fail("weights changed through import, export or the directory "
             "checkpoint")

    # ---- 9e. VL-BART at bart-base widths --------------------------------
    bc = SimpleNamespace(**BART_CFG)
    bp = bart.init_bart_params(0, bc, device="cuda")
    ids, am, feats, boxes, labels = _bart_inputs(bc, TRAIN_BATCH, seed=3)

    def bart_fwd():
        with torch.no_grad():
            enc, mask = bart.bart_encode(bp, bc, ids, am, feats, boxes,
                                         dtype=bf16)
            return bart.bart_decode_train(bp, bc, enc, mask, labels,
                                          dtype=bf16)

    bart_fwd()
    logits, bart_ms = _events_ms(bart_fwd, 3)
    ok_shape = tuple(logits.shape) == (TRAIN_BATCH, bc.target_len,
                                       bc.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    del bp, logits
    tc = SimpleNamespace(**BART_TINY)
    tp = bart.init_bart_params(1, tc, device="cpu")
    t_in = _bart_inputs(tc, 4, seed=4)
    bart_err = 0.0
    for regions in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            i, a, f_, b_, lab = (x.to(dev) for x in t_in)
            pd = to_device(tp, dev)
            enc, mask = bart.bart_encode(pd, tc, i, a,
                                         f_ if regions else None,
                                         b_ if regions else None)
            res[dev] = bart.bart_decode_train(pd, tc, enc, mask,
                                              lab).cpu()
        diff = (res["cuda"] - res["cpu"]).abs()
        bart_err = max(bart_err, float((diff / (F32_CARD_RTOL * (
            1.0 + res["cpu"].abs()))).max()))
    out["bart"] = {"forward_ms": bart_ms, "finite": finite,
                   "shape_ok": ok_shape, "tiny_f32_err_over_tol": bart_err}
    log(f"vl_bart: bart-base widths ({bc.num_layers}+{bc.num_decoder_layers}"
        f" layers, d_model {bc.d_model}, vocab {bc.vocab_size}), bs "
        f"{TRAIN_BATCH} bf16, {bc.text_len} text + {bc.n_boxes} regions, "
        f"{bc.target_len} answer tokens: encode + decode_train "
        f"{', '.join(f'{t:.3f}' for t in bart_ms)} ms (CUDA events), finite "
        f"{finite}, shape ok {ok_shape}; tiny f32 card vs CPU with and "
        f"without regions: max err / (1e-5 (1 + |cpu|)) = {bart_err:.3e}")
    if not (finite and ok_shape and bart_err <= 1.0):
        fail("VL-BART: not finite, wrong shape or the card differs from "
             "the CPU")
    k = ctx.launched().k
    log(f"phase 9 launches K1={k[0]} K1'={k[1]} K2={k[2]}")
    return {"model_extensions": out, "model_extensions_launches": list(k)}
