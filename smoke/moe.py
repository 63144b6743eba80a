"""Phase 16 of ``chip_smoke.py``: the grouped expert GEMMs."""

import json
import math
import shutil
import tempfile

import torch

from portbench.roofline import moe_experts as roof
from smoke.harness import check_adamw, fail, log, since, time_ms
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.models import moonlight
from vqacl_tpu_torch.ops import launches, moe
from vqacl_tpu_torch.train.optim import make_transform
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_train_step
from vqacl_tpu_torch.utils.config import Config, tiny_model_config

# phase 16, the grouped expert GEMMs (ops/moe.py) at the VL-Moonlight
# cell's shape: 80 x 66 tokens, 6 of 64 experts each, 8 held
MOE_T, MOE_K, MOE_ROUTER, MOE_HELD, MOE_D, MOE_F = 5280, 6, 64, 8, 2048, 1408
# its main-path runs: VL-Moonlight at full widths with 1 dense + 2 MoE
# layers; the CL run's items per task (train, val, test) and batches
P16_MODEL = dict(d_model=2048, num_heads=16, vocab_size=163840,
                 intermediate_size=11264, moe_intermediate_size=1408,
                 kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                 v_head_dim=128, feat_dim=2048)
P16_ITEMS = (160, 40, 40)
P16_BATCH = (80, 40)


def _moe_inputs(seed, idx=None):
    """x [T, D] bf16, f32 expert weights (normal x 0.02), the router's
    choices (top 6 of seeded sigmoid scores unless given) and their
    weights, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, E, D, F = MOE_T, MOE_HELD, MOE_D, MOE_F
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    w = [torch.randn(s, generator=g, device="cuda") * 0.02
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    if idx is None:
        s = torch.rand(T, MOE_ROUTER, generator=g, device="cuda")
        idx = torch.topk(s, MOE_K, dim=-1).indices
    wt = torch.rand(idx.shape, generator=g, device="cuda")
    return x, w, idx, wt, moe.route_plan(idx, E)


def _moe_grads(moe, fn, x, w, plan, wt, dy):
    xl = x.detach().requires_grad_()
    wl = [t.detach().requires_grad_() for t in w]
    y = moe.combine(fn(xl, plan, *wl), plan, wt)
    gr = torch.autograd.grad((y * dy).sum(), [xl] + wl)
    return y.detach(), gr


def _moe_rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def grouped_experts(ctx):
    """The grouped expert GEMMs of VL-Moonlight's MoE layers (``ops/moe.py``,
    ``csrc/moe_grouped_gemm.cu``) against their plain version at the cell's
    shape (8 held experts, 495 ± the seeded spread of rows each): the
    forward and every gradient through the combine, also with every token
    sent to one expert and the others empty; the kernels' times beside their
    bound, the plain version's and ``torch._grouped_mm``'s (a yardstick
    only); then the main path at full widths (1 dense + 2 MoE layers): two
    train steps, the second under
    ``torch.cuda.set_sync_debug_mode("error")``, and the CL trainer's train,
    replay and validation, with the kernels' launches counted in every step
    (6 a MoE layer) and the fused optimizer's pair checked in every update.

    The main path's launches are counted; its row is the kernels line's
    ``moe_grouped_gemm``."""
    rec = {}
    ref_fn = moe.grouped_swiglu_reference
    # (a) the cell's routing: held rows per expert 495 +- the seeded spread
    for name, seed, idx in (("cell", 0, None), ("cell_seed1", 1, None),
                            ("all_to_one", 2, "one")):
        if idx == "one":
            col = torch.full((MOE_T, 1), 3, device="cuda")
            idx = torch.cat([col, torch.arange(8, 8 + MOE_K - 1,
                                               device="cuda").expand(
                MOE_T, MOE_K - 1)], 1)
        x, w, idx, wt, plan = _moe_inputs(seed, idx)
        counts = (plan.offsets[1:] - plan.offsets[:-1]).tolist()
        dy = torch.randn(MOE_T, MOE_D, device="cuda")
        y, gk = _moe_grads(moe, moe.grouped_swiglu, x, w, plan, wt, dy)
        yr, gr = _moe_grads(moe, ref_fn, x, w, plan, wt, dy)
        errs = {"y": _moe_rel(y, yr)}
        for k, a, b in zip(("dx", "dwg", "dwu", "dwd"), gk, gr):
            errs[k] = _moe_rel(a, b)
        log(f"  moe {name}: rows {counts} rel err {errs}")
        # bf16 operands and outputs on both sides, f32 sums in other
        # orders (and f32 vs bf16 intermediates at the activation)
        if max(errs.values()) > 2e-2 or not all(
                math.isfinite(v) for v in errs.values()):
            fail(f"phase 16 {name}: grouped experts off the plain version "
                 f"{errs}")
        rec[name] = {"rows": counts, "rel_err": errs}
    # (b) times at the cell's routing
    x, w, idx, wt, plan = _moe_inputs(0)
    n = int(plan.offsets[-1])
    fwd_b = sum(roof.work(k, n, MOE_D, MOE_F, MOE_HELD)[0]
                for k in roof.KINDS[:2])
    fwd_f = sum(roof.work(k, n, MOE_D, MOE_F, MOE_HELD)[1]
                for k in roof.KINDS[:2])
    all_b = sum(roof.work(k, n, MOE_D, MOE_F, MOE_HELD)[0]
                for k in roof.KINDS)
    all_f = sum(roof.work(k, n, MOE_D, MOE_F, MOE_HELD)[1]
                for k in roof.KINDS)
    bound_fwd = sum(roof.bound_s(k, n, MOE_D, MOE_F, MOE_HELD)
                    for k in roof.KINDS[:2]) * 1e3
    bound_all = sum(roof.bound_s(k, n, MOE_D, MOE_F, MOE_HELD)
                    for k in roof.KINDS) * 1e3
    xg = x.detach().requires_grad_()
    wl = [t.detach().requires_grad_() for t in w]
    dout = torch.randn(MOE_T * MOE_K, MOE_D, device="cuda",
                       dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            moe.grouped_swiglu(x, plan, *w)

    def fwd_bwd():
        out = moe.grouped_swiglu(xg, plan, *wl)
        torch.autograd.grad(out, [xg] + wl, dout)

    def plain():
        with torch.no_grad():
            ref_fn(x, plan, *w)

    before = launches.read()
    fwd()
    fwd_bwd()
    n_k = since(before).of(moe.grouped_swiglu)
    if n_k != 2 + 6:
        fail(f"phase 16: {n_k} grouped GEMM launches for a forward and a "
             f"forward + backward, not 8")
    t_fwd = time_ms([fwd], iters=20, warmup=3)
    t_all = time_ms([fwd_bwd], iters=10, warmup=2)
    t_plain = time_ms([plain], iters=5, warmup=1, spin=False)
    lib = None
    if hasattr(torch, "_grouped_mm"):
        try:
            wgu = moe.interleave(w[0], w[1])
            rows = x[plan.rows.long()]
            ends = plan.offsets[1:].contiguous()

            def library():
                torch._grouped_mm(rows, wgu, offs=ends)
            lib = time_ms([library], iters=20, warmup=3)
        except Exception as e:   # the yardstick only: say why it is gone
            log(f"  torch._grouped_mm: {type(e).__name__}: {e}")
    rec["times"] = {
        "rows": n, "fwd_ms": t_fwd, "fwd_bwd_ms": t_all,
        "plain_fwd_ms": t_plain, "library_gate_up_ms": lib,
        "fwd_bound_ms": bound_fwd, "all_bound_ms": bound_all,
        "fwd_bytes_flops": [fwd_b, fwd_f], "all_bytes_flops": [all_b, all_f],
        "fwd_roofline_pct": 100 * bound_fwd / t_fwd,
        "all_roofline_pct": 100 * bound_all / t_all}
    log(f"  moe times {json.dumps(rec['times'])}")
    # (c) the main path: a train step under sync debug mode, then the CL
    # trainer's train, replay and validation
    m = tiny_model_config(
        arch="moonlight", num_hidden_layers=3, first_k_dense_replace=1,
        router_experts=MOE_ROUTER, experts_held=MOE_HELD,
        num_experts_per_tok=MOE_K, n_shared_experts=2, n_boxes=36,
        max_text_length=20, target_max_length=10, gen_max_length=6,
        layer_norm_epsilon=1e-5, use_prototype=False, dropout_rate=0.0,
        **P16_MODEL)
    cfg = Config()
    cfg.model = m
    cfg.train.batch_size, cfg.train.valid_batch_size = P16_BATCH
    cfg.train.epochs = 1
    cfg.train.m_size = P16_ITEMS[0]
    cfg.output = tempfile.mkdtemp(prefix="p16_")
    params = moonlight.init_params(0, m, "cuda")
    tx = make_transform(cfg.train)
    state = TrainState.create(params, tx, None, seed=1)._replace(
        router_bias=moonlight.init_router_bias(m, "cuda"))
    state = state.reset_optimizer(tx, 0.0, 100.0)
    step = make_train_step(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    B, L = P16_BATCH[0], 20
    batch = {"input_ids": torch.randint(3, 32000, (B, L), generator=g,
                                        device="cuda"),
             "vis_feats": torch.randn(B, 36, m.feat_dim, generator=g,
                                      device="cuda"),
             "boxes": torch.rand(B, 36, 4, generator=g, device="cuda"),
             "target_ids": torch.randint(3, 32000, (B, 10), generator=g,
                                         device="cuda"),
             "scores": torch.ones(B, device="cuda"),
             "ques_labels": torch.zeros(B, 10, device="cuda"),
             "cate_labels": torch.zeros(B, 80, device="cuda")}
    per = 6 * moonlight.moe_layers(m)
    before = launches.read()
    state, met = step(state, batch)            # the first: builds, caches
    torch.cuda.synchronize()
    first = since(before).of(moe.grouped_swiglu)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, met = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps_w = since(before)
    ctx.count(steps_w, (moe.grouped_swiglu,))
    step_launches = (first, steps_w.of(moe.grouped_swiglu) - first)
    if step_launches != (per, per):
        fail(f"phase 16: {step_launches} grouped GEMM launches in two "
             f"train steps of {moonlight.moe_layers(m)} MoE layers, not "
             f"6 each")
    check_adamw("phase 16 train steps", steps_w, 2, 2, ctx)
    rec["sync_debug_step"] = {"loss": float(met["loss"]),
                              "launches": step_launches[1]}
    log(f"  moe train step under sync debug mode 'error': "
        f"{rec['sync_debug_step']}")
    del state, params, step
    torch.cuda.empty_cache()
    tok = VLT5Tokenizer()
    n_train, n_val, n_test = P16_ITEMS
    data = SyntheticDataModule(tok, tasks=["q_recognition", "q_location"],
                               n_train_per_task=n_train,
                               n_val_per_task=n_val, n_test_per_task=n_test,
                               feat_dim=m.feat_dim, n_boxes=36,
                               answer_vocab=8, seed=0)
    before = launches.read()
    tr = VQACLTrainer(cfg, data, tok, verbose=False, device="cuda")
    tr.train_task(0, first_trained=True)
    tr.train_task(1)
    cl_w = since(before)
    ctx.count(cl_w, (moe.grouped_swiglu,))
    n_k = cl_w.of(moe.grouped_swiglu)
    steps = tr.counts["train_steps"] + tr.counts["replay_steps"]
    if steps == 0 or tr.counts["replay_steps"] == 0 \
            or tr.counts["predict_batches"] == 0:
        fail(f"phase 16: the CL run's counts {dict(tr.counts)}")
    check_adamw("phase 16 CL run", cl_w, steps, 2, ctx)
    if n_k < per * steps or any(cl_w.k):
        fail(f"phase 16: {n_k} grouped GEMM launches over {steps} steps (at "
             f"least {per} each), attention {cl_w.k}")
    rec["cl"] = {"counts": dict(tr.counts), "launches": n_k,
                 "train_step_launches": per * steps,
                 "predict_launches": n_k - per * steps}
    log(f"  moe CL run {json.dumps(rec['cl'])}")
    shutil.rmtree(cfg.output, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    ctx.rows["moe_grouped_gemm"] = {
        "max_abs_err": max(rec["cell"]["rel_err"].values()),
        "ms": t_fwd, "plain_ms": t_plain, "bound_ms": bound_fwd,
        "bound_by": "operations" if fwd_f / 989e12 > fwd_b / 3.35e12
        else "bytes", "library_ms": lib}
    return {"grouped_experts": rec}
