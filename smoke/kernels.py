"""Phases 1, 2 and 6 of ``chip_smoke.py``: the kernels against their
plain versions, and the checks that phases 9 and 12 also run."""

import json
import os
import time

import numpy as np
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from smoke import harness as h
from smoke.harness import (DROPOUT, EVAL_BATCH, TRAIN_BATCH, _bound, fail, log,
                           put_ab, time_ab, time_ms)
from vqacl_tpu_torch import mm_bench
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.ops import (_build, dw, fused_attention as fa,
                                 head_loss as HL, launches, nms)
from vqacl_tpu_torch.utils.config import Config, tiny_model_config

# H100 SXM dense peaks (NVIDIA data sheet), FLOP/s by type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output
# rounding (2^-8 relative) and a p rounded to bf16 on either side of a
# tie give up to ~2 ulps; f32 differs only in summation order. K1′'s p
# and K2's dbias are f32 whatever the inputs' dtype.
TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}
# K5 (xᵀ·g) at the probe's shape (K = batch x sequence rows of the MLP
# input, D = d_model, F = d_ff), after a ladder from the smallest shape up
# (one k-step and one tile, one k-block, a K tail, F = D), and at odd
# shapes (the wgmma and the mma route); both sides sum in f32 in other
# orders: |kernel - plain| <= DW_RTOL * Σ_k|x_kd g_kf| + 1e-6
DW_LADDER = ((16, 64, 128), (64, 128, 256), (1000, 768, 3072),
             (4480, 768, 768))
DW_PROBE = (4480, 768, 3072)
DW_ODD = ((100, 40, 72), (97, 131, 257))
DW_RTOL = 1e-5
# the LM head's loss (H1, H2 and its two K5 products) at both cells'
# shapes, (name, B, T, D, V, tied): VL-T5's tied head (80 x 10 answer rows,
# d 768, 32,200 words, rescale d^-0.5) and VL-Moonlight's untied one (d
# 2048, 163,840 words). Kernel vs plain: both sum the same bf16 products in
# f32 in other orders, so the loss and the scores' cotangent differ in the
# last f32 bits (relative); d(logits) is rounded to bf16 on each side from
# f32 values that differ in those bits, so an element may land one bf16 ulp
# (2^-8 relative) apart, and dh is rounded to bf16 last: dh and dshared are
# held by the norm of the difference over the plain one's norm, the loss and
# dscores by the largest difference over the largest plain value. An H100
# read loss 1.7e-7, dscores 3.6e-7, dh 6.2e-4 (the bf16 roundings) and
# dshared 1.4e-6 at Moonlight's shape.
HEAD_SHAPES = (("head_vlt5", 80, 10, 768, 32200, True),
               ("head_moonlight", 80, 10, 2048, 163840, False))
HEAD_TOL = {"loss": 1e-5, "dscores": 1e-5, "dh": 5e-3, "dshared": 1e-4}
MM_BENCH_SHAPES = None       # None: the probe's own
MM_BENCH_REPS = 5
# (name, B, Tq, Sk, H, dk, L): the edges of the bf16 tensor-core routes
# of K1/K1′ and K2 -- Tq not a multiple of 16 with odd Sk, one full
# 128-key tile (two 64-key tiles in K2), 300 keys (the two-sweep softmax;
# five key tiles, two sweeps, in K2), the widest head they take.
BF16_EDGES = (("ragged_bf16", 16, 33, 29, 12, 64, 5),
              ("keys128_bf16", 8, 56, 128, 12, 64, 20),
              ("keys300_bf16", 4, 40, 300, 12, 64, 20),
              ("dk128_bf16", 16, 56, 56, 6, 128, 20))
# a bf16 shape K1′ takes and K2 does not: its bf16 block holds the panels
# and the whole [Tq, Sk] ds and pd tiles, which 512 keys exceed
K2_REFUSED = ("keys512_bf16", 4, 40, 512, 12, 64, 20)
# a misaligned row stride (not a multiple of 8 bf16 elements) that the
# bf16 kernels must refuse
BAD_STRIDE_PAD = 4
# N1 as (boxes, thresholds, invalid rows at the end): the RPN's shape,
# the pre-NMS top 6000 boxes of an 800 x 1344 image at IoU 0.7 with a
# tail of invalid rows (the -inf scores of the RPN's top-k); the 36-box
# sweep, 300 proposals x 5 thresholds
NMS_RPN = (6000, (0.7,), 600)
NMS_SWEEP = (300, (0.5, 0.6, 0.7, 0.8, 0.9), 0)
NMS_IMAGE = (1344.0, 800.0)
# N1's plain version is a host loop over the boxes: few timed calls
NMS_PLAIN_ITERS = 3


def build(ctx):
    """Build every CUDA kernel of the paths from ``vqacl_tpu_torch/csrc``,
    one nvcc per source, all started together.

    With ``--base`` also the base checkout's (the sources it has)."""
    t0 = time.time()
    libs = _build.build()
    if h.BASE_CSRC is not None:
        base_libs = _build.build(
            [n for n in _build.SIGNATURES
             if os.path.exists(os.path.join(h.BASE_CSRC, f"{n}.cu"))],
            csrc=h.BASE_CSRC)
        log(f"base: {h.BASE_CSRC}, {len(base_libs)} kernel libraries")
    log(f"build: {len(libs)} kernel libraries in {time.time() - t0:.1f} s")


def _pick(r):
    return {k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                              "library_ms", "bound_ms", "bound_by")
            if k in r}


def kernel_checks(ctx):
    """Kernel check: each kernel against its plain PyTorch version on the
    same inputs, with the tolerance printed beside the error, and a
    second launch on the same inputs equal bit for bit. K1 (the
    inference forward) at the eval shape and at rectangular and odd
    shapes; K1′ (training forward) and K2 (backward) at the train shape,
    rectangular and odd f32 shapes and the decoder shapes, at dropout 0
    and 0.1 (the plain version draws the kernels' own Philox mask, which
    is also compared bit for bit), timed also at the fused decoder's
    shapes; K1, K1′ and K2 at the edges of the bf16 tensor-core routes
    (Tq not a multiple of 16 with odd Sk, Sk = 128, Sk = 300, dk = 128),
    NExT-QA's encoder (23 text + 16 clip positions, a [12,23,23] bias: K1
    at the eval batch, timed; K1′ and K2 at the train batch, rates 0 and
    0.1, timed at 0.1; each also on merged q|k|v views, bit-equal to dense),
    and a bf16 call at dk = 8 refused with ValueError before any launch;
    each K1/K1′/K2 check names its route (``mma.sync bf16`` or ``scalar
    f32``); K5 (``dw_splitk``, xᵀ·g) on a ladder of shapes from the
    smallest up (``DW_LADDER``: one k-step and one tile, a K tail, D = F =
    768), the probe's shape (timed against the plain version and cuBLAS
    with f32 and with bf16 output), ``DW_ODD`` (one on the wgmma route,
    one on the mma route, each also in f32) and the f32 probe, each line
    naming its route (``wgmma``, ``mma``, ``f32``) and, on the wgmma
    route, its stream-K plan; N1 (``greedy_nms``, the greedy NMS of the
    RPN and the 36-box sweep) at the RPN's shape (6000 score-sorted boxes at IoU 0.7, a tail
    of invalid rows), the sweep's (300 boxes x 5 thresholds), all rows
    invalid and a scarce sweep, every keep mask bit-equal to its plain
    version and a second launch bit-equal; the head loss (H1, H2 and K5)
    at VL-T5's and VL-Moonlight's shapes (``HEAD_SHAPES``) against the
    plain version, timed (K5's row of the kernels line: its two products
    at VL-Moonlight's shape, as the train step runs them). CUDA-event times of each kernel, its plain
    version and one library call (a yardstick only), queued behind a spin
    kernel so that they time the card's work and not the host's launch
    rate; K1 and K1′ also with the host's enqueue included (``call_ms``).
    A bf16 training call that K2 cannot take (Sk = 512) is refused before
    K1′ launches.

    With ``--base`` the ``ab`` line. Keeps the timed rows of the kernels
    line, the decoder shapes' times (phase 4's summary) and the
    head-offset check (phase 13's)."""
    m = Config().model
    H, dk, L = m.num_heads, m.d_kv, m.max_text_length
    S = m.encoder_len
    k1 = check_attention(fa, "eval_shape", EVAL_BATCH, S, S, H, dk, L,
                         "bfloat16", text_len=L, timed=True)
    # the CL loop's DER capture runs K1 at the train batch
    check_attention(fa, "capture_shape", TRAIN_BATCH, S, S, H, dk, L,
                    "bfloat16", text_len=L)
    check_attention(fa, "rect_f32", 8, 10, 58, H, dk, 0, "float32")
    check_attention(fa, "rect_bf16_bias", 16, 19, 37, H, dk, 7,
                    "bfloat16")
    check_attention(fa, "decoder_self_f32", 8, 10, 10, H, dk, 10,
                    "float32")
    check_attention(fa, "odd_width_f32", 3, 13, 29, 4, 8, 5,
                    "float32")
    k1p = k2 = None
    for rate in (0.0, DROPOUT):
        rows = check_train_attention(fa, "train_shape", TRAIN_BATCH, S, S, H,
                                     dk, L, "bfloat16", rate, text_len=L,
                                     timed=rate == DROPOUT)
        if rate == DROPOUT:
            k1p, k2 = rows
        check_train_attention(fa, "rect_f32_L0", 8, 10, 58, H, dk, 0,
                              "float32", rate)
        check_train_attention(fa, "rect_bf16_bias", 16, 19, 37, H, dk, 7,
                              "bfloat16", rate)
        check_train_attention(fa, "odd_width_f32", 3, 13, 29, 4, 8, 5,
                              "float32", rate)
        check_train_attention(fa, "decoder_self_causal_f32", 8, 10, 10, H,
                              dk, 10, "float32", rate, causal=True)
        check_train_attention(fa, "decoder_self_causal_bf16", 16, 10, 10,
                              H, dk, 10, "bfloat16", rate, causal=True)
        check_train_attention(fa, "decoder_cross_bf16_L0", 16, 10, S + 2, H,
                              dk, 0, "bfloat16", rate, text_len=L)
        for (name, *shape, L_) in BF16_EDGES:
            check_train_attention(fa, name, *shape, L_, "bfloat16", rate,
                                  text_len=L_)
    for (name, *shape, L_) in BF16_EDGES:
        check_attention(fa, name, *shape, L_, "bfloat16", text_len=L_)
    check_refused(fa)
    # a second tensor-parallel rank's heads at the train shape (phase 13)
    ctx.head_off = check_head_offset_attention(
        fa, TRAIN_BATCH, S, S, H, dk, L, "bfloat16", DROPOUT, text_len=L)
    # NExT-QA's encoder (phase 10): 23 text + 16 clip positions, a
    # [H,23,23] bias; K1 at the eval batch, K1′ and K2 at the train batch,
    # dense and on merged q|k|v views (the trainer runs merged)
    NQ_L, NQ_S = 23, 23 + 16
    nq_k1 = check_attention(fa, "nextqa_eval_shape", EVAL_BATCH, NQ_S, NQ_S,
                            H, dk, NQ_L, "bfloat16", text_len=NQ_L,
                            timed=True)
    check_strided(fa, "nextqa_eval_shape", EVAL_BATCH, NQ_S, NQ_S, H, dk,
                  NQ_L, "bfloat16", 0.0, "self")
    nq_k1p = nq_k2 = None
    for rate in (0.0, DROPOUT):
        rows = check_train_attention(fa, "nextqa_train_shape", TRAIN_BATCH,
                                     NQ_S, NQ_S, H, dk, NQ_L, "bfloat16",
                                     rate, text_len=NQ_L,
                                     timed=rate == DROPOUT)
        if rate == DROPOUT:
            nq_k1p, nq_k2 = rows
        check_strided(fa, "nextqa_train_shape", TRAIN_BATCH, NQ_S, NQ_S, H,
                      dk, NQ_L, "bfloat16", rate, "self")
    # the Table-1 surrogate's encoder (phase 14): tiny widths in f32, 4
    # heads of 8, 6 text + 4 box positions, a [4,6,6] bias, batch 16
    tm = tiny_model_config()
    sur = (16, tm.encoder_len, tm.encoder_len, tm.num_heads, tm.d_kv,
           tm.max_text_length)
    check_attention(fa, "surrogate_f32", *sur, "float32",
                    text_len=tm.max_text_length)
    for rate in (0.0, DROPOUT):
        check_train_attention(fa, "surrogate_f32", *sur, "float32", rate,
                              text_len=tm.max_text_length)
    # the fused decoder's shapes at the train batch (K4): K1′/K2 with
    # dropout in training, K1 in the loss-eval step
    T = m.target_max_length
    dec_rows = {
        "self": check_train_attention(
            fa, "decoder_self_train", TRAIN_BATCH, T, T, H, dk, T,
            "bfloat16", DROPOUT, causal=True, timed=True),
        "cross": check_train_attention(
            fa, "decoder_cross_train", TRAIN_BATCH, T, S + 2, H, dk, 0,
            "bfloat16", DROPOUT, text_len=L, timed=True),
        "self_eval": check_attention(
            fa, "decoder_self_eval", TRAIN_BATCH, T, T, H, dk, T,
            "bfloat16", timed=True),
        "cross_eval": check_attention(
            fa, "decoder_cross_eval", TRAIN_BATCH, T, S + 2, H, dk, 0,
            "bfloat16", text_len=L, timed=True)}
    # K5: the ladder from the smallest shape up, the probe's shape (timed),
    # the odd shapes (wgmma and mma routes, and f32), the f32 probe
    for shape in DW_LADDER:
        check_dw(dw, "dw_ladder", *shape, "bfloat16")
    k5 = check_dw(dw, "dw_probe", *DW_PROBE, "bfloat16", timed=True)
    if k5["route"] != "wgmma":
        fail(f"dw_probe took the {k5['route']} route, not wgmma")
    for shape in DW_ODD:
        for dname in ("bfloat16", "float32"):
            check_dw(dw, "dw_odd", *shape, dname)
    check_dw(dw, "dw_probe_f32", *DW_PROBE, "float32")
    # the head loss at both cells' shapes (H1, H2, K5), timed
    head = {name: check_head_loss(name, *shape, timed=True)
            for name, *shape in HEAD_SHAPES}
    main = head[HEAD_SHAPES[-1][0]]
    # N1 at the RPN's and the sweep's shapes, with nothing valid, and a
    # sweep that even IoU 0.9 leaves short of 36 boxes
    n1 = check_nms(nms, "nms_rpn", *NMS_RPN, timed=True)
    n1_sweep = check_nms(nms, "nms_sweep", *NMS_SWEEP, timed=True, seed=1)
    check_nms(nms, "nms_all_invalid", NMS_SWEEP[0], NMS_RPN[1],
              NMS_SWEEP[0], seed=2)
    scarce = check_nms(nms, "nms_sweep_scarce", *NMS_SWEEP, clusters=12,
                       seed=3)
    if not scarce["kept"][-1] < 36:
        fail(f"nms_sweep_scarce keeps {scarce['kept']}: not scarce")
    if h.BASE_CSRC is not None:
        keys = ("ms", "base_ms", "call_ms", "base_call_ms", "bound_ms")
        pick_ab = lambda r: {k: r[k] for k in keys if k in r}  # noqa: E731
        log("ab " + json.dumps({
            "base": h.BASE_CSRC, "card": ctx.card,
            "K1 eval": pick_ab(k1), "K1' train": pick_ab(k1p),
            "K2 train": pick_ab(k2),
            "K1' decoder self": pick_ab(dec_rows["self"][0]),
            "K1' decoder cross": pick_ab(dec_rows["cross"][0]),
            "K2 decoder self": pick_ab(dec_rows["self"][1]),
            "K2 decoder cross": pick_ab(dec_rows["cross"][1]),
            "K1 decoder self": pick_ab(dec_rows["self_eval"]),
            "K1 decoder cross": pick_ab(dec_rows["cross_eval"]),
            "K1 nextqa eval": pick_ab(nq_k1),
            "K1' nextqa train": pick_ab(nq_k1p),
            "K2 nextqa train": pick_ab(nq_k2),
            "N1 rpn": pick_ab(n1), "N1 sweep": pick_ab(n1_sweep),
            "K5 probe": pick_ab(k5)}))
    ctx.rows.update({"fused_attention_fwd": k1,
                     "fused_attention_fwd_train": k1p,
                     "fused_attention_bwd": k2, "dw_splitk": main["k5"],
                     "greedy_nms": n1, "head_lse": main["h1"],
                     "head_dlogits": main["h2"]})
    ctx.dec_times = {
        "self": {"K1p": _pick(dec_rows["self"][0]),
                 "K2": _pick(dec_rows["self"][1])},
        "cross": {"K1p": _pick(dec_rows["cross"][0]),
                  "K2": _pick(dec_rows["cross"][1])},
        "self_eval": {"K1": _pick(dec_rows["self_eval"])},
        "cross_eval": {"K1": _pick(dec_rows["cross_eval"])}}
    return {
        "kernel_call_ms": {"K1": k1["call_ms"], "K1p": k1p["call_ms"]},
        "kernel_bytes_flops": {"K1p": [k1p["bytes"], k1p["flops"]],
                               "K2": [k2["bytes"], k2["flops"]],
                               "K5": [k5["bytes"], k5["flops"]]},
        "k5_probe": {k: k5[k] for k in (
            "route", "ms", "base_ms", "plain_ms", "library_ms",
            "library_bf16_ms", "bound_ms", "bound_by") if k in k5},
        "nms_kernel_times": {"rpn": _pick(n1), "sweep": _pick(n1_sweep)},
        "head_loss": head,
        "nextqa_kernel_times": {"K1": _pick(nq_k1), "K1p": _pick(nq_k1p),
                                "K2": _pick(nq_k2)}}


def mm_probe(ctx):
    """``vqacl_tpu_torch.mm_bench``: the probe's matrix products and the K5
    weight-gradient kernel ``dw_splitk`` at the probe's shapes, which must
    launch K5's wgmma route (the wrapper counts launches per route).

    Its K5 launches are counted."""
    torch.cuda.synchronize()
    before = launches.read()
    mm_rows = mm_bench.run("cuda", MM_BENCH_SHAPES, reps=MM_BENCH_REPS)
    w = h.since(before)
    ctx.count(w, (dw.dw_splitk,))
    dw_routes = w.routes(dw.dw_splitk)
    log(f"mm_bench ({MM_BENCH_REPS} timed calls per case, CUDA events; peak "
        f"{mm_bench.PEAK_FLOPS / 1e12:g} TFLOP/s bf16; {ctx.card}):")
    log(mm_bench.table(mm_rows))
    log(f"mm_bench: dw_splitk launches={w.of(dw.dw_splitk)} by route "
        f"{json.dumps(dw_routes)}")
    if dw_routes["wgmma"] == 0:
        fail("mm_bench did not launch dw_splitk's wgmma route")
    if not all(np.isfinite(r["us"]) and r["us"] > 0 for r in mm_rows):
        fail("mm_bench gave a time that is not a positive number")
    return {"mm_bench": mm_rows, "mm_bench_dw_route_launches": dw_routes}


def attention_inputs(B, Tq, Sk, H, dk, L, dtype, text_len, seed):
    """q/k/v [B,S,H·dk], bias [H,L,L] f32 or None, mask [B,Sk] f32 with a
    ragged text part (the first ``text_len`` keys) and visual keys on."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = (0.25 * torch.randn(B, Tq, H * dk, generator=g, device=dev)).to(dtype)
    k = (0.25 * torch.randn(B, Sk, H * dk, generator=g, device=dev)).to(dtype)
    v = torch.randn(B, Sk, H * dk, generator=g, device=dev).to(dtype)
    bias = torch.randn(H, L, L, generator=g, device=dev) if L else None
    mask = torch.ones(B, Sk, device=dev)
    n_text = torch.randint(1, text_len + 1, (B,), generator=g, device=dev)
    pos = torch.arange(Sk, device=dev)[None, :]
    mask[(pos < text_len) & (pos >= n_text[:, None])] = 0.0
    return q, k, v, bias, mask


def check_attention(fa, name, B, Tq, Sk, H, dk, L, dtype,
                    text_len=None, timed=False):
    """Kernel vs plain version; with ``timed`` also the times and bound."""
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len or Sk, seed=B + Tq + Sk)
    route = fa.ROUTE_NAMES[fa.fwd_route(dt, dk, Tq, Sk)]
    out = fa.fused_attention(q, k, v, bias, mask, H)
    again = fa.fused_attention(q, k, v, bias, mask, H)
    ref = fa.fused_attention_reference(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    if out.dtype != dt or out.shape != (B, Tq, H * dk):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    same = torch.equal(out, again)
    log(f"kernel_check {name}: route={route} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} max_abs_err={err:.3e} tol=atol {atol:g} + "
        f"rtol {rtol:g}; second launch equal: {same} -> "
        f"{'ok' if ok and same else 'MISMATCH'}")
    if not (ok and same):
        fail(f"{name}: kernel disagrees with its plain version or itself")
    row = {"max_abs_err": err}
    if not timed:
        return row
    sets = [(q, k, v, bias, mask)] + [
        attention_inputs(B, Tq, Sk, H, dk, L, dt, text_len or Sk,
                         seed=100 + i) for i in range(3)]
    F = torch.nn.functional

    def sdpa_args(q, k, v, bias, mask):
        heads = lambda x: x.view(B, -1, H, dk).transpose(1, 2)
        add = torch.zeros(B, H, Tq, Sk, device="cuda")
        if bias is not None:
            add[:, :, :L, :L] = bias
        add = add + ((1.0 - mask) * -1e9)[:, None, None, :]
        return heads(q), heads(k), heads(v), add.to(dt)

    lib_sets = [sdpa_args(*s) for s in sets]
    k1_calls = [lambda s=s: fa.fused_attention(*s, H) for s in sets]
    put_ab(row, "ms", time_ab(k1_calls))
    put_ab(row, "call_ms", time_ab(k1_calls, spin=False))
    row["plain_ms"] = time_ms([
        lambda s=s: fa.fused_attention_reference(*s, H) for s in sets])
    row["library_ms"] = time_ms([
        lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                   attn_mask=a[3], scale=1.0)
        for a in lib_sets])
    elem = q.element_size()
    nbytes = (2 * B * Tq + 2 * B * Sk) * H * dk * elem + B * Sk * 4 \
        + H * L * L * 4
    flops = 4 * B * H * Tq * Sk * dk
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS[dtype])
    log(f"kernel_time {name}: kernel_ms={row['ms']:.5f} "
        f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
        f"{flops} FLOP); call_ms={row['call_ms']:.5f} (host enqueue "
        f"included)")
    return row


def train_attention_inputs(B, Tq, Sk, H, dk, L, dtype, text_len, seed,
                           causal=False):
    """attention_inputs plus do [B,Tq,H·dk]; with ``causal`` the bias is
    the decoder's full [H,T,T] bias (−1e9 above the diagonal) and every
    key is on, as the decoder's self-attention has it."""
    q, k, v, bias, mask = attention_inputs(B, Tq, Sk, H, dk, L, dtype,
                                           text_len, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(B, Tq, H * dk, generator=g, device="cuda").to(dtype)
    if causal:
        up = torch.triu(torch.ones(L, L, device="cuda"), diagonal=1)
        bias = bias + up * -1e9
        mask = torch.ones_like(mask)
    return q, k, v, do, bias, mask


def _close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    return float(diff.max()), ok


def check_train_attention(fa, name, B, Tq, Sk, H, dk, L, dtype, rate,
                          text_len=None, causal=False, timed=False):
    """K1′ and K2 vs their plain versions (the plain version draws the
    kernels' Philox mask; that mask is checked against the kernels' own
    bit for bit), and each kernel's second launch against its first. With
    ``timed``: times, bounds and library yardsticks. → (K1′ row, K2
    row)."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len or Sk, seed=B + Tq + Sk,
        causal=causal)
    seed = torch.tensor([20260 + Tq], dtype=torch.int32, device="cuda")
    route = fa.ROUTE_NAMES[fa.fwd_route(dt, dk, Tq, Sk)]
    bwd_route = fa.bwd_route(dt, dk, Tq, Sk, rate)
    o, p = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H, rate)
    o2, p2 = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H,
                                          rate)
    ro, rp = fa.fused_attention_fwd_train_reference(q, k, v, bias, mask,
                                                    seed, H, rate)
    grads = fa.fused_attention_bwd(q, k, v, p, seed, do, H, L, rate)
    grads2 = fa.fused_attention_bwd(q, k, v, p, seed, do, H, L, rate)
    rgrads = fa.fused_attention_bwd_reference(q, k, v, rp, seed, do, H, L,
                                              rate)
    torch.cuda.synchronize()
    if o.dtype != dt or o.shape != (B, Tq, H * dk) \
            or p.shape != (B, H * Tq, Sk):
        fail(f"{name}: K1' output {o.dtype} {tuple(o.shape)} p "
             f"{tuple(p.shape)}")
    errs, oks = {}, []
    pairs = [("o", o, ro, dtype), ("p", p, rp, "float32"),
             ("dq", grads[0], rgrads[0], dtype),
             ("dk", grads[1], rgrads[1], dtype),
             ("dv", grads[2], rgrads[2], dtype)]
    if L:
        pairs.append(("dbias", grads[3], rgrads[3], "float32"))
    elif grads[3] is not None:
        fail(f"{name}: K2 wrote dbias with L = 0")
    for key, a, b, tol_dt in pairs:
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    kept = 1.0
    if rate:
        mine = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate)
        plain = fa.philox_keep_mask(seed, B, H, Tq, Sk, rate)
        kept = float(mine.float().mean())
        if not torch.equal(mine, plain):
            fail(f"{name}: the PyTorch Philox mask differs from the "
                 f"kernels'")
        if abs(kept - (1 - rate)) > 0.02:
            fail(f"{name}: kept share {kept:.4f} for rate {rate}")
    same = torch.equal(o, o2) and torch.equal(p, p2)
    same_bwd = all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(grads, grads2))
    oks += [same, same_bwd]
    atol, rtol = TOL[dtype]
    log(f"kernel_check {name}: route={route} K2 route="
        f"{fa.ROUTE_NAMES[bwd_route]} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} rate={rate} kept={kept:.4f} max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
        + f" tol=atol {atol:g} + rtol {rtol:g} (p, dbias: f32 tol); second "
        f"launch equal: K1' {same}, K2 {same_bwd} -> "
        f"{'ok' if all(oks) else 'MISMATCH'}")
    if not all(oks):
        fail(f"{name}: K1'/K2 disagree with their plain versions or with "
             f"themselves")
    fwd_row = {"max_abs_err": max(errs["o"], errs["p"])}
    bwd_row = {"max_abs_err": max(v for k, v in errs.items()
                                  if k not in ("o", "p"))}
    if not timed:
        return fwd_row, bwd_row

    sets = [(q, k, v, do, bias, mask)] + [
        train_attention_inputs(B, Tq, Sk, H, dk, L, dt, text_len or Sk,
                               seed=200 + i) for i in range(3)]
    ps = [fa.fused_attention_fwd_train(s[0], s[1], s[2], s[4], s[5], seed,
                                       H, rate)[1] for s in sets]
    k1p_calls = [lambda s=s: fa.fused_attention_fwd_train(
        s[0], s[1], s[2], s[4], s[5], seed, H, rate) for s in sets]
    put_ab(fwd_row, "ms", time_ab(k1p_calls))
    put_ab(fwd_row, "call_ms", time_ab(k1p_calls, spin=False))
    fwd_row["plain_ms"] = time_ms([
        lambda s=s: fa.fused_attention_fwd_train_reference(
            s[0], s[1], s[2], s[4], s[5], seed, H, rate) for s in sets])
    put_ab(bwd_row, "ms", time_ab([
        lambda s=s, p=p: fa.fused_attention_bwd(s[0], s[1], s[2], p, seed,
                                                s[3], H, L, rate)
        for s, p in zip(sets, ps)]))
    bwd_row["plain_ms"] = time_ms([
        lambda s=s, p=p: fa.fused_attention_bwd_reference(
            s[0], s[1], s[2], p, seed, s[3], H, L, rate)
        for s, p in zip(sets, ps)])
    lib = sdpa_times(sets, B, Tq, Sk, H, dk, L, dt, rate)
    fwd_row["library_ms"], bwd_row["library_ms"] = lib["fwd"], lib["bwd"]

    elem = q.element_size()
    panel = H * dk * elem
    p_bytes = B * H * Tq * Sk * 4
    small = B * Sk * 4 + H * L * L * 4 + 4
    prod = 2 * B * H * Tq * Sk * dk          # one [Tq,Sk]x[·,dk] product
    peak = PEAK_FLOPS[dtype]
    f32 = PEAK_FLOPS["float32"]
    # K1': q,k,v in, o and p out; q·k and p·v on the inputs' type
    fwd_bytes = (2 * B * Tq + 2 * B * Sk) * panel + p_bytes + small
    fwd_ops_s = 2 * prod / peak
    # K2: q,k,v,do,p in, dq,dk,dv out; on the tensor-core route all four
    # products on the bf16 tensor cores, on the scalar route do·vᵀ on the
    # inputs' type and the three with the f32 p or ds on f32
    bwd_bytes = ((2 * B * Tq + 2 * B * Sk) * panel + p_bytes
                 + (B * Tq + 2 * B * Sk) * panel + H * L * L * 4 + 4)
    bwd_ops_s = (4 * prod / peak if bwd_route == "mma"
                 else prod / peak + 3 * prod / f32)
    for row, nbytes, ops_s, flops in ((fwd_row, fwd_bytes, fwd_ops_s,
                                       2 * prod),
                                      (bwd_row, bwd_bytes, bwd_ops_s,
                                       4 * prod)):
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops_s)
        row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name} K1': kernel_ms={fwd_row['ms']:.5f} "
        f"plain_ms={fwd_row['plain_ms']:.5f} "
        f"library_ms={fwd_row['library_ms']:.5f} ({lib['backend']} fwd) "
        f"bound_ms={fwd_row['bound_ms']:.5f} ({fwd_row['bound_by']}: "
        f"{fwd_bytes} B, {2 * prod} FLOP); call_ms={fwd_row['call_ms']:.5f} "
        f"(host enqueue included)")
    log(f"kernel_time {name} K2 ({fa.ROUTE_NAMES[bwd_route]}): "
        f"kernel_ms={bwd_row['ms']:.5f} "
        f"plain_ms={bwd_row['plain_ms']:.5f} "
        f"library_ms={bwd_row['library_ms']:.5f} ({lib['backend']} "
        f"fwd+bwd {lib['fwd_bwd']:.5f} - fwd) "
        f"bound_ms={bwd_row['bound_ms']:.5f} ({bwd_row['bound_by']}: "
        f"{bwd_bytes} B, {4 * prod} FLOP)")
    return fwd_row, bwd_row


def sdpa_times(sets, B, Tq, Sk, H, dk, L, dt, rate):
    """PyTorch SDPA with the same additive bias and dropout: forward
    time, and its backward as forward+backward minus forward, on the
    first backend that takes the inputs. Yardsticks only."""
    F = torch.nn.functional
    heads = lambda x: x.view(B, -1, H, dk).transpose(1, 2)

    def args(q, k, v, do, bias, mask):
        add = torch.zeros(B, H, Tq, Sk, device="cuda")
        if bias is not None:
            add[:, :, :L, :L] = bias
        add = add + ((1.0 - mask) * -1e9)[:, None, None, :]
        return ([heads(x).detach().requires_grad_() for x in (q, k, v)],
                heads(do), add.to(dt))

    lib_sets = [args(*s) for s in sets]
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                def fwd(a):
                    with torch.no_grad():
                        F.scaled_dot_product_attention(
                            *a[0], attn_mask=a[2], dropout_p=rate, scale=1.0)

                def fwd_bwd(a):
                    out = F.scaled_dot_product_attention(
                        *a[0], attn_mask=a[2], dropout_p=rate, scale=1.0)
                    out.backward(a[1])

                fwd_bwd(lib_sets[0])
                t_fwd = time_ms([lambda a=a: fwd(a) for a in lib_sets])
                t_all = time_ms([lambda a=a: fwd_bwd(a) for a in lib_sets])
        except RuntimeError as e:
            log(f"sdpa {backend.name}: not usable here ({e})")
            continue
        return {"backend": backend.name, "fwd": t_fwd, "fwd_bwd": t_all,
                "bwd": t_all - t_fwd}
    fail("no SDPA backend takes the attention inputs")


def check_refused(fa):
    """A bf16 call at dk = 8 (the tiny config's head width) is refused by
    K1's and K1′'s wrappers with ValueError, before any launch; so is a
    differentiable call at 512 keys, which K1′ takes and K2 does not."""
    q, k, v, bias, mask = attention_inputs(2, 8, 8, 4, 8, 0, torch.bfloat16,
                                           8, seed=1)
    seed = torch.zeros((1,), dtype=torch.int32, device="cuda")
    before = launches.read()
    msgs = []
    for call in (lambda: fa.fused_attention(q, k, v, bias, mask, 4),
                 lambda: fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                      seed, 4, DROPOUT)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
            continue
        fail("a bf16 call at dk = 8 was not refused")
    if h.since(before).k != (0, 0, 0):
        fail(f"a refused bf16 call launched a kernel: {h.since(before).k}")
    log(f"kernel_check refused_bf16_dk8: K1 and K1' raise ValueError before "
        f"any launch ({msgs[0]})")
    name, B, Tq, Sk, H, dk, L = K2_REFUSED
    q, k, v, bias, mask = attention_inputs(B, Tq, Sk, H, dk, L,
                                           torch.bfloat16, L, seed=2)
    before = launches.read()
    try:
        fa.fused_attention(q.requires_grad_(), k, v, bias, mask, H, DROPOUT,
                           seed)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"a differentiable call at {name}'s shape was not refused")
    if h.since(before).k != (0, 0, 0):
        fail(f"a refused training call launched K1'/K2: "
             f"{h.since(before).k}")
    log(f"kernel_check refused_bwd_{name}: a training call raises "
        f"ValueError before K1' launches ({msg})")


def dw_inputs(K, D, F, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(K, D, generator=g, device="cuda").to(dtype)
    dy = torch.randn(K, F, generator=g, device="cuda").to(dtype)
    return x, dy


def dw_sms():
    """The card's SM count (the plan the wgmma route runs is printed for
    it)."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def mm_f32_out(a, b):
    """One cuBLAS product of bf16 operands with f32 output, as K5 writes:
    K5's library yardstick."""
    return torch.mm(a, b, out_dtype=torch.float32)


def check_dw(dw, name, K, D, F, dtype, timed=False):
    """K5 vs its plain version (and a second launch bit for bit) on the
    route ``dw.dw_route`` picks; with ``timed`` also the times, bound and
    library yardsticks."""
    dt = getattr(torch, dtype)
    x, dy = dw_inputs(K, D, F, dt, seed=K + D + F)
    route = dw.dw_route(K, D, F, dt, x, dy)
    ref = dw.dw_splitk_reference(x, dy)
    scale = x.float().abs().t() @ dy.float().abs()
    tol = DW_RTOL * scale + 1e-6
    out = dw.dw_splitk(x, dy)
    again = dw.dw_splitk(x, dy)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (D, F):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out - ref).abs()
    err = float(diff.max())
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(out).all())
    same = torch.equal(out, again)
    plan = ""
    if route == "wgmma":
        p = dw.dw_plan(K, D, F, dw_sms())
        plan = (f" N={dw.TILE_N} (plan: {p.tiles} tiles x {p.k_blocks} "
                f"k-blocks on {p.units} clusters of {dw.CLUSTER}, "
                f"{len(p.splits())} split)")
    log(f"kernel_check {name}: route={route}{plan} K={K} D={D} F={F} "
        f"{dtype} max_abs_err={err:.3e} max err/tol="
        f"{float((diff / tol).max()):.3e} tol={DW_RTOL:g}*sum|x*g| + "
        f"1e-6; second launch equal: {same} -> "
        f"{'ok' if ok and same else 'MISMATCH'}")
    if not (ok and same):
        fail(f"{name}: dw_splitk disagrees with its plain version or "
             f"with itself")
    row = {"route": route, "max_abs_err": err}
    if not timed:
        return row
    sets = [(x, dy)] + [dw_inputs(K, D, F, dt, seed=300 + i)
                        for i in range(3)]
    put_ab(row, "ms", time_ab([lambda s=s: dw.dw_splitk(*s) for s in sets]))
    row["plain_ms"] = time_ms([lambda s=s: dw.dw_splitk_reference(*s)
                               for s in sets])
    # cuBLAS with bf16 out (it sums in f32 and rounds the result) and with
    # f32 out as K5 writes: the yardstick
    row["library_bf16_ms"] = time_ms([lambda s=s: torch.matmul(s[0].t(), s[1])
                                      for s in sets])
    row["library_ms"] = time_ms([lambda s=s: mm_f32_out(s[0].t(), s[1])
                                 for s in sets])
    elem = x.element_size()
    nbytes = (K * D + K * F) * elem + D * F * 4
    flops = 2 * K * D * F
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS[dtype])
    row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name} ({route}): kernel_ms={row['ms']:.5f} "
        f"plain_ms={row['plain_ms']:.5f} library_ms: cuBLAS f32 out "
        f"{row['library_ms']:.5f}, bf16 out {row['library_bf16_ms']:.5f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
        f"{flops} FLOP)")
    return row


def head_inputs(B, T, D, V, tied, seed):
    """bf16 hidden [B, T, D], an f32 head [V, D] (T5's embedding N(0, 1),
    Moonlight's head N(0, 0.02): logits of O(1) either way), labels with
    padding, a row of all -100 and a label in the ragged last chunk, and
    scores."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hidden = torch.randn(B, T, D, generator=g, device="cuda").to(
        torch.bfloat16)
    shared = torch.randn(V, D, generator=g, device="cuda") * (
        1.0 if tied else 0.02)
    labels = torch.randint(0, V, (B, T), generator=g, device="cuda")
    labels[::2, T - 3:] = -100
    labels[1] = -100
    labels[2, 0] = V - 1
    scores = torch.rand(B, generator=g, device="cuda")
    return hidden, shared, labels, scores


def head_grads(hidden, shared, labels, scores, rescale, route=None):
    """(loss, dh, dshared, dscores) through ``fused_head_loss``'s op on
    ``route`` (None: the route it picks)."""
    h, s, sc = (t.detach().requires_grad_() for t in (hidden, shared,
                                                       scores))
    loss = vlt5._FusedHeadLoss.apply(h, s, labels, sc, rescale, route)
    return (loss.detach(),) + torch.autograd.grad(loss, (h, s, sc))


def head_plain(hidden, shared, labels, scores, rescale):
    """The same through the plain version."""
    return head_grads(hidden, shared, labels, scores, rescale, "plain")


def check_head_loss(name, B, T, D, V, tied, timed=False):
    """The head loss on its kernels (H1, H2, two K5 products) vs the plain
    version: the loss, dh, dshared and dscores within ``HEAD_TOL``, a
    second run equal bit for bit, H1's lse and label logit and H2's
    d(logits) against their plain versions, K5's two products against
    theirs within K5's tolerance, the launches counted; with ``timed`` the
    times of H1, H2, the two products and the whole forward + backward
    beside the plain version, the library yardstick (cuBLAS's bf16
    products with f32 out, ``torch.logsumexp``) and the bounds: the four
    products this design runs, and three (no recomputed logits) with the
    f32 logits written and read once."""
    rows = B * T
    rescale = D ** -0.5 if tied else 1.0
    route = HL.head_loss_route("cuda", torch.bfloat16, rows, D, V)
    if route != "wgmma":
        fail(f"{name}: the head loss took the {route} route")
    inputs = head_inputs(B, T, D, V, tied, seed=D + V)
    before = launches.read()
    out = head_grads(*inputs, rescale)
    torch.cuda.synchronize()
    w = h.since(before)
    again = head_grads(*inputs, rescale)
    ref = head_plain(*inputs, rescale)
    torch.cuda.synchronize()
    err = {}
    for k, a, b in zip(("loss", "dh", "dshared", "dscores"), out, ref):
        a, b = a.float(), b.float()
        if k in ("dh", "dshared"):
            err[k] = float((a - b).norm() / b.norm())
        else:
            err[k] = float((a - b).abs().max() / b.abs().max())
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    n = {"head_lse": w.of(HL.head_lse), "head_dlogits": w.of(HL.head_dlogits),
         "dw_splitk wgmma": w.of(dw.dw_splitk, "route_launches", "wgmma")}
    # H1 and H2 alone against the module's plain versions
    hs = (inputs[0] * vlt5.rounded(rescale, torch.bfloat16)
          if tied else inputs[0]).reshape(rows, D).contiguous()
    wb = inputs[1].to(torch.bfloat16)
    safe = vlt5._safe_labels(inputs[2], V).to(torch.int32).reshape(-1)
    wts = vlt5._token_weights(inputs[2], inputs[3]).reshape(-1)
    lse, ll = HL.head_lse(hs, wb, safe)
    lse_p, ll_p = HL.lse_reference(hs, wb, safe)
    dl, dl_t = HL.dlogits_reference(hs, wb, safe, lse_p, wts)
    dk, dk_t = HL.head_dlogits(hs, wb, safe, lse_p, wts)
    # K5's two products (dh from the transpose, dshared) vs their plain
    # versions, within K5's tolerance
    k5_pairs = {"dh": (dk_t, wb), "dshared": (dk, hs)}
    k5_err = {}
    for k, (x, g) in k5_pairs.items():
        diff = (dw.dw_splitk(x, g) - dw.dw_splitk_reference(x, g)).abs()
        tol = DW_RTOL * (x.float().abs().t() @ g.float().abs()) + 1e-6
        k5_err[k] = (float(diff.max()), bool((diff <= tol).all()))
        del diff, tol
    torch.cuda.synchronize()
    lse_err = float(torch.maximum((lse - lse_p).abs().max(),
                                  (ll - ll_p).abs().max()))
    dl_err = float((dk.float() - dl.float()).abs().max())
    dl_ulps = float(((dk.float() - dl.float()).abs()
                     / dl.float().abs().clamp_min(1e-30)).max())
    t_ok = torch.equal(dk.t(), dk_t[:, :rows]) and not bool(
        dk_t[:, rows:].any())
    k5_ok = all(v[1] for v in k5_err.values())
    ok = (finite and same and t_ok and k5_ok
          and all(err[k] <= HEAD_TOL[k] for k in err)
          and n == {"head_lse": 2, "head_dlogits": 1, "dw_splitk wgmma": 2})
    plan = HL.head_plan(rows, D, V)
    log(f"kernel_check {name}: route={route} rows={rows} D={D} V={V} "
        f"rescale={rescale:.6g} ({plan.m_tiles} x {plan.chunks} tiles, last "
        f"chunk {plan.ragged} columns) errors {json.dumps(err)} tol "
        f"{json.dumps(HEAD_TOL)}; H1 lse/label logit max_abs_err "
        f"{lse_err:.3e}; H2 d(logits) max_abs_err {dl_err:.3e} (relative "
        f"{dl_ulps:.3e}), transpose equal: {t_ok}; K5 dh/dshared "
        f"max_abs_err {k5_err['dh'][0]:.3e}/{k5_err['dshared'][0]:.3e} "
        f"within tol={DW_RTOL:g}*sum|x*g| + 1e-6: {k5_ok}; launches "
        f"{json.dumps(n)}; "
        f"second launch equal: {same} -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: the head loss's kernels disagree with the plain "
             f"version or with themselves")
    rec = {"route": route, "errors": err, "lse_max_abs_err": lse_err,
           "dlogits_max_abs_err": dl_err, "launches": n,
           "k5_max_abs_err": {k: v[0] for k, v in k5_err.items()}}
    if not timed:
        return rec
    sets = [inputs, head_inputs(B, T, D, V, tied, seed=D + V + 1)]
    def library():
        lg = mm_f32_out(hs, wb.t())
        lse_l = torch.logsumexp(lg, dim=-1)
        p = torch.exp(lg - lse_l[:, None])
        p.scatter_add_(1, safe.long()[:, None],
                       -torch.ones((rows, 1), device="cuda"))
        d = (p * wts[:, None]).to(torch.bfloat16)
        return mm_f32_out(d, wb), mm_f32_out(d.t(), hs)

    rs = vlt5.rounded(rescale, torch.bfloat16)
    one = torch.ones((), device="cuda")

    def op(s, fwd, bwd):
        """The op's forward and backward as ``_FusedHeadLoss`` runs them on
        a route, without autograd's host work (the card's time)."""
        hidden, shared, labels, scores = s
        lse, ll, res = fwd(hidden, shared, vlt5._safe_labels(labels, V), rs)
        w = vlt5._token_weights(labels, scores)
        return (((lse - ll) * w).sum(), bwd(res, lse, w * one, rs),
                vlt5._dscores(one, lse, ll, labels, scores))

    rec["ms"] = time_ms([lambda s=s: op(s, HL.head_loss_forward,
                                        HL.head_loss_backward)
                         for s in sets])
    rec["plain_ms"] = time_ms([lambda s=s: op(s, vlt5._plain_forward,
                                              vlt5._plain_backward)
                               for s in sets])
    rec["library_ms"] = time_ms([library])
    flops = 2 * rows * V * D
    rec["bound_ms"], rec["bound_by"] = _bound(
        4 * rows * D + 8 * V * D, 4 * flops / PEAK_FLOPS["bfloat16"])
    rec["bound3_ms"], rec["bound3_by"] = _bound(
        4 * rows * D + 8 * V * D + 8 * rows * V,
        3 * flops / PEAK_FLOPS["bfloat16"])
    rec["h1"] = {"ms": time_ms([lambda: HL.head_lse(hs, wb, safe)]),
                 "plain_ms": time_ms([lambda: HL.lse_reference(hs, wb, safe)]),
                 "library_ms": time_ms([lambda: torch.logsumexp(
                     mm_f32_out(hs, wb.t()), dim=-1)]),
                 "max_abs_err": lse_err}
    rec["h2"] = {"ms": time_ms([lambda: HL.head_dlogits(hs, wb, safe, lse,
                                                        wts)]),
                 "plain_ms": time_ms([lambda: HL.dlogits_reference(
                     hs, wb, safe, lse, wts)]),
                 "library_ms": time_ms([lambda: (torch.exp(
                     mm_f32_out(hs, wb.t()) - lse[:, None]) * wts[:, None]
                     ).to(torch.bfloat16)]),
                 "max_abs_err": dl_err}
    for key, nbytes in (("h1", 2 * (rows * D + V * D) + 8 * rows),
                        ("h2", 2 * (rows * D + V * D) + 4 * rows * V)):
        rec[key]["bound_ms"], rec[key]["bound_by"] = _bound(
            nbytes, flops / PEAK_FLOPS["bfloat16"])
    rec["k5_ms"] = {k: time_ms([lambda x=x, g=g: dw.dw_splitk(x, g)])
                    for k, (x, g) in k5_pairs.items()}
    # K5's row of the kernels line: its two products as a step runs them
    k5_bytes = sum((x.numel() + g.numel()) * 2 + x.shape[1] * g.shape[1] * 4
                   for x, g in k5_pairs.values())
    k5 = {"ms": sum(rec["k5_ms"].values()),
          "max_abs_err": max(v[0] for v in k5_err.values()),
          "plain_ms": time_ms([lambda: [dw.dw_splitk_reference(*xg)
                                        for xg in k5_pairs.values()]]),
          "library_ms": time_ms([lambda: (mm_f32_out(dk, wb),
                                          mm_f32_out(dk.t(), hs))])}
    k5["bound_ms"], k5["bound_by"] = _bound(
        k5_bytes, 2 * flops / PEAK_FLOPS["bfloat16"])
    rec["k5"] = k5
    log(f"kernel_time {name}: forward + backward kernels_ms={rec['ms']:.5f} "
        f"plain_ms={rec['plain_ms']:.5f} library_ms={rec['library_ms']:.5f} "
        f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}: 4 x {flops} "
        f"FLOP), three products with the f32 logits' round trip "
        f"bound3_ms={rec['bound3_ms']:.5f} ({rec['bound3_by']}); H1 "
        f"{json.dumps(rec['h1'])}; H2 {json.dumps(rec['h2'])}; K5 "
        f"{json.dumps(rec['k5_ms'])}, both {json.dumps(k5)}")
    return rec


def nms_inputs(N, n_invalid, seed, clusters=0):
    """N boxes on an ``NMS_IMAGE`` image (anchor-like sizes 16..512 px),
    the last ``n_invalid`` rows invalid; with ``clusters``, N copies of
    that many boxes of 64..512 px jittered by ±0.25 px (IoU > 0.9 within
    a cluster), so that even IoU 0.9 keeps few."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W, H = NMS_IMAGE
    n = clusters or N
    lo = 64.0 if clusters else 16.0
    xy = torch.rand(n, 2, generator=g, device="cuda") * torch.tensor(
        [W, H], device="cuda")
    wh = lo + (512.0 - lo) * torch.rand(n, 2, generator=g,
                                        device="cuda") ** 2
    boxes = torch.cat([xy, xy + wh], dim=1)
    if clusters:
        boxes = boxes[torch.arange(N, device="cuda") % clusters] + 0.25 * (
            2.0 * torch.rand(N, 4, generator=g, device="cuda") - 1.0)
    valid = torch.arange(N, device="cuda") < N - n_invalid
    return boxes.contiguous(), valid


def check_nms(nms, name, N, thresholds, n_invalid=0, clusters=0,
              timed=False, seed=0):
    """N1 vs its plain version: every keep mask bit-equal, a second
    launch bit-equal; with ``timed`` also the times and the bound."""
    boxes, valid = nms_inputs(N, n_invalid, seed, clusters)
    thr = torch.tensor(thresholds, dtype=torch.float32, device="cuda")
    keep = nms.greedy_nms(boxes, valid, thr)
    again = nms.greedy_nms(boxes, valid, thr)
    ref = nms.greedy_nms_reference(boxes, valid, thr)
    torch.cuda.synchronize()
    diff = int((keep != ref).sum())
    same = torch.equal(keep, again)
    kept = keep.sum(dim=1).tolist()
    log(f"kernel_check {name}: N1 N={N} T={len(thresholds)} thresholds "
        f"{list(thresholds)} invalid={n_invalid} kept={kept} keep bits "
        f"differing from plain={diff} (tol 0); second launch equal: {same} "
        f"-> {'ok' if diff == 0 and same else 'MISMATCH'}")
    if diff or not same:
        fail(f"{name}: N1 disagrees with its plain version")
    row = {"max_abs_err": float(diff), "kept": kept}
    if not timed:
        return row
    sets = [(boxes, valid, thr)] + [
        nms_inputs(N, n_invalid, 400 + i, clusters) + (thr,)
        for i in range(3)]
    fns = [lambda s=s: nms.greedy_nms(*s) for s in sets]
    if h.BASE_CSRC is not None and not os.path.exists(
            os.path.join(h.BASE_CSRC, "nms.cu")):
        row["ms"] = time_ms(fns)
    else:
        put_ab(row, "ms", time_ab(fns))
    plain = [lambda s=s: nms.greedy_nms_reference(*s) for s in sets]
    row["plain_ms"] = time_ms(plain, iters=NMS_PLAIN_ITERS, warmup=1)
    row["plain_call_ms"] = time_ms(plain, iters=NMS_PLAIN_ITERS, warmup=1,
                                   spin=False)
    # PyTorch has no NMS of its own (torchvision's is a library apart)
    row["library_ms"] = None
    T = len(thresholds)
    # each input read once, the keep masks written once; every pair of
    # boxes once: 2 max, 2 min, 2 sub, 2 clamps, 1 mul, 1 add, 1 sub,
    # 1 div and T compares (f32, off the tensor cores), plus N areas
    nbytes = N * 16 + N + 4 * T + T * N
    flops = N * (N - 1) // 2 * (12 + T) + 5 * N
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS["float32"])
    row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name}: kernel_ms={row['ms']:.5f} plain_ms="
        f"{row['plain_ms']:.5f} plain_call_ms={row['plain_call_ms']:.5f} "
        f"library_ms=None (no NMS in PyTorch) bound_ms={row['bound_ms']:.6f} "
        f"({row['bound_by']}: {nbytes} B, {flops} FLOP; the {N} decisions "
        f"are a dependent chain the bound does not see)")
    return row


def strided_inputs(B, Tq, Sk, H, dk, L, dt, layout, seed, causal=False,
                   fold_layers=12):
    """Phase 2's training inputs packed as the merged projections lay them
    out → (views (q, k, v), packed buffers, their dense copies, do, bias,
    mask). ``layout``: "self" (q|k|v in one [B,S,3W] buffer), "cross" (q
    dense, k|v in [B,Sk,2W]) or "folded" (q dense, k and v the slices of
    one layer in the middle of a [B,Sk,2·fold_layers·W] fold)."""
    W = H * dk
    q0, k0, v0, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, L or Sk, seed, causal=causal)
    if layout == "self":
        buf = torch.cat([q0, k0, v0], dim=-1)
        views, packed = (buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:]), \
            (buf, None)
    elif layout == "cross":
        kv = torch.cat([k0, v0], dim=-1)
        views, packed = (q0, kv[..., :W], kv[..., W:]), (q0, kv)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed + 2)
        fold = torch.randn(B, Sk, 2 * fold_layers * W, generator=g,
                           device="cuda").to(dt)
        o = 2 * (fold_layers // 2) * W
        fold[..., o:o + W] = k0
        fold[..., o + W:o + 2 * W] = v0
        views, packed = (q0, fold[..., o:o + W],
                         fold[..., o + W:o + 2 * W]), (q0, fold)
    return views, packed, (q0, k0, v0), do, bias, mask


def check_strided(fa, name, B, Tq, Sk, H, dk, L, dtype, rate, layout,
                  causal=False, timed=False):
    """K1 (at rate 0), K1′ and K2 on strided views of the merged
    projection layouts against the same kernels on dense copies, bit for
    bit (the stride changes addresses, not arithmetic); K2 also writing
    into one gradient buffer of the packed layout, bit-equal to the dense
    dq, dk, dv side by side; each strided call counted once in its
    wrapper's ``strided_launches`` and each call on the dense copies (the
    same C entry, at the stride H·dk) not at all. With
    ``timed``: strided and dense times (K1 at rate 0, else K1′ and K2) in
    the order dense, strided, strided, dense, beside the bound → row."""
    dt = getattr(torch, dtype)
    W = H * dk
    (q, k, v), packed, (qc, kc, vc), do, bias, mask = strided_inputs(
        B, Tq, Sk, H, dk, L, dt, layout, seed=B + Tq + Sk + 7,
        causal=causal)
    seed = torch.tensor([4242 + Tq], dtype=torch.int32, device="cuda")
    before = launches.read()
    eq = {}
    if rate == 0.0:
        eq["K1"] = torch.equal(fa.fused_attention(q, k, v, bias, mask, H),
                               fa.fused_attention(qc, kc, vc, bias, mask, H))
    o_s, p_s = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H,
                                            rate)
    o_c, p_c = fa.fused_attention_fwd_train(qc, kc, vc, bias, mask, seed, H,
                                            rate)
    eq["K1'"] = torch.equal(o_s, o_c) and torch.equal(p_s, p_c)
    g_s = fa.fused_attention_bwd(q, k, v, p_s, seed, do, H, L, rate)
    g_c = fa.fused_attention_bwd(qc, kc, vc, p_c, seed, do, H, L, rate)
    eq["K2"] = all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(g_s, g_c))
    # K2 into the merged gradient buffer, as _FusedAttentionPacked runs it
    x, kv = packed
    dx = torch.full_like(x, float("nan"))
    dkv = None if kv is None else torch.full_like(kv, float("nan"))
    if layout == "self":
        out = (dx[..., :W], dx[..., W:2 * W], dx[..., 2 * W:])
        want = [(dx, torch.cat(g_c[:3], dim=-1))]
    else:
        o = 0 if layout == "cross" else (kv.shape[-1] // 2 // W // 2) * 2 * W
        out = (dx, dkv[..., o:o + W], dkv[..., o + W:o + 2 * W])
        want = [(dx, g_c[0]), (dkv[..., o:o + 2 * W],
                               torch.cat(g_c[1:3], dim=-1))]
    fa.fused_attention_bwd(q, k, v, p_s, seed, do, H, L, rate, out=out)
    torch.cuda.synchronize()
    eq["K2 merged buffer"] = all(torch.equal(a, b) for a, b in want)
    # K1 (rate 0), K1′, K2 and the merged-buffer K2: once each, strided
    launched = list(h.since(before).strided)
    want_counts = [int(rate == 0.0), 1, 2]
    log(f"strided_check {name}: layout={layout} row strides "
        f"{list(fa._qkv_strides(q, k, v))} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} rate={rate}; bit-equal to dense: "
        f"{json.dumps(eq)}; strided launches K1/K1'/K2 {launched} "
        f"(expected {want_counts})")
    if not all(eq.values()) or launched != want_counts:
        fail(f"{name}: a strided launch differs from the dense one")
    if not timed:
        return {}
    sets = [strided_inputs(B, Tq, Sk, H, dk, L, dt, layout, seed=500 + i,
                           causal=causal) for i in range(4)]
    ps = [fa.fused_attention_fwd_train(*s[2], s[4], s[5], seed, H, rate)[1]
          for s in sets]
    calls = {
        "K1": lambda qkv, s, p: fa.fused_attention(*qkv, s[4], s[5], H),
        "K1'": lambda qkv, s, p: fa.fused_attention_fwd_train(
            *qkv, s[4], s[5], seed, H, rate),
        "K2": lambda qkv, s, p: fa.fused_attention_bwd(*qkv, p, seed, s[3],
                                                       H, L, rate)}
    elem = q.element_size()
    p_bytes = B * H * Tq * Sk * 4
    io = (2 * B * Tq + 2 * B * Sk) * W * elem
    small = B * Sk * 4 + H * L * L * 4
    prod = 2 * B * H * Tq * Sk * dk
    peak = PEAK_FLOPS[dtype]
    bounds = {"K1": _bound(io + small, 2 * prod / peak),
              "K1'": _bound(io + p_bytes + small + 4, 2 * prod / peak),
              "K2": _bound(io + p_bytes + (B * Tq + 2 * B * Sk) * W * elem
                           + H * L * L * 4 + 4, 4 * prod / peak)}
    row = {}
    for kind in ("K1",) if rate == 0.0 else ("K1'", "K2"):
        fn = calls[kind]
        dense = [lambda s=s, p=p: fn(s[2], s, p) for s, p in zip(sets, ps)]
        strided = [lambda s=s, p=p: fn(s[0], s, p) for s, p in zip(sets, ps)]
        d1, s1, s2, d2 = (time_ms(dense), time_ms(strided),
                          time_ms(strided), time_ms(dense))
        b_ms, b_by = bounds[kind]
        row[kind] = {"strided_ms": (s1 + s2) / 2, "dense_ms": (d1 + d2) / 2,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"strided_time {name} {kind}: strided_ms={(s1 + s2) / 2:.5f} "
            f"dense_ms={(d1 + d2) / 2:.5f} (dense {d1:.5f}, strided "
            f"{s1:.5f}, {s2:.5f}, dense {d2:.5f}) bound_ms={b_ms:.5f} "
            f"({b_by})")
    return row


def check_stride_refused(fa):
    """A bf16 q/k/v view whose row stride is not a multiple of 8 elements
    (so its rows do not start on 16 bytes) is refused by K1's, K1′'s and
    K2's wrappers with ValueError before any launch."""
    B, S, H, dk = 4, 16, 4, 64
    W = H * dk
    buf = torch.zeros(B, S, 3 * W + BAD_STRIDE_PAD, dtype=torch.bfloat16,
                      device="cuda")
    q, k, v = buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:3 * W]
    mask = torch.ones(B, S, device="cuda")
    seed = torch.zeros((1,), dtype=torch.int32, device="cuda")
    p = torch.zeros(B, H * S, S, device="cuda")
    do = torch.zeros(B, S, W, dtype=torch.bfloat16, device="cuda")
    before = launches.read()
    msgs = []
    for call in (lambda: fa.fused_attention(q, k, v, None, mask, H),
                 lambda: fa.fused_attention_fwd_train(q, k, v, None, mask,
                                                      seed, H, 0.0),
                 lambda: fa.fused_attention_bwd(q, k, v, p, seed, do, H, 0,
                                                0.0)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
            continue
        fail(f"a bf16 row stride of {3 * W + BAD_STRIDE_PAD} was not "
             f"refused")
    if h.since(before).k != (0, 0, 0):
        fail("a refused strided call launched a kernel")
    log(f"strided_check refused_stride_{3 * W + BAD_STRIDE_PAD}: K1, K1' "
        f"and K2 raise ValueError before any launch ({msgs[0]})")


def check_offset_attention(fa, B, Tq, Sk, H, dk, L, dtype, rate, text_len):
    """K1′ and K2 on the rows B … 2B − 1 of a batch of 2B with the row
    offset bh0 = B·H (a second rank's share): each output equal bit for
    bit to the same rows of one launch over all 2B rows at bh0 = 0, and
    to the plain versions at bh0 within the phase 2 tolerance; the keep
    mask the kernels draw at bh0 equal bit for bit to the plain version's
    and to rows B … of the one-launch mask. → max errors vs plain."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        2 * B, Tq, Sk, H, dk, L, dt, text_len, seed=7 + B)
    seed = torch.tensor([31337], dtype=torch.int32, device="cuda")
    bh0 = B * H
    whole_o, whole_p = fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                    seed, H, rate)
    whole_g = fa.fused_attention_bwd(q, k, v, whole_p, seed, do, H, L, rate)
    part = [t[B:] for t in (q, k, v, do, mask)]
    qp, kp, vp, dop, mp = (t.contiguous() for t in part)
    o, p = fa.fused_attention_fwd_train(qp, kp, vp, bias, mp, seed, H, rate,
                                        bh0)
    g = fa.fused_attention_bwd(qp, kp, vp, p, seed, dop, H, L, rate,
                               bh0=bh0)
    ro, rp = fa.fused_attention_fwd_train_reference(qp, kp, vp, bias, mp,
                                                    seed, H, rate, bh0)
    rg = fa.fused_attention_bwd_reference(qp, kp, vp, rp, seed, dop, H, L,
                                          rate, bh0)
    mine = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate, bh0)
    whole_mask = fa.fused_attention_keep_mask(seed, 2 * B, H, Tq, Sk, rate)
    plain = fa.philox_keep_mask(seed, B, H, Tq, Sk, rate, bh0)
    torch.cuda.synchronize()
    same = {"o": torch.equal(o, whole_o[B:]),
            "p": torch.equal(p, whole_p[B:]),
            "dq": torch.equal(g[0], whole_g[0][B:]),
            "dk": torch.equal(g[1], whole_g[1][B:]),
            "dv": torch.equal(g[2], whole_g[2][B:]),
            "mask_rows": torch.equal(mine, whole_mask[B:]),
            "mask_plain": torch.equal(mine, plain)}
    errs, oks = {}, []
    for key, a, b, tol_dt in (("o", o, ro, dtype), ("p", p, rp, "float32"),
                              ("dq", g[0], rg[0], dtype),
                              ("dk", g[1], rg[1], dtype),
                              ("dv", g[2], rg[2], dtype)):
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    log(f"offset_check: B={B} of {2 * B} Tq={Tq} Sk={Sk} H={H} dk={dk} "
        f"L={L} {dtype} rate={rate} bh0={bh0}: bit-equal to rows {B}.. of "
        f"the one launch {json.dumps(same)}; vs plain max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
    if not all(same.values()) or not all(oks):
        fail("K1'/K2 at a row offset differ from the one-launch rows or "
             "their plain versions")
    return {"same": same, "max_abs_err": errs, "kept": float(
        mine.float().mean())}


def check_head_offset_attention(fa, B, Tq, Sk, H, dk, L, dtype, rate,
                                text_len):
    """K1′ and K2 over heads H/2 … H − 1 with ``(Hc = H, h0 = H/2)`` (a
    second tensor-parallel rank's heads): o, p, dq, dk, dv, the dbias
    panel and the keep mask equal bit for bit to those heads of one launch
    over all H, and within the phase 2 tolerance of the plain versions at
    the same ``(Hc, h0)``; the mask also equal to the plain one. → the
    record (max errors vs plain)."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len, seed=11 + B)
    seed = torch.tensor([271828], dtype=torch.int32, device="cuda")
    n = h0 = H // 2
    whole_o, whole_p = fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                    seed, H, rate)
    whole_g = fa.fused_attention_bwd(q, k, v, whole_p, seed, do, H, L, rate)
    cols = lambda t: t[..., h0 * dk:].contiguous()  # noqa: E731
    qp, kp, vp, dop = (cols(t) for t in (q, k, v, do))
    bp = bias[h0:].contiguous()
    o, p = fa.fused_attention_fwd_train(qp, kp, vp, bp, mask, seed, n, rate,
                                        Hc=H, h0=h0)
    g = fa.fused_attention_bwd(qp, kp, vp, p, seed, dop, n, L, rate, Hc=H,
                               h0=h0)
    ro, rp = fa.fused_attention_fwd_train_reference(qp, kp, vp, bp, mask,
                                                    seed, n, rate, Hc=H,
                                                    h0=h0)
    rg = fa.fused_attention_bwd_reference(qp, kp, vp, rp, seed, dop, n, L,
                                          rate, Hc=H, h0=h0)
    mine = fa.fused_attention_keep_mask(seed, B, n, Tq, Sk, rate, Hc=H,
                                        h0=h0)
    whole_mask = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate)
    plain = fa.philox_keep_mask(seed, B, n, Tq, Sk, rate, Hc=H, h0=h0)
    torch.cuda.synchronize()
    heads = lambda t: t.reshape(B, H, Tq, Sk)[:, h0:].reshape(  # noqa: E731
        B, n * Tq, Sk)
    same = {"o": torch.equal(o, cols(whole_o)),
            "p": torch.equal(p, heads(whole_p)),
            "dq": torch.equal(g[0], cols(whole_g[0])),
            "dk": torch.equal(g[1], cols(whole_g[1])),
            "dv": torch.equal(g[2], cols(whole_g[2])),
            "dbias": torch.equal(g[3], whole_g[3][h0:]),
            "mask_heads": torch.equal(mine, whole_mask[:, h0:]),
            "mask_plain": torch.equal(mine, plain)}
    errs, oks = {}, []
    for key, a, b, tol_dt in (("o", o, ro, dtype), ("p", p, rp, "float32"),
                              ("dq", g[0], rg[0], dtype),
                              ("dk", g[1], rg[1], dtype),
                              ("dv", g[2], rg[2], dtype),
                              ("dbias", g[3], rg[3], "float32")):
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    log(f"head_offset_check: heads {h0}..{H - 1} of {H} (Hc={H}, h0={h0}) "
        f"B={B} Tq={Tq} Sk={Sk} dk={dk} L={L} {dtype} rate={rate}: "
        f"bit-equal to those heads of the one launch {json.dumps(same)}; "
        f"vs plain max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
    if not all(same.values()) or not all(oks):
        fail("K1'/K2 over a head slice differ from the one launch's heads "
             "or their plain versions")
    return {"same": same, "max_abs_err": errs, "heads": [h0, H],
            "kept": float(mine.float().mean())}
