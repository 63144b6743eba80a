#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
(an H100) and check them.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --base DIR   # phases 1-2, timed against DIR

Phases, each of which exits non-zero on failure:

1. Build every CUDA kernel of the paths from ``vqacl_tpu_torch/csrc``,
   one nvcc per source, all started together.
2. Kernel check: each kernel against its plain PyTorch version on the
   same inputs, with the tolerance printed beside the error, and a
   second launch on the same inputs equal bit for bit. K1 (the
   inference forward) at the eval shape and at rectangular and odd
   shapes; K1′ (training forward) and K2 (backward) at the train shape,
   rectangular and odd f32 shapes and the decoder shapes, at dropout 0
   and 0.1 (the plain version draws the kernels' own Philox mask, which
   is also compared bit for bit), timed also at the fused decoder's
   shapes; K1, K1′ and K2 at the edges of the bf16 tensor-core routes
   (Tq not a multiple of 16 with odd Sk, Sk = 128, Sk = 300, dk = 128),
   and a bf16 call at dk = 8 refused with ValueError before any launch;
   each K1/K1′/K2 check names its route (``mma.sync bf16`` or ``scalar
   f32``); K5 (``dw_splitk``, xᵀ·g) at the probe's shape and at odd
   shapes. CUDA-event times of each kernel, its plain version and one
   library call (a yardstick only), queued behind a spin kernel so that
   they time the card's work and not the host's launch rate; K1 and K1′
   also with the host's enqueue included (``call_ms``). A bf16 training
   call that K2 cannot take (Sk = 512) is refused before K1′ launches.
3. The eval slice: random-init t5-base (seeded), cast for inference,
   bf16, ``make_eval_step`` at batch 100 on a synthetic batch; the
   launch counts over the timed steps; the encoder through the kernel
   against the unfused encoder; f32 tokens on the card against the CPU
   plain path on a tiny config.
4. The training slice: random-init t5-base, f32 master weights, bf16
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
5. Serving: ``VQAServer`` over a ``VQAPredictor`` answers concurrent
   ``submit()`` calls with no errors.
6. ``vqacl_tpu_torch.mm_bench``: the probe's matrix products and the K5
   weight-gradient kernel ``dw_splitk`` at the probe's shapes.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's name and power limit; the last line is the run's verdict as JSON.
Without a CUDA device, or outside a checkout, it prints no result and
exits non-zero.

``--base DIR`` compares this checkout's kernels with another's on the
same card in one run: DIR holds that checkout (for example ``git archive
<commit> | tar -x -C build/base``), whose ``vqacl_tpu_torch/csrc`` is
built beside this one's. Phases 1 and 2 run; every timed K1, K1′ and K2
is timed through the same wrappers and inputs with DIR's libraries too,
in the order base, this, this, base, on both measures (device and
``call_ms``). The C signatures must be the same in both. The run then
prints an ``ab`` JSON line and stops.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
# cycles per second a spin kernel is sized with: above the H100's boost
# clock (1.98 GHz), so a spin lasts at least as long as asked
SPIN_HZ = 2.0e9
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output
# rounding (2^-8 relative) and a p rounded to bf16 on either side of a
# tie give up to ~2 ulps; f32 differs only in summation order. K1′'s p
# and K2's dbias are f32 whatever the inputs' dtype.
TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}
EVAL_BATCH = 100
EVAL_STEPS = 3
TRAIN_BATCH = 80
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
DROPOUT = 0.1
# parameter gradients through the kernels vs the unfused encoder, as
# ‖g_kernel − g_plain‖ / ‖g_plain‖ over all parameters: in bf16 the two
# backward passes round at different points (autograd of the plain path
# takes the bf16-rounded probabilities, K2 works in f32), in f32 only the
# summation order differs
GRAD_REL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
SMALL_PARAM_TOL = 3e-5
# the loss-eval step through the fused decoder vs the unfused decoder,
# relative: bf16 rounds p before p·v in the kernel and after the f32
# softmax in the plain path; f32 differs only in summation order
LOSS_EVAL_RTOL = {"bfloat16": 5e-3, "float32": 1e-5}
# remat replays the block's own arithmetic on the same inputs, so the
# gradients agree to the last bit; the bound leaves room for nothing else
REMAT_GRAD_RTOL = 1e-6
# K5 (xᵀ·g) at the probe's shape (K = batch x sequence rows of the MLP
# input, D = d_model, F = d_ff) and at odd shapes; both sides sum in
# f32 in other orders: |kernel - plain| <= DW_RTOL * Σ_k|x_kd g_kf| + 1e-6
DW_PROBE = (4480, 768, 3072)
DW_ODD = ((100, 40, 72), (97, 131, 257))
DW_RTOL = 1e-5
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
# set by --base: another checkout's kernel sources, timed beside these
BASE_CSRC = None


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fns, iters=50, warmup=5, spin=True) -> float:
    """Mean CUDA-event time of one call, cycling through ``fns`` (one per
    input set, so each call finds its inputs out of L2 as the encoder's
    layer-to-layer traffic would). With ``spin`` the timed calls are
    queued behind a spin kernel that outlasts their enqueue on the host,
    so the events time the card's work back to back (the device time);
    without it, calls issued back to back from the host, whichever of
    host and card is slower (the time a caller sees per call)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(min(2.0 * host_s, 1.0) * SPIN_HZ))
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ab(fns, spin=True):
    """``time_ms(fns)`` → (ms, base_ms). With ``--base`` the same calls
    also run on the base checkout's libraries (the wrappers load them by
    name at each call), in the order base, this, this, base; each side's
    time is the mean of its two. Without it base_ms is None."""
    if BASE_CSRC is None:
        return time_ms(fns, spin=spin), None
    from vqacl_tpu_torch.ops import _build

    load = _build.load

    def on_base():
        _build.load = lambda name: load(name, BASE_CSRC)
        try:
            return time_ms(fns, spin=spin)
        finally:
            _build.load = load

    b1 = on_base()
    t1, t2 = time_ms(fns, spin=spin), time_ms(fns, spin=spin)
    b2 = on_base()
    log(f"  ab {'device' if spin else 'call'}: base {b1:.5f} this {t1:.5f} "
        f"this {t2:.5f} base {b2:.5f} ms")
    return (t1 + t2) / 2, (b1 + b2) / 2


def put_ab(row, key, times):
    """row[key] = this checkout's time; row["base_" + key] = the base's."""
    row[key], base = times
    if base is not None:
        row["base_" + key] = base


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_s * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
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
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
    counts = lambda: (fa.fused_attention.launches,
                      fa.fused_attention_fwd_train.launches)
    before = counts()
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
    if counts() != before:
        fail(f"a refused bf16 call launched a kernel: {before} -> {counts()}")
    log(f"kernel_check refused_bf16_dk8: K1 and K1' raise ValueError before "
        f"any launch ({msgs[0]})")
    name, B, Tq, Sk, H, dk, L = K2_REFUSED
    q, k, v, bias, mask = attention_inputs(B, Tq, Sk, H, dk, L,
                                           torch.bfloat16, L, seed=2)
    counts = lambda: (fa.fused_attention_fwd_train.launches,
                      fa.fused_attention_bwd.launches)
    before = counts()
    try:
        fa.fused_attention(q.requires_grad_(), k, v, bias, mask, H, DROPOUT,
                           seed)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"a differentiable call at {name}'s shape was not refused")
    if counts() != before:
        fail(f"a refused training call launched K1'/K2: {before} -> "
             f"{counts()}")
    log(f"kernel_check refused_bwd_{name}: a training call raises "
        f"ValueError before K1' launches ({msg})")


def dw_inputs(K, D, F, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(K, D, generator=g, device="cuda").to(dtype)
    dy = torch.randn(K, F, generator=g, device="cuda").to(dtype)
    return x, dy


def check_dw(dw, name, K, D, F, dtype, timed=False):
    """K5 vs its plain version (and a second launch bit for bit); with
    ``timed`` also the times, bound and library yardstick."""
    dt = getattr(torch, dtype)
    x, dy = dw_inputs(K, D, F, dt, seed=K + D + F)
    out = dw.dw_splitk(x, dy)
    ref = dw.dw_splitk_reference(x, dy)
    again = dw.dw_splitk(x, dy)
    scale = x.float().abs().t() @ dy.float().abs()
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (D, F):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out - ref).abs()
    tol = DW_RTOL * scale + 1e-6
    err = float(diff.max())
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(out).all())
    same = torch.equal(out, again)
    log(f"kernel_check {name}: K={K} D={D} F={F} {dtype} max_abs_err="
        f"{err:.3e} max err/tol={float((diff / tol).max()):.3e} tol="
        f"{DW_RTOL:g}*sum|x*g| + 1e-6; second launch equal: {same} -> "
        f"{'ok' if ok and same else 'MISMATCH'}")
    if not (ok and same):
        fail(f"{name}: dw_splitk disagrees with its plain version")
    row = {"max_abs_err": err}
    if not timed:
        return row
    sets = [(x, dy)] + [dw_inputs(K, D, F, dt, seed=300 + i)
                        for i in range(3)]
    row["ms"] = time_ms([lambda s=s: dw.dw_splitk(*s) for s in sets])
    row["plain_ms"] = time_ms([lambda s=s: dw.dw_splitk_reference(*s)
                               for s in sets])
    # bf16 out (cuBLAS sums in f32 and rounds the result)
    row["library_ms"] = time_ms([lambda s=s: torch.matmul(s[0].t(), s[1])
                                 for s in sets])
    elem = x.element_size()
    nbytes = (K * D + K * F) * elem + D * F * 4
    flops = 2 * K * D * F
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name}: kernel_ms={row['ms']:.5f} "
        f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
        f"(torch.matmul(x.t(), g), {dtype} out) bound_ms="
        f"{row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, {flops} "
        f"FLOP)")
    return row


def _grads(vlt5, tree_leaves, tree_map, params, mcfg, batch, proto, dtype,
           generator=None, remat=False, peak=None):
    """(loss, flat f32 gradient) of the training forward (deterministic
    without a ``generator``). With a ``peak`` dict, its "bytes" get the
    device memory peak of the forward and backward above their start
    (the gradients included, their flat copy not)."""
    if peak is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = vlt5.forward_train(live, mcfg, batch, proto, 0.5, 0.3,
                             generator=generator, dtype=dtype, remat=remat)
    leaves = tree_leaves(live)
    gs = torch.autograd.grad(out.loss, leaves, allow_unused=True)
    if peak is not None:
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated() - start
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).float()
                      .reshape(-1) for p, g in zip(leaves, gs)])
    return float(out.loss.detach()), flat


def main(argv=None) -> int:
    global BASE_CSRC
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", metavar="DIR",
                    help="another checkout: time its kernels beside these "
                         "(phases 1-2 only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vqacl_tpu_torch")):
        print("chip_smoke: run from a checkout (vqacl_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    if args.base:
        BASE_CSRC = os.path.join(os.path.abspath(args.base),
                                 "vqacl_tpu_torch", "csrc")
        if not os.path.isdir(BASE_CSRC):
            print(f"chip_smoke: --base {args.base}: no vqacl_tpu_torch/csrc",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from vqacl_tpu_torch.data.collate import collate
    from vqacl_tpu_torch.data.features import MemoryFeatureStore
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch import mm_bench
    from vqacl_tpu_torch.ops import _build, dw
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
    from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves,
                                             tree_map)
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import (make_eval_step,
                                            make_loss_eval_step,
                                            make_train_step)
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    counters = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)

    def zero_counts():
        for c in counters:
            c.launches = 0

    def read_counts():
        return tuple(c.launches for c in counters)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    libs = _build.build()
    if BASE_CSRC is not None:
        base_libs = _build.build(csrc=BASE_CSRC)
        log(f"base: {BASE_CSRC}, {len(base_libs)} kernel libraries")
    log(f"build: {len(libs)} kernel libraries in {time.time() - t0:.1f} s")

    # ---- 2. kernel check ------------------------------------------------
    cfg = Config()
    m = cfg.model
    H, dk, L = m.num_heads, m.d_kv, m.max_text_length
    S = m.encoder_len
    k1 = check_attention(fa, "eval_shape", EVAL_BATCH, S, S, H, dk, L,
                         "bfloat16", text_len=L, timed=True)
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
    # K5 at the probe's shape and at odd shapes
    k5 = check_dw(dw, "dw_probe", *DW_PROBE, "bfloat16", timed=True)
    check_dw(dw, "dw_probe_f32", *DW_PROBE, "float32")
    for shape in DW_ODD:
        for dname in ("bfloat16", "float32"):
            check_dw(dw, "dw_odd", *shape, dname)
    if BASE_CSRC is not None:
        keys = ("ms", "base_ms", "call_ms", "base_call_ms", "bound_ms")
        pick_ab = lambda r: {k: r[k] for k in keys if k in r}
        log("ab " + json.dumps({
            "base": BASE_CSRC, "card": card,
            "K1 eval": pick_ab(k1), "K1' train": pick_ab(k1p),
            "K2 train": pick_ab(k2),
            "K1' decoder self": pick_ab(dec_rows["self"][0]),
            "K1' decoder cross": pick_ab(dec_rows["cross"][0]),
            "K2 decoder self": pick_ab(dec_rows["self"][1]),
            "K2 decoder cross": pick_ab(dec_rows["cross"][1]),
            "K1 decoder self": pick_ab(dec_rows["self_eval"]),
            "K1 decoder cross": pick_ab(dec_rows["cross_eval"])}))
        return 0

    # ---- 3. the slice at t5-base -----------------------------------------
    t0 = time.time()
    params = vlt5.init_vlt5_params(0, m, device="cuda")
    # without this a random decoder keeps predicting its start token (pad)
    params["shared"][m.pad_token_id] = 0.0
    cast = vlt5.cast_params_for_inference(params, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cuda")
    proto = proto._replace(
        q_proto=torch.randn(m.n_ques_types, m.d_model, generator=g,
                            device="cuda"),
        v_proto=torch.randn(m.n_categories, m.d_model, generator=g,
                            device="cuda"))
    pool = SyntheticVQA(EVAL_BATCH, seed=0)
    batch = collate(pool.examples, with_targets=False)["tensors"]
    log(f"slice: t5-base random init + cast in {time.time() - t0:.1f} s")

    ev = make_eval_step(cfg, dtype=torch.bfloat16, device="cuda")
    tokens = ev(cast, proto, batch)             # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        tokens = ev(cast, proto, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    eval_launches, eval_k1p, eval_k2 = read_counts()
    per_step = eval_launches / EVAL_STEPS
    eval_step_ms = sorted(times)[len(times) // 2]
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
    tiny = Config()
    tiny.model = tiny_model_config(vocab_size=32200)
    tp_cpu = vlt5.init_vlt5_params(3, tiny.model, device="cpu")
    tp_cpu["shared"][tiny.model.pad_token_id] = 0.0
    tproto = ProtoState.create(tiny.model.n_ques_types,
                               tiny.model.n_categories, tiny.model.d_model,
                               device="cpu")
    tb = collate(SyntheticVQA(8, seed=2, feat_dim=tiny.model.feat_dim,
                              n_boxes=tiny.model.n_boxes,
                              text_len=tiny.model.max_text_length).examples,
                 max_text_length=tiny.model.max_text_length,
                 n_boxes=tiny.model.n_boxes, feat_dim=tiny.model.feat_dim,
                 with_targets=False)["tensors"]
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

    # ---- 4. the training slice at t5-base ---------------------------------
    tcfg = Config()
    tm_ = tcfg.model
    t0 = time.time()
    tparams = vlt5.init_vlt5_params(0, tm_, device="cuda")
    tx = make_transform(tcfg.train)
    tproto0 = ProtoState.create(tm_.n_ques_types, tm_.n_categories,
                                tm_.d_model, device="cuda")
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    gb = {k: torch.from_numpy(v).cuda() for k, v in tbatch.items()}
    log(f"train: t5-base f32 master weights, bf16 compute, dropout "
        f"{tm_.dropout_rate}, batch {TRAIN_BATCH}, lr {tcfg.train.lr}, "
        f"adam {tcfg.train.adam_impl}/{tcfg.train.adam_dtype}; set-up "
        f"{time.time() - t0:.1f} s")

    def drive_train(run_cfg, label, per_step):
        """TRAIN_WARMUP + TRAIN_STEPS train steps on one batch from the
        seeded init; checks the launches per step (K1 0, K1′ and K2
        ``per_step``), finite metrics, a falling loss → (state, record)."""
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
        zero_counts()
        ttimes = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, met = step(state, tbatch)
            torch.cuda.synchronize()
            ttimes.append((time.perf_counter() - t0) * 1e3)
            all_metrics.append({k: float(v) for k, v in met.items()})
        k1, k1p, k2 = read_counts()
        losses = [mt["loss"] for mt in all_metrics]
        ms = sorted(ttimes)[len(ttimes) // 2]
        log(f"{label}: bs {TRAIN_BATCH} bf16 train_step_ms={ms:.3f} (all: "
            f"{', '.join(f'{t:.3f}' for t in ttimes)}) launches over "
            f"{TRAIN_STEPS} steps: K1={k1} K1'={k1p} K2={k2}")
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
                       "losses": losses, "launches": (k1, k1p, k2)}

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
        sm = small.model
        sp = vlt5.init_vlt5_params(5, sm, device="cpu")
        spro = ProtoState.create(sm.n_ques_types, sm.n_categories,
                                 sm.d_model, device="cpu")
        sbatches = [b["tensors"] for b in SyntheticVQA(
            24, seed=6, feat_dim=sm.feat_dim, n_boxes=sm.n_boxes,
            text_len=sm.max_text_length, vocab_size=sm.vocab_size,
            answer_vocab=8).batches(8, seed=1)]
        stx = make_transform(small.train)
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
    train_step_ms, ttimes = train["train_step_ms"], train["train_step_ms_all"]
    losses = train["losses"]
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
    log(f"train_step_ms: unfused decoder {train_step_ms:.3f}, fused decoder "
        f"{fd_train['train_step_ms']:.3f}")
    m_dec_unf = Config().model          # fused encoder, plain decoder
    fd_grad_rel = grad_check(state.params, fm, m_dec_unf, "unfused decoder")
    fd_small = small_train_reference(True)
    # the loss-eval step: K1 in the encoder and in both decoder attentions
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
        zero_counts()
        loss_f = float(ev(state.params, state.proto, part))
        counts = read_counts()
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
    loss_eval_k1 = fd_eval["bfloat16"]["launches"][0]

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
        before = torch.cuda.memory_allocated()
        zero_counts()
        rstate, met = rstep(rstate, tbatch)
        torch.cuda.synchronize()
        counts = read_counts()
        step_peak = torch.cuda.max_memory_allocated() - before
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

    # ---- 5. serving -------------------------------------------------------
    store = MemoryFeatureStore()
    imgs = SyntheticVQA(32, seed=4).examples
    for i, ex in enumerate(imgs):
        store.put(f"img{i}", ex["vis_feats"], ex["boxes"])
    pred = VQAPredictor(cfg, params, proto, VLT5Tokenizer(), store,
                        batch_size=16, dtype=torch.bfloat16, device="cuda")
    n_clients, per_client = 16, 3
    with VQAServer(pred, max_wait_ms=5.0) as srv:
        srv.submit("warm up?", "img0").result(timeout=300)
        warm = srv.stats()
        zero_counts()
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
        serve_launches = fa.fused_attention.launches
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
    if serve_launches != m.num_layers * batches:
        fail(f"serving launched the kernel {serve_launches} times over "
             f"{batches} batches")

    # ---- 6. the mm_bench probe (K5) -------------------------------------
    torch.cuda.synchronize()
    dw.dw_splitk.launches = 0
    mm_rows = mm_bench.run("cuda", MM_BENCH_SHAPES, reps=MM_BENCH_REPS)
    dw_launches = dw.dw_splitk.launches
    log(f"mm_bench ({MM_BENCH_REPS} timed calls per case, CUDA events; peak "
        f"{mm_bench.PEAK_FLOPS / 1e12:g} TFLOP/s bf16; {card}):")
    log(mm_bench.table(mm_rows))
    log(f"mm_bench: dw_splitk launches={dw_launches}")
    if dw_launches == 0:
        fail("mm_bench did not launch dw_splitk")
    if not all(np.isfinite(r["us"]) and r["us"] > 0 for r in mm_rows):
        fail("mm_bench gave a time that is not a positive number")

    def row(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}}

    fwd_src = "vqacl_tpu_torch/csrc/fused_attention_fwd.cu"
    # launches over the main paths' runs: K1 in the eval steps and the
    # fused-decoder loss-eval step, K1′/K2 in the train steps with the
    # plain and with the fused decoder, K5 in the probe
    kernels = [
        row("fused_attention_fwd", fwd_src,
            "vqacl_tpu/ops/fused_attention.py:159",
            eval_launches + loss_eval_k1, k1),
        row("fused_attention_fwd_train", fwd_src,
            "vqacl_tpu/ops/fused_attention.py:199", train_k1p + fd_k1p, k1p),
        row("fused_attention_bwd",
            "vqacl_tpu_torch/csrc/fused_attention_bwd.cu",
            "vqacl_tpu/ops/fused_attention.py:272", train_k2 + fd_k2, k2),
        row("dw_splitk", "vqacl_tpu_torch/csrc/dw_splitk.cu",
            "scripts/mm_bench.py:121", dw_launches, k5),
    ]
    def pick(r):
        return {k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by")
                if k in r}

    dec_times = {"self": {"K1p": pick(dec_rows["self"][0]),
                          "K2": pick(dec_rows["self"][1])},
                 "cross": {"K1p": pick(dec_rows["cross"][0]),
                           "K2": pick(dec_rows["cross"][1])},
                 "self_eval": {"K1": pick(dec_rows["self_eval"])},
                 "cross_eval": {"K1": pick(dec_rows["cross_eval"])}}
    log("summary " + json.dumps({
        "eval_step_ms": eval_step_ms, "eval_batch": EVAL_BATCH,
        "launches_per_eval_step": per_step, "encoder_rel_err": enc_rel,
        "rows_equal": rows_equal, "train_step_ms": train_step_ms,
        "train_step_ms_all": ttimes, "train_batch": TRAIN_BATCH,
        "train_losses": losses,
        "launches_per_train_step": {
            "K1": train_k1 / TRAIN_STEPS, "K1p": train_k1p / TRAIN_STEPS,
            "K2": train_k2 / TRAIN_STEPS},
        "grad_rel_err": grad_rel, "small_train_loss_rel_err": small_loss_err,
        "small_train_param_err": small_param_err,
        "kernel_call_ms": {"K1": k1["call_ms"], "K1p": k1p["call_ms"]},
        "kernel_bytes_flops": {"K1p": [k1p["bytes"], k1p["flops"]],
                               "K2": [k2["bytes"], k2["flops"]],
                               "K5": [k5["bytes"], k5["flops"]]},
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
            "loss_eval": fd_eval, "kernel_times": dec_times},
        "remat": remat_summary, "mm_bench": mm_rows,
        "serve": st, "serve_wall_s": wall, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
