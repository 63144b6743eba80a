#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU (an H100) and
check it.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. Build every CUDA kernel of the path from ``vqacl_tpu_torch/csrc``.
2. Kernel check: each kernel against its plain PyTorch version on the
   same inputs, at the eval shape and at rectangular and odd shapes, with
   the tolerance printed beside the error; CUDA-event times of the
   kernel, the plain version and one library call (a yardstick only).
3. The slice: random-init t5-base (seeded), cast for inference, bf16,
   ``make_eval_step`` at batch 100 on a synthetic batch; the kernel's
   launch count over the timed steps; the encoder through the kernel
   against the unfused encoder; f32 tokens on the card against the CPU
   plain path on a tiny config.
4. Serving: ``VQAServer`` over a ``VQAPredictor`` answers concurrent
   ``submit()`` calls with no errors.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's name and power limit; the last line is the run's verdict as JSON.
Without a CUDA device, or outside a checkout, it prints no result and
exits non-zero.
"""

from __future__ import annotations

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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output
# rounding (2^-8 relative) and a p rounded to bf16 on either side of a
# tie give up to ~2 ulps; f32 differs only in summation order
TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}
EVAL_BATCH = 100
EVAL_STEPS = 3


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


def time_ms(fns, iters=50, warmup=5) -> float:
    """Mean CUDA-event time of one call, cycling through ``fns`` (one per
    input set, so each call finds its inputs out of L2 as the encoder's
    layer-to-layer traffic would)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    out = fa.fused_attention(q, k, v, bias, mask, H)
    ref = fa.fused_attention_reference(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    if out.dtype != dt or out.shape != (B, Tq, H * dk):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    log(f"kernel_check {name}: B={B} Tq={Tq} Sk={Sk} H={H} dk={dk} L={L} "
        f"{dtype} max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
        f" -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
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
    row["ms"] = time_ms([lambda s=s: fa.fused_attention(*s, H)
                                for s in sets])
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
        f"{flops} FLOP)")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vqacl_tpu_torch")):
        print("chip_smoke: run from a checkout (vqacl_tpu_torch/ missing)",
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
    from vqacl_tpu_torch.ops import _build
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
    from vqacl_tpu_torch.train.step import make_eval_step
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

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
    fa.fused_attention.launches = 0
    times = []
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        tokens = ev(cast, proto, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    eval_launches = fa.fused_attention.launches
    per_step = eval_launches / EVAL_STEPS
    eval_step_ms = sorted(times)[len(times) // 2]
    log(f"eval_step: bs {EVAL_BATCH} bf16 eval_step_ms={eval_step_ms:.3f} "
        f"(all: {', '.join(f'{t:.3f}' for t in times)}) "
        f"fused_attention launches={eval_launches} ({per_step:g}/step)")
    if eval_launches != m.num_layers * EVAL_STEPS:
        fail(f"expected {m.num_layers} kernel launches per eval step, got "
             f"{per_step:g}")

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

    # ---- 4. serving -------------------------------------------------------
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
        fa.fused_attention.launches = 0
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

    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "vqacl_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "vqacl_tpu/ops/fused_attention.py:159",
        "launches": eval_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]
    log("summary " + json.dumps({
        "eval_step_ms": eval_step_ms, "eval_batch": EVAL_BATCH,
        "launches_per_eval_step": per_step, "encoder_rel_err": enc_rel,
        "rows_equal": rows_equal, "serve": st, "serve_wall_s": wall,
        "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
