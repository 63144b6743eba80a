"""Phase 8 of ``chip_smoke.py``: the serving extras."""

import gc
import json
import os
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from smoke.cl import drive_cl, record_answers, tiny_cl_config, tiny_cl_data
from smoke.harness import (BEAM, CL_IMAGES, CL_ITEMS, CL_LOSS_RTOL, CL_M_SIZE,
                           CL_TASKS, CL_TINY, CL_TINY_BATCH, EVAL_BATCH, HERE,
                           TRAIN_BATCH, _events_ms, _launches_per_step, fail,
                           log)
from smoke.steps import tiny_eval_inputs
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.cli.serve_http import (make_http_server,
                                            serve_forever_in_thread)
from vqacl_tpu_torch.data import device_cache as DC
from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.data.features import MemoryFeatureStore
from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore, write_pack
from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.convert import to_device
from vqacl_tpu_torch.models.generate import beam_search, greedy_decode
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
from vqacl_tpu_torch.train.optim import make_transform
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_eval_step, make_train_step
from vqacl_tpu_torch.utils.config import Config

# beams' timed eval steps, images of the device cache (t5-base rows, 36 x
# 2048), HTTP clients x requests each, images in the feature pack
BEAM_STEPS = 3
CACHE_IMAGES = 4096
HTTP_CLIENTS, HTTP_PER_CLIENT = 16, 3
PACK_IMAGES = 256
# int8: |q*s - x| <= s/2 plus the f32 rounding of x/s and of q*s, each at
# most 127 * 2^-24 * s
INT8_SLACK = 2e-5
# the cached train step against the host path's, from one state at
# dropout 0 (the same bf16 features reach the encoder), relative
CACHED_LOSS_RTOL = 1e-6
# beam (length penalty 0) vs greedy: teacher-forced f32 sum log-probs of
# the two sequences; only the incremental and teacher-forced sums differ
BEAM_LOGP_TOL = 1e-3


def _tokens_ok(tok, m, rows):
    """int32 tokens [rows, T] inside the vocabulary, pad after each EOS."""
    if tok.shape != (rows, m.gen_max_length - 1) or tok.dtype != np.int32 \
            or tok.min() < 0 or tok.max() >= m.vocab_size:
        return False
    for row in tok:
        hit = np.flatnonzero(row == m.eos_token_id)
        if hit.size and (row[hit[0] + 1:] != m.pad_token_id).any():
            return False
    return True


def serving_extras(ctx):
    """The serving extras at t5-base. ``make_eval_step`` with beam search
    (``BEAM`` beams, eval batch 100, 500 decoder rows, bf16; 12 K1 launches
    per step, CUDA-event times beside greedy's, the kernel launches per
    decode step from ``torch.profiler``), each row's beam sum log-prob
    (length penalty 0) at least greedy's in f32, and a tiny f32 config's
    beam (3, 5), ``max_length`` and ``early_stop=False`` tokens on the card
    equal to the CPU's. A ``DeviceFeatureCache`` over ``CACHE_IMAGES``
    random images (36 × 2048): the bf16 table equal bit for bit to the
    features rounded to bf16, the int8 table within half a row's scale, slot
    −1 and out-of-range slots zero; the cached bf16 eval step's tokens equal
    to the host path's on the same items, the cached train step's loss
    (batch 80, dropout 0) equal to the host path's within
    ``CACHED_LOSS_RTOL``, the host→device bytes per batch of both. An ER run
    of phase 7's loop with ``data.device_cache`` (bf16), then the same
    without the cache, each one's launches against its steps and batches,
    the first step's loss of the two within ``CACHED_LOSS_RTOL``; a tiny f32
    run with an int8 cache on the card against the CPU.
    ``cli/serve_http.py`` on 127.0.0.1, port 0, over
    ``VQAServer(VQAPredictor(num_beams=BEAM, device_cache=…))``:
    ``HTTP_CLIENTS`` concurrent clients × ``HTTP_PER_CLIENT`` requests and
    one batched request answer as ``predictor.answer``; ``/healthz``,
    ``/stats``, ``/metrics``. A feature pack of ``PACK_IMAGES`` images
    written under ``build/``: ``PackedFeatureStore`` gives the source back
    and a predictor over it answers as one over the memory store.

    The main-path runs (the beam, cached, HTTP and pack batches and the CL
    runs) are counted."""
    params, proto, tok = ctx.params, ctx.proto, ctx.tok
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = Config()
    m = cfg.model
    L = m.num_layers
    out = {}

    def counted(fn):
        """``fn()`` with its launches counted → (output, (K1, K1′, K2))."""
        res, w = ctx.counted(fn)
        return res, w.k

    # ---- 8a. beam search -------------------------------------------------
    cast = vlt5.cast_params_for_inference(params, bf16)
    pool = SyntheticVQA(EVAL_BATCH, seed=0)
    batch = collate(pool.examples, with_targets=False)["tensors"]
    greedy = make_eval_step(cfg, dtype=bf16, device="cuda")
    beam = make_eval_step(cfg, dtype=bf16, device="cuda", num_beams=BEAM)
    beam(cast, proto, batch)                     # warm-up
    greedy(cast, proto, batch)
    (tok_b, beam_ms), k = counted(
        lambda: _events_ms(lambda: beam(cast, proto, batch), BEAM_STEPS))
    _, greedy_ms = _events_ms(lambda: greedy(cast, proto, batch), BEAM_STEPS)
    # the host's state after phases 1-7: objects the collector tracks and
    # threads alive, and greedy again with every such object frozen
    n_objects, n_threads = len(gc.get_objects()), threading.active_count()
    gc.collect()
    gc.freeze()
    _, frozen_ms = _events_ms(lambda: greedy(cast, proto, batch), BEAM_STEPS)
    gc.unfreeze()
    tok_b = tok_b.cpu().numpy()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    log(f"beam: bs {EVAL_BATCH} x {BEAM} beams bf16 eval_step_ms="
        f"{med(beam_ms):.3f} (all {', '.join(f'{t:.3f}' for t in beam_ms)}; "
        f"CUDA events) vs greedy {med(greedy_ms):.3f} (all "
        f"{', '.join(f'{t:.3f}' for t in greedy_ms)}; phase 3, host clock: "
        f"{ctx.eval_step_ms:.3f}); launches over {BEAM_STEPS} steps: "
        f"K1={k[0]} K1'={k[1]} K2={k[2]}")
    log(f"host state: {n_objects} objects tracked by gc, {n_threads} threads "
        f"alive; greedy with them frozen {med(frozen_ms):.3f} ms (all "
        f"{', '.join(f'{t:.3f}' for t in frozen_ms)})")
    if k != (L * BEAM_STEPS, 0, 0):
        fail(f"beam eval steps launched K1/K1'/K2 {k}, expected "
             f"{L * BEAM_STEPS}/0/0")
    if not _tokens_ok(tok_b, m, EVAL_BATCH):
        fail(f"beam tokens {tok_b.dtype} {tok_b.shape} out of range or not "
             f"pad after EOS")

    dev_batch = {k_: torch.from_numpy(batch[k_]).cuda()
                 for k_ in ("input_ids", "vis_feats", "boxes")}
    with torch.inference_mode():
        hidden, mask = vlt5.encode(cast, m, **dev_batch, dtype=bf16)
        hidden, mask, _, _ = vlt5.augment(m, hidden, mask, proto)
        lb, beam_steps = _launches_per_step(
            lambda: beam_search(cast, m, hidden, mask, num_beams=BEAM,
                                dtype=bf16), "aten::log_softmax")
        lg, greedy_steps = _launches_per_step(
            lambda: greedy_decode(cast, m, hidden, mask, dtype=bf16),
            "aten::argmax")
    per_beam = lb / max(beam_steps, 1)
    per_greedy = lg / max(greedy_steps, 1)
    log(f"beam: {lb} device launches over {beam_steps} decode steps "
        f"({per_beam:.1f} per step, set-up included); greedy {lg} over "
        f"{greedy_steps} ({per_greedy:.1f} per step) (torch.profiler)")

    # each row's beam sum log-prob (length penalty 0) >= greedy's, in f32
    with torch.inference_mode():
        hidden, mask = vlt5.encode(params, m, **dev_batch, dtype=f32)
        hidden, mask, _, _ = vlt5.augment(m, hidden, mask, proto)
        g_tok = greedy_decode(params, m, hidden, mask, dtype=f32,
                              early_stop=False)
        b_tok = beam_search(params, m, hidden, mask, num_beams=BEAM,
                            length_penalty=0.0, dtype=f32)

        def seq_logp(tokens):
            logits = vlt5.decode_train(params, m, hidden, mask, tokens,
                                       dtype=f32)
            lp = torch.log_softmax(logits, -1).gather(
                -1, tokens.long()[..., None])[..., 0]
            eos = (tokens == m.eos_token_id).int()
            # positions up to and including the first EOS
            upto = (torch.cumsum(eos, 1) - eos) == 0
            return (lp * upto).sum(1)

        gap = (seq_logp(b_tok) - seq_logp(g_tok)).cpu().numpy()
    log(f"beam vs greedy (f32, length penalty 0): min(beam - greedy sum "
        f"log-prob) {gap.min():.4e} (tol -{BEAM_LOGP_TOL:g}), rows beam "
        f"higher {int((gap > BEAM_LOGP_TOL).sum())}/{EVAL_BATCH}, rows "
        f"equal {int((b_tok == g_tok).all(1).sum())}")
    if not gap.min() >= -BEAM_LOGP_TOL:
        fail("a beam hypothesis scores below greedy's")
    out["beam"] = {"eval_step_ms": beam_ms, "greedy_eval_step_ms": greedy_ms,
                   "greedy_gc_frozen_ms": frozen_ms,
                   "gc_objects": n_objects, "threads": n_threads,
                   "launches_per_decode_step": per_beam,
                   "greedy_launches_per_decode_step": per_greedy,
                   "decode_steps": [beam_steps, greedy_steps],
                   "min_logp_gap": float(gap.min())}

    # a tiny f32 config: card tokens == the CPU plain path's
    tiny, tp_cpu, tproto, tb = tiny_eval_inputs()
    tm = tiny.model
    tp_gpu, tproto_gpu = to_device(tp_cpu, "cuda"), tproto.to("cuda")
    same = {}
    for kw in ({"num_beams": 3}, {"num_beams": 5},
               {"num_beams": 3, "max_length": 5}, {"max_length": 4}):
        a = make_eval_step(tiny, dtype=f32, device="cpu", **kw)(
            tp_cpu, tproto, tb).numpy()
        b = make_eval_step(tiny, dtype=f32, device="cuda", **kw)(
            tp_gpu, tproto_gpu, tb).cpu().numpy()
        same[json.dumps(kw)] = bool((a == b).all())
    with torch.inference_mode():
        enc = {}
        for dev, p_, pr in (("cpu", tp_cpu, tproto),
                            ("cuda", tp_gpu, tproto_gpu)):
            h, mk = vlt5.encode(p_, tm, **{k_: torch.from_numpy(tb[k_]).to(dev)
                                           for k_ in ("input_ids", "vis_feats",
                                                      "boxes")}, dtype=f32)
            h, mk, _, _ = vlt5.augment(tm, h, mk, pr)
            enc[dev] = greedy_decode(p_, tm, h, mk, max_length=5, dtype=f32,
                                     early_stop=False).cpu().numpy()
    same['{"early_stop": false, "max_length": 5}'] = bool(
        (enc["cpu"] == enc["cuda"]).all())
    log(f"beam/greedy options, tiny f32 card == CPU: {json.dumps(same)}")
    if not all(same.values()):
        fail("tiny f32 decoding options differ between the card and the CPU")
    out["tiny_card_equals_cpu"] = same
    del hidden, mask, g_tok, b_tok
    torch.cuda.empty_cache()

    # ---- 8b. the device feature cache ------------------------------------
    N = CACHE_IMAGES
    g = torch.Generator(device="cuda").manual_seed(8)
    feats_dev = torch.randn((N, m.n_boxes, m.feat_dim), generator=g,
                            device="cuda")
    boxes_dev = torch.rand((N, m.n_boxes, 4), generator=g, device="cuda")
    host_f, host_b = feats_dev.cpu().numpy(), boxes_dev.cpu().numpy()
    ids = [f"img{i}" for i in range(N)]
    store = MemoryFeatureStore({img: (host_f[i], host_b[i])
                                for i, img in enumerate(ids)})
    caches = {}
    for name in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        caches[name] = DC.DeviceFeatureCache.from_store(
            store, ids, device="cuda", feat_dtype=DC.DTYPES[name])
        torch.cuda.synchronize()
        log(f"device cache {name}: {N} images x {m.n_boxes} x {m.feat_dim}, "
            f"{caches[name][0].nbytes / 1e6:.1f} MB on the card, built in "
            f"{time.perf_counter() - t0:.3f} s")
    cache, slot_of = caches["bfloat16"]
    cache8 = caches["int8"][0]
    bits_equal = torch.equal(cache.feats.view(torch.int16),
                             feats_dev.to(bf16).view(torch.int16)) \
        and torch.equal(cache.boxes, boxes_dev)
    probe = np.asarray([5, -1, N - 1, N, 0, 10 * N], np.int32)
    zeros_ok = True
    for c in (cache, cache8):
        f_, b_ = c.lookup(probe)
        zeros_ok &= not (f_[[1, 3, 5]].any() or b_[[1, 3, 5]].any())
        zeros_ok &= torch.equal(b_[[0, 2, 4]], boxes_dev[[5, N - 1, 0]])
    f_, _ = cache.lookup(probe)
    bits_equal &= torch.equal(f_[[0, 2, 4]],
                              feats_dev[[5, N - 1, 0]].to(bf16).float())
    worst, int8_ok = 0.0, True
    for s0 in range(0, N, 512):
        sc = cache8.scales[s0:s0 + 512, :, None]
        err = (cache8.feats[s0:s0 + 512].float() * sc
               - feats_dev[s0:s0 + 512]).abs()
        worst = max(worst, float((err / sc).max()))
        int8_ok &= bool((err <= sc * (0.5 + INT8_SLACK)).all())
    log(f"device cache: bf16 table == features rounded to bf16, bit for bit: "
        f"{bits_equal}; int8 max |error| / row scale {worst:.6f} (bound "
        f"{0.5 + INT8_SLACK:g}); slot -1 and out of range give zeros: "
        f"{zeros_ok}")
    if not (bits_equal and int8_ok and zeros_ok):
        fail("the device cache's tables or lookups are wrong")
    del cache8, caches
    torch.cuda.empty_cache()

    # the cached bf16 eval step == the host path on the same items
    slots = (np.arange(EVAL_BATCH) * (N // EVAL_BATCH) + 7).astype(np.int32)
    host_eval = {"input_ids": batch["input_ids"], "vis_feats": host_f[slots],
                 "boxes": host_b[slots]}
    slot_eval = {"input_ids": batch["input_ids"], "slots": slots}
    cached_ev = DC.make_cached_eval_step(cfg, cache, dtype=bf16,
                                         device="cuda")
    tok_c, kc = counted(lambda: cached_ev(cast, proto, slot_eval))
    tok_h = greedy(cast, proto, host_eval)
    eval_equal = torch.equal(tok_c, tok_h)

    # the cached train step == the host path's, from one state
    tcfg = Config()
    tcfg.model.dropout_rate = 0.0
    tx = make_transform(tcfg.train)
    tbatch = next(SyntheticVQA(TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    tslots = np.random.default_rng(3).choice(N, TRAIN_BATCH,
                                             replace=False).astype(np.int32)
    host_train = dict(tbatch, vis_feats=host_f[tslots], boxes=host_b[tslots])
    slot_train = {k_: v for k_, v in tbatch.items()
                  if k_ not in ("vis_feats", "boxes")}
    slot_train["slots"] = tslots
    proto0 = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                               device="cuda")
    cstep = DC.make_cached_train_step(tcfg, cache, dtype=bf16, device="cuda")
    hstep = make_train_step(tcfg, dtype=bf16, device="cuda")
    (_, mc), kt = counted(lambda: cstep(
        TrainState.create(params, tx, proto0, seed=1), slot_train))
    _, mh = hstep(TrainState.create(params, tx, proto0, seed=1), host_train)
    loss_c, loss_h = float(mc["loss"]), float(mh["loss"])
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    nbytes = lambda b: sum(np.asarray(v).nbytes for v in b.values())
    train_keys = ("input_ids", "target_ids", "scores", "ques_labels",
                  "cate_labels")
    h2d = {"eval_host": nbytes(host_eval), "eval_cached": nbytes(slot_eval),
           "train_host": nbytes({k_: host_train[k_] for k_ in
                                 train_keys + ("vis_feats", "boxes")}),
           "train_cached": nbytes({k_: slot_train[k_] for k_ in
                                   train_keys + ("slots",)})}
    log(f"device cache: cached bf16 eval tokens == host path: {eval_equal} "
        f"(K1={kc[0]}); cached train step loss {loss_c!r} vs host {loss_h!r}, "
        f"rel {loss_rel:.3e} (tol {CACHED_LOSS_RTOL:g}; K1'={kt[1]} "
        f"K2={kt[2]}); host->device bytes per batch: eval {h2d['eval_host']} "
        f"-> {h2d['eval_cached']}, train {h2d['train_host']} -> "
        f"{h2d['train_cached']}")
    if not eval_equal or kc != (L, 0, 0):
        fail("the cached eval step differs from the host path")
    if not loss_rel <= CACHED_LOSS_RTOL or kt != (0, L, L) \
            or not np.isfinite(loss_c):
        fail("the cached train step differs from the host path")
    out["cache"] = {"eval_tokens_equal": eval_equal, "train_loss_rel":
                    loss_rel, "int8_worst_err_over_scale": worst,
                    "h2d_bytes": h2d, "table_bytes": cache.nbytes}
    del mc, mh
    torch.cuda.empty_cache()

    # ---- 8c. the CL loop with the device cache ---------------------------
    n_tr, n_va, n_te = CL_ITEMS
    ccfg = Config()
    ccfg.train.batch_size = TRAIN_BATCH
    ccfg.train.valid_batch_size = EVAL_BATCH
    ccfg.train.epochs = 1
    ccfg.train.memory = True
    ccfg.train.m_size = CL_M_SIZE
    cm = ccfg.model
    er = {}
    # the cached run, then the host path's beside it in the same phase
    for name, cached in (("cl_er_cached", True), ("cl_er_host", False)):
        ccfg.data.device_cache = cached
        cdata = SyntheticDataModule(
            tok, tasks=CL_TASKS, n_train_per_task=n_tr, n_val_per_task=n_va,
            n_test_per_task=n_te, feat_dim=cm.feat_dim, n_boxes=cm.n_boxes,
            n_images=CL_IMAGES, seed=0)
        with tempfile.TemporaryDirectory() as outdir:
            ccfg.output = outdir
            t0 = time.time()
            trainer = VQACLTrainer(ccfg, cdata, tok, verbose=False,
                                   device="cuda", init_params=params,
                                   dtype=bf16)
            log(f"{name}: phase 7's ER run, data.device_cache={cached}"
                + (f" (bf16, {trainer._cache.n} images, "
                   f"{trainer._cache.nbytes / 1e6:.1f} MB)" if cached else "")
                + f"; set-up {time.time() - t0:.1f} s")
            er[name] = drive_cl(trainer, name, ctx, cm.num_layers)
        out[name] = {k_: v for k_, v in er[name].items() if k_ != "metrics"}
        del trainer
        torch.cuda.empty_cache()
    lc, lh = er["cl_er_cached"]["losses"], er["cl_er_host"]["losses"]
    er_rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
    er_same = er["cl_er_cached"]["result_matrix"] == \
        er["cl_er_host"]["result_matrix"]
    log(f"cl_er cached vs host: {len(lc)} / {len(lh)} steps, first loss rel "
        f"{er_rel[0]:.3e} (tol {CACHED_LOSS_RTOL:g}), max rel over the run "
        f"{max(er_rel):.3e}; result matrices equal {er_same}; wall "
        f"{er['cl_er_cached']['wall_s']:.3f} vs "
        f"{er['cl_er_host']['wall_s']:.3f} s; median step "
        f"{er['cl_er_cached']['train_step_ms_median']:.3f} vs "
        f"{er['cl_er_host']['train_step_ms_median']:.3f} ms")
    if len(lc) != len(lh) or not er_rel[0] <= CACHED_LOSS_RTOL:
        fail("the cached ER run's first step differs from the host path's")

    # a tiny f32 run with an int8 cache on the card == the same on the CPU
    tcl = tiny_cl_config(1e-3, CL_TINY_BATCH)
    tcl.data.device_cache = True
    tcl.data.device_cache_dtype = "int8"
    tinit = vlt5.init_vlt5_params(4, tcl.model, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        tdata = tiny_cl_data(tok, tcl.model, CL_TINY)
        with tempfile.TemporaryDirectory() as outdir:
            tcl.output = outdir
            trainer = VQACLTrainer(tcl, tdata, tok, verbose=False, device=dev,
                                   init_params=tinit, dtype=f32)
            answers = record_answers(trainer)
            r = drive_cl(trainer, f"cl_tiny_int8_cache_{dev}",
                         ctx if dev == "cuda" else None,
                         tcl.model.num_layers)
            r["answers"] = answers
            runs[dev] = r
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                        cpu_run["losses"]))
    same = {k_: card_run[k_] == cpu_run[k_]
            for k_ in ("result_matrix", "answers")}
    log(f"cl tiny f32 int8 cache, card vs CPU: {len(card_run['losses'])} / "
        f"{len(cpu_run['losses'])} steps, loss max rel err {tiny_err:.3e} "
        f"(tol {CL_LOSS_RTOL:g}); equal: {json.dumps(same)}")
    if len(card_run["losses"]) != len(cpu_run["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same.values()):
        fail("the tiny f32 int8-cache CL run on the card differs from the CPU")
    out["cl_tiny_int8_cache"] = {"loss_rel_err": tiny_err, "equal": same,
                                 "launches": card_run["launches"]}

    # ---- 8d. the HTTP front end ------------------------------------------
    pred = VQAPredictor(cfg, params, proto, tok, None, batch_size=16,
                        num_beams=BEAM, dtype=bf16, device="cuda",
                        device_cache=cache, slot_of=slot_of)
    n_req = HTTP_CLIENTS * HTTP_PER_CLIENT
    qs = [f"what is in image {i}?" for i in range(n_req + 8)]
    imgs = [ids[(37 * i) % N] for i in range(n_req + 8)]
    want = pred.answer(qs, imgs)
    answers, errors = [None] * (n_req + 8), []

    def post(base, payload):
        req = urllib.request.Request(
            base + "/v1/vqa", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.load(r)

    def get(base, path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read().decode()

    with VQAServer(pred, max_wait_ms=5.0) as srv:
        httpd = make_http_server(srv, host="127.0.0.1", port=0)
        thread = serve_forever_in_thread(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            post(base, {"question": "warm up?", "img_id": ids[0]})
            warm = srv.stats()
            start = threading.Barrier(HTTP_CLIENTS)

            def client(c):
                start.wait()
                for r in range(HTTP_PER_CLIENT):
                    i = c * HTTP_PER_CLIENT + r
                    try:
                        answers[i] = post(base, {"question": qs[i],
                                                 "img_id": imgs[i]})["answer"]
                    except Exception as e:   # recorded, fails the run
                        errors.append(repr(e))

            def drive():
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(HTTP_CLIENTS)]
                for t in threads:
                    t.start()
                answers[n_req:] = post(base, {"items": [
                    {"question": q, "img_id": i}
                    for q, i in zip(qs[n_req:], imgs[n_req:])]})["answers"]
                for t in threads:
                    t.join(timeout=600)
                return any(t.is_alive() for t in threads)

            t0 = time.perf_counter()
            stuck, kh = counted(drive)
            wall = time.perf_counter() - t0
            health = json.loads(get(base, "/healthz"))
            st = json.loads(get(base, "/stats"))
            metrics = get(base, "/metrics")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
    batches = st["batches"] - warm["batches"]
    log(f"http: {n_req} POST /v1/vqa from {HTTP_CLIENTS} clients x "
        f"{HTTP_PER_CLIENT} + one of 8 items in {wall:.3f} s over {batches} "
        f"batches of <= 16 ({BEAM} beams, device cache); latency p50 "
        f"{st['latency_p50_ms']} ms p99 {st['latency_p99_ms']} ms; stats "
        f"{json.dumps(st)}; K1={kh[0]}; answers == predictor.answer: "
        f"{answers == want}")
    if stuck or errors or st["errors"] or health != {"ok": True}:
        fail(f"http serving errors: {errors[:3]} stats {st}")
    if answers != want:
        fail("answers over HTTP differ from predictor.answer")
    if kh != (L * batches, 0, 0):
        fail(f"http serving launched K1/K1'/K2 {kh} over {batches} batches")
    if f"vqa_requests {st['requests']}" not in metrics \
            or "# TYPE vqa_requests counter" not in metrics:
        fail(f"/metrics: {metrics[:300]}")
    out["http"] = {"stats": st, "wall_s": wall, "batches": batches}
    del pred
    torch.cuda.empty_cache()

    # ---- 8e. the packed feature store ------------------------------------
    pack_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(pack_dir, exist_ok=True)
    path = os.path.join(pack_dir, "phase8.vfpack")
    n = PACK_IMAGES
    t0 = time.perf_counter()
    # boxes are already in [0,1]: a 1 x 1 image keeps them as they are
    write_pack(path, ((ids[i], host_f[i], host_b[i], 1.0, 1.0)
                      for i in range(n)),
               n_boxes=m.n_boxes, feat_dim=m.feat_dim)
    write_s = time.perf_counter() - t0
    packed = PackedFeatureStore(path)
    try:
        pf, pb = packed.get_batch(ids[:n])
        pack_equal = bool(np.array_equal(pf, host_f[:n])
                          and np.array_equal(pb, host_b[:n]))
        qs_p = [f"what is in image {i}?" for i in range(32)]
        imgs_p = [ids[(5 * i) % n] for i in range(32)]
        by_pack = VQAPredictor(cfg, params, proto, tok, packed,
                               batch_size=16, dtype=bf16, device="cuda")
        by_mem = VQAPredictor(cfg, params, proto, tok, store, batch_size=16,
                              dtype=bf16, device="cuda")
        a_pack, kp = counted(lambda: by_pack.answer(qs_p, imgs_p))
        a_mem = by_mem.answer(qs_p, imgs_p)
    finally:
        packed.close()
        os.remove(path)
    log(f"pack: {n} images, {os.path.basename(path)} written in "
        f"{write_s:.3f} s; get_batch == source: {pack_equal}; predictor over "
        f"the pack answers as over the memory store: {a_pack == a_mem} "
        f"(K1={kp[0]})")
    if not pack_equal or a_pack != a_mem or kp != (L * 2, 0, 0):
        fail("the packed store differs from its source")
    out["pack"] = {"images": n, "write_s": write_s}
    k = ctx.launched().k
    log(f"phase 8 launches K1={k[0]} K1'={k[1]} K2={k[2]}")
    return {"serving_extras": out, "serving_extras_launches": list(k)}
