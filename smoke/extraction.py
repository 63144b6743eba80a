"""Phase 11 of ``chip_smoke.py``: region and video extraction."""

import json
import os
import shutil
import time

import numpy as np
import torch

from smoke.harness import HERE, _events_ms, fail, log, since
from vqacl_tpu_torch.cli import extract_features as ef
from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
from vqacl_tpu_torch.models.convert import to_device
from vqacl_tpu_torch.ops import launches, nms
from vqacl_tpu_torch.serve import VQAPredictor
from vqacl_tpu_torch.utils.config import Config
from vqacl_tpu_torch.vision import frcnn, resnet, resnext3d, rpn, video

# COCO image sizes (h, w) that reach three pad buckets; four sizes of one
# bucket for the batch; the f32 card-vs-CPU image (padded size, true
# size) and its proposals; videos of frames at the appearance side, the
# 3D backbone's clip side
P11_IMAGES = ((480, 640), (640, 480), (427, 640), (375, 500))
P11_BATCH_IMAGES = ((480, 640), (375, 500), (600, 800), (450, 600))
P11_F32_IMAGE = ((256, 320), (224, 300))
P11_F32_PROPOSALS = 64
P11_VIDEOS = 2
P11_VIDEO_FRAMES = 48
P11_VIDEO_SIDE = 224
P11_MOTION_SIDE = 112
# f32 on the card against the CPU (and a batch against single images):
# max|card - cpu| <= P11_F32_RTOL * max|cpu| per stage output, the same
# convolutions summed in other orders through 34 residual blocks
P11_F32_RTOL = 1e-4
# scores count as well separated when sorted neighbours differ by more
# than this, relative: then the whole pipeline's selections must agree
P11_SEPARATED = 1e-3
P11_DIR = os.path.join(HERE, "build", "chip_smoke", "phase11")


def p11_image(rng, h, w):
    """A synthetic BGR uint8 image with structure: 8-px blocks of random
    colour, a few solid rectangles, pixel noise."""
    img = np.repeat(np.repeat(rng.integers(0, 256, (-(-h // 8), -(-w // 8),
                                                    3)), 8, 0), 8, 1)[:h, :w]
    img = img.astype(np.int64)
    for _ in range(6):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + rng.integers(8, h // 2), x:x + rng.integers(8, w // 2)] = \
            rng.integers(0, 256, 3)
    img += rng.integers(-8, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def p11_detector(frcnn, resnet, device):
    """``init_frcnn(0)`` with each bottleneck's last folded-BN scale x0.2,
    the RPN's deltas x0.01 and the class head x0.02. The plain random
    init doubles the activations' variance in every residual block (C4
    near 1e7 after 26 blocks): every decoded box then leaves the image
    and no proposal is valid. Damped, C4 stays in the hundreds, proposals
    lie on the image and class scores spread over (1/1601, 0.6), as a
    trained detector's do."""
    det = frcnn.init_frcnn(0, device)
    for name, *_ in resnet.R101_STAGES + [resnet.RES5]:
        for blk in det["backbone"][name].values():
            blk["conv3"]["scale"] = blk["conv3"]["scale"] * 0.2
    det["rpn"]["delta_w"] = det["rpn"]["delta_w"] * 0.01
    det["heads"]["cls_w"] = det["heads"]["cls_w"] * 0.02
    return det


def p11_stages(frcnn, rpn, resnet, nms, det, image, hw, n_props):
    """The detector's stage outputs for one image [H,W,3] (the same
    functions ``_extract_regions_impl`` runs), in f32."""
    with torch.inference_mode():
        feat = resnet.backbone_c4(det["backbone"], frcnn._nchw(image[None]))
        logits, deltas = rpn.rpn_head(det["rpn"], feat)
        anchors = rpn.anchor_grid(feat.shape[2], feat.shape[3], feat.device)
        boxes = rpn.decode_deltas(anchors, deltas[0])
        props, pv = rpn.select_proposals(logits[0], boxes, hw,
                                         post_nms_topk=n_props)
        pooled = frcnn._pooled(det, feat, props)
        h = det["heads"]
        probs = torch.softmax(pooled @ h["cls_w"] + h["cls_b"], dim=-1)
        conf = torch.where(pv, probs[:, 1:].max(dim=1).values,
                           torch.tensor(-1.0, device=probs.device))
        idx, valid = nms.max_nms_fixed(props, conf, n_keep=36)
    return {"feat": feat, "logits": logits[0], "deltas": deltas[0],
            "boxes": boxes, "props": props, "prop_valid": pv,
            "pooled": pooled, "conf": conf, "idx": idx, "valid": valid}


def _rel_err(a, b):
    """max|a - b| / max|b| (b the reference)."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _min_gap(x):
    """The smallest relative gap between distinct sorted values of x."""
    x = torch.sort(x.float().cpu()).values
    d = x[1:] - x[:-1]
    pos = d > 0
    if not bool(pos.any()):
        return float("inf")
    return float((d[pos] / x[1:][pos].abs().clamp(min=1e-30)).min())


def extraction(ctx):
    """Region and video extraction at full width from seeded random weights (no
    detector or Kinetics weights are in the repository). ``extract_image``
    (ResNet-101-C4, RPN with N1, RoIAlign, res5 and the heads, the 36-box N1
    sweep) on ``P11_IMAGES`` synthetic BGR images of COCO sizes over three
    pad buckets, at torch's default TF32 flags: per image the CUDA-event ms
    of each stage, records of 36 x 2048 finite features, boxes on the image,
    classes in 1..1600, two N1 launches per image, the peak device memory;
    ``extract_regions_batch`` over four images of one bucket against the
    single-image calls in f32; ``extract_given_boxes`` at 36 boxes; the
    CLI's record generator (``cli/extract_features.py``) into a ``--pack``
    under ``build/`` read back bit-equal by ``PackedFeatureStore``, and a
    t5-base ``VQAPredictor`` over that pack answering one batch through K1
    (12 launches); in f32 (TF32 off for this check only), each detector
    stage on the card against the CPU on one small padded image, N1's
    ``select_proposals`` and ``max_nms_fixed`` bit-equal on the CPU's
    inputs; ``extract_videos`` on ``P11_VIDEOS`` ``.npy`` videos of 224²
    frames with the RGB-difference motion half and with the 3D-ResNeXt-101
    (16 clips x 16 x 112²): feat [16, 4096], finite, ms per video, peak
    memory.

    Phase 3's t5-base answers over the extracted pack. Counted: N1 in the
    extraction runs up to the CLI's pack, K1 in the answers over it."""
    cudnn, cuda_mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cuda_mm.allow_tf32)
    out = {}
    shutil.rmtree(P11_DIR, ignore_errors=True)
    os.makedirs(P11_DIR)
    try:
        # the timed runs at torch's defaults: TF32 in cuDNN's convolutions,
        # full f32 in matmuls
        cudnn.allow_tf32, cuda_mm.allow_tf32 = True, False
        log(f"phase 11: timed runs at torch's default TF32 flags (cudnn "
            f"{cudnn.allow_tf32}, matmul {cuda_mm.allow_tf32})")
        t0 = time.time()
        det = p11_detector(frcnn, resnet, "cuda")
        rng = np.random.default_rng(11)
        imgs = [p11_image(rng, h, w) for h, w in P11_IMAGES]
        log(f"phase 11: detector init (seed 0, damped) in "
            f"{time.time() - t0:.1f} s")
        n1_start = launches.read()

        # ---- 11a. region extraction, one image at a time ----------------
        for img in imgs:            # warm-up: each bucket's first call
            frcnn.extract_image(det, img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()      # earlier phases' tensors
        stages, buckets, walls, recs, resize_ms = [], [], [], [], []
        before = launches.read()
        for img in imgs:
            evs = []

            def mark(stage, evs=evs):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                evs.append((stage, e))

            t1 = time.perf_counter()
            rec = frcnn.extract_image(det, img, mark=mark)
            walls.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(evs, evs[1:])})
            t1 = time.perf_counter()          # the host's share of the wall
            resized, _ = frcnn.resize_shortest_edge(img.astype(np.float32))
            buckets.append(frcnn.pad_to_bucket(resized).shape[:2])
            resize_ms.append((time.perf_counter() - t1) * 1e3)
            recs.append(rec)
            f, b = rec["features"], rec["boxes"]
            h, w = img.shape[:2]
            ok = (f.shape == (36, 2048) and bool(np.isfinite(f).all())
                  and b.shape == (36, 4) and b.min() >= 0
                  and b[:, (0, 2)].max() <= w and b[:, (1, 3)].max() <= h
                  and rec["obj_id"].min() >= 1
                  and rec["obj_id"].max() <= frcnn.N_CLASSES)
            if not ok:
                fail(f"extract_image {img.shape}: features {f.shape} finite "
                     f"{np.isfinite(f).all()}, boxes [{b.min()}, {b.max()}], "
                     f"obj_id [{rec['obj_id'].min()}, {rec['obj_id'].max()}]")
        n1_per_image = since(before).of(nms.greedy_nms) / len(imgs)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        for (h, w), bk, st, wall, rz in zip(P11_IMAGES, buckets, stages,
                                            walls, resize_ms):
            log(f"extract_image {h}x{w} -> bucket {bk[0]}x{bk[1]}: stage ms "
                f"(CUDA events, launch gaps included) "
                + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
                + f"; wall {wall:.3f} ms, of which the host's resize and "
                f"pad {rz:.3f} ms")
        log(f"extract_image: N1 launches {n1_per_image:g} per image "
            f"(expected 2), peak device memory {peak:.1f} MiB above the "
            f"{held / 2 ** 20:.1f} MiB held before (weights included), "
            f"buckets {sorted(set(buckets))}")
        if n1_per_image != 2 or len(set(buckets)) < 2:
            fail("extract_image: N1 launches or pad buckets wrong")
        out["images"] = [{"hw": list(hw), "bucket": list(bk), "stage_ms": st,
                          "wall_ms": wall, "resize_ms": rz}
                         for hw, bk, st, wall, rz
                         in zip(P11_IMAGES, buckets, stages, walls,
                                resize_ms)]
        out["n1_per_image"] = n1_per_image
        out["peak_mib"] = peak

        # ---- 11b. given boxes --------------------------------------------
        resized, scale = frcnn.resize_shortest_edge(
            imgs[0].astype(np.float32))
        gimg = torch.from_numpy(frcnn.pad_to_bucket(resized)).cuda()
        gboxes = torch.from_numpy(recs[0]["boxes"] * scale).cuda()
        (gf, gi, gc), g_ms = _events_ms(
            lambda: frcnn.extract_given_boxes(det, gimg, gboxes), 3)
        if gf.shape != (36, 2048) or not bool(torch.isfinite(gf).all()) \
                or int(gi.min()) < 1 or int(gi.max()) > frcnn.N_CLASSES:
            fail("extract_given_boxes: bad output")
        log(f"extract_given_boxes: 36 boxes, ms {[round(x, 3) for x in g_ms]}")
        out["given_boxes_ms"] = g_ms

        # ---- 11c. the CLI's record generator into a pack, then answers -----
        pack = os.path.join(P11_DIR, "regions.vfpack")
        args = ef.parse_args(["--images", "-", "--out", pack, "--pack"])
        got = []

        def tee(records):
            for r in records:
                got.append(r)
                yield r

        t1 = time.perf_counter()
        ef.write(args, tee(ef.records(
            det, ((f"coco_{i}", img, None) for i, img in enumerate(imgs)),
            args.n_boxes, "cuda")))
        cli_s = time.perf_counter() - t1
        store = PackedFeatureStore(pack)
        try:
            equal = True
            for img_id, rec in got:
                f, b = store.get(img_id)
                inv = np.float32(1.0) / np.asarray(
                    [rec["img_w"], rec["img_h"]] * 2, np.float32)
                want_b = np.clip(rec["boxes"] * inv, 0.0, 1.0)
                equal &= bool(np.array_equal(f, rec["features"])
                              and np.array_equal(b, want_b))
            cfg = Config()
            qs = [f"what is in the {w} of the picture?" for w in
                  ("middle", "left", "right", "top")] * len(got)
            ids = [img_id for img_id, _ in got for _ in range(4)]
            pred = VQAPredictor(cfg, ctx.params, ctx.proto, ctx.tok, store,
                                batch_size=len(qs), dtype=torch.bfloat16,
                                device="cuda")
            answers, w = ctx.counted(lambda: pred.answer(qs, ids))
            k1 = w.k
            del pred
        finally:
            store.close()
        log(f"cli pack: {len(got)} records via ef.records/ef.write in "
            f"{cli_s:.3f} s; PackedFeatureStore == records (features and "
            f"normalized boxes) bit for bit: {equal}; t5-base VQAPredictor "
            f"over the pack: {len(answers)} answers in one batch, launches "
            f"K1={k1[0]} K1'={k1[1]} K2={k1[2]}; first {answers[:4]}")
        if not equal or k1 != (cfg.model.num_layers, 0, 0) \
                or len(answers) != len(qs) \
                or not all(isinstance(a, str) for a in answers):
            fail("the extracted pack does not reach the answer path")
        out["cli"] = {"records": len(got), "write_s": cli_s,
                      "answers": len(answers), "k1": k1[0]}
        n1_main = since(n1_start)
        ctx.count(n1_main, (nms.greedy_nms,))

        # ---- 11a'/11d. f32: a batch against single images, the card
        # against the CPU (TF32 off for these comparisons only) ------------
        cudnn.allow_tf32 = False
        log(f"phase 11: f32 comparisons with TF32 off (cudnn "
            f"{cudnn.allow_tf32}, matmul {cuda_mm.allow_tf32}); tolerance "
            f"max|x - ref| <= {P11_F32_RTOL:g} * max|ref|")
        bimgs, bhw = [], []
        for h, w in P11_BATCH_IMAGES:
            r, _ = frcnn.resize_shortest_edge(
                p11_image(rng, h, w).astype(np.float32))
            bimgs.append(frcnn.pad_to_bucket(r))
            bhw.append(r.shape[:2])
        if len({b.shape for b in bimgs}) != 1:
            fail(f"P11_BATCH_IMAGES span buckets {[b.shape for b in bimgs]}")
        bx = torch.from_numpy(np.stack(bimgs)).cuda()
        bh = torch.tensor(bhw, dtype=torch.float32, device="cuda")
        batch = frcnn.extract_regions_batch(det, bx, bh)
        with torch.inference_mode():
            c4_batch = resnet.backbone_c4(det["backbone"], frcnn._nchw(bx))
        c4_err, rows_equal, feat_err = 0.0, [], 0.0
        for i in range(len(bimgs)):
            single = frcnn.extract_regions(det, bx[i], bh[i])
            with torch.inference_mode():
                c4 = resnet.backbone_c4(det["backbone"],
                                        frcnn._nchw(bx[i:i + 1]))
            c4_err = max(c4_err, _rel_err(c4_batch[i:i + 1], c4))
            same = (batch.boxes[i] == single.boxes).all(dim=1) \
                & (batch.obj_id[i] == single.obj_id)
            rows_equal.append(int(same.sum()))
            if bool(same.any()):
                feat_err = max(feat_err, _rel_err(batch.features[i][same],
                                                  single.features[same]))
        log(f"extract_regions_batch: {len(bimgs)} images of bucket "
            f"{bimgs[0].shape[:2]}: C4 max rel err vs single {c4_err:.3e}; "
            f"selected rows equal to the single-image call {rows_equal} of "
            f"36, their features' max rel err {feat_err:.3e}")
        if not (c4_err <= P11_F32_RTOL and feat_err <= P11_F32_RTOL
                and batch.features.shape == (len(bimgs), 36, 2048)
                and bool(torch.isfinite(batch.features).all())):
            fail("extract_regions_batch differs from the single-image calls")
        out["batch"] = {"c4_rel_err": c4_err, "rows_equal": rows_equal,
                        "feat_rel_err": feat_err}

        (ph, pw), (th, tw) = P11_F32_IMAGE
        img = np.zeros((ph, pw, 3), np.float32)
        img[:th, :tw] = p11_image(rng, th, tw)
        hw = np.asarray([th, tw], np.float32)
        det_cpu = to_device(det, "cpu")
        t1 = time.time()
        cpu = p11_stages(frcnn, rpn, resnet, nms, det_cpu,
                         torch.from_numpy(img), torch.from_numpy(hw),
                         P11_F32_PROPOSALS)
        cpu_s = time.time() - t1
        gpu_img, gpu_hw = torch.from_numpy(img).cuda(), torch.from_numpy(
            hw).cuda()
        card = p11_stages(frcnn, rpn, resnet, nms, det, gpu_img, gpu_hw,
                          P11_F32_PROPOSALS)
        cu = lambda k: cpu[k].cuda()                       # noqa: E731
        with torch.inference_mode():
            lg, dl = rpn.rpn_head(det["rpn"], cu("feat"))
            sp, sv = rpn.select_proposals(cu("logits"), cu("boxes"), gpu_hw,
                                          post_nms_topk=P11_F32_PROPOSALS)
            pooled = frcnn._pooled(det, cu("feat"), cu("props"))
            idx, valid = nms.max_nms_fixed(cu("props"), cu("conf"), 36)
        errs = {"c4": _rel_err(card["feat"], cpu["feat"]),
                "rpn_logits": _rel_err(lg[0], cpu["logits"]),
                "rpn_deltas": _rel_err(dl[0], cpu["deltas"]),
                "pooled": _rel_err(pooled, cpu["pooled"])}
        bits = {"select_proposals": bool(
                    torch.equal(sp.cpu(), cpu["props"])
                    and torch.equal(sv.cpu(), cpu["prop_valid"])),
                "max_nms_fixed": bool(
                    torch.equal(idx.cpu(), cpu["idx"])
                    and torch.equal(valid.cpu(), cpu["valid"]))}
        top = cpu["logits"][torch.isfinite(cpu["logits"])]
        gaps = {"rpn_logits": _min_gap(top),
                "conf": _min_gap(cpu["conf"][cpu["prop_valid"]])}
        separated = min(gaps.values()) > P11_SEPARATED
        whole = int((card["props"][card["idx"]].cpu()
                     == cpu["props"][cpu["idx"]]).all(dim=1).sum())
        log(f"f32 card vs CPU, {ph}x{pw} image ({th}x{tw} true), "
            f"{P11_F32_PROPOSALS} proposals (CPU {cpu_s:.1f} s): stage max "
            f"rel err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {P11_F32_RTOL:g}; each stage on the CPU's inputs); "
            f"bit-equal on the CPU's inputs: {json.dumps(bits)}; whole "
            f"pipeline: {whole}/36 selected boxes equal, score gaps "
            f"{json.dumps(gaps)} -> "
            + ("held (well separated)" if separated else
               f"not held: gaps within {P11_SEPARATED:g} of f32 noise"))
        if max(errs.values()) > P11_F32_RTOL or not all(bits.values()) \
                or (separated and whole != 36):
            fail("the detector on the card differs from the CPU in f32")
        out["f32"] = {"rel_err": errs, "bit_equal": bits, "gaps": gaps,
                      "whole_equal": whole, "whole_held": separated}
        del det_cpu, cpu, card
        cudnn.allow_tf32 = True

        # ---- 11e. video: the RGB-difference and the 3D ResNeXt motion ----
        vdir = os.path.join(P11_DIR, "videos")
        os.makedirs(vdir)
        S = P11_VIDEO_SIDE
        for v in range(P11_VIDEOS):
            base = p11_image(rng, S, 2 * S)
            frames = np.stack([np.roll(base, 3 * t, axis=1)[:, :S]
                               for t in range(P11_VIDEO_FRAMES)])
            np.save(os.path.join(vdir, f"video{v}.npy"), frames)
        sources = video.enumerate_video_sources(vdir)
        vid = {}
        mp = resnext3d.init_resnext3d(0, device="cuda")
        for label, kw in (("rgb_diff", {}),
                          ("resnext3d", {"motion_params": mp,
                                         "motion_side": P11_MOTION_SIDE})):
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            ms = []
            tables = {}
            for name, src in sorted(sources.items()):
                t1 = time.perf_counter()
                tables.update(video.extract_videos(det, {name: src}, side=S,
                                                   **kw))
                ms.append((time.perf_counter() - t1) * 1e3)
            peak_v = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            ok = all(t.shape == (16, 4096) and bool(np.isfinite(t).all())
                     for t in tables.values())
            log(f"extract_videos {label}: {len(tables)} videos of "
                f"{P11_VIDEO_FRAMES} x {S}x{S} frames, feat "
                f"{[list(t.shape) for t in tables.values()]} finite {ok}; "
                f"ms per video (host clock, synchronous) "
                f"{[round(x, 3) for x in ms]}; peak {peak_v:.1f} MiB above "
                f"the {held / 2 ** 20:.1f} MiB held before")
            if not ok:
                fail(f"extract_videos {label}: bad features")
            vid[label] = {"ms": ms, "peak_mib": peak_v}
        # one video's motion half by part: reading the clips, PIL's resize
        # to the clip side (host), the 3D backbone (CUDA events)
        src = sorted(sources.values())[0]
        t1 = time.perf_counter()
        clips = video.load_clips(src)
        t2 = time.perf_counter()
        sq = np.stack([video._resize_square(c, P11_MOTION_SIDE)
                       for c in clips])
        t3 = time.perf_counter()
        x = resnext3d.preprocess_clip(sq[..., ::-1])
        fn = video.make_motion_feature_fn(mp)
        _, net_ms = _events_ms(lambda: fn(x), 2)
        parts = {"load_clips_ms": (t2 - t1) * 1e3,
                 "resize_ms": (t3 - t2) * 1e3, "resnext3d_ms": net_ms}
        log(f"extract_videos resnext3d, one video by part: "
            f"{json.dumps(parts)}")
        vid["resnext3d"]["parts"] = parts
        out["video"] = vid
        del mp
    finally:
        cudnn.allow_tf32, cuda_mm.allow_tf32 = saved
        shutil.rmtree(P11_DIR, ignore_errors=True)
    log(f"phase 11: TF32 flags restored (cudnn {cudnn.allow_tf32}, matmul "
        f"{cuda_mm.allow_tf32})")
    log("phase11 " + json.dumps(out))
    del det
    torch.cuda.empty_cache()
    return {"extraction": out, "extraction_launches": list(k1),
            "extraction_n1_launches": n1_main.of(nms.greedy_nms)}
