"""Phase 10 of ``chip_smoke.py``: the training entry points."""

import base64
import csv
import json
import os
import shutil
import time

import numpy as np
import torch

from smoke.cl import drive_cl, record_answers
from smoke.harness import (CL_LOSS_RTOL, CL_M_SIZE, EVAL_BATCH, HERE,
                           TRAIN_BATCH, fail, log, since)
from vqacl_tpu_torch.cl.tasks import ALL_TASKS
from vqacl_tpu_torch.cli import nextqa_train, vqacl_train
from vqacl_tpu_torch.cli.args import parse_config
from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
from vqacl_tpu_torch.data.tsv_convert import tsv_to_pack
from vqacl_tpu_torch.data.vqa_module import VQADataModule
from vqacl_tpu_torch.models import hf_import
from vqacl_tpu_torch.nextqa.data import (NextQADataModule, VideoFeatureStore,
                                         items_from_rows)
from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.train import checkpoint as ckpt

# a reference-format VQA v2 root of all ten tasks (train/val/test items
# per task over a pool of images, features as an LXMERT tsv converted
# into the pack), NExT-QA's two first tasks over tables (items per task,
# videos of 16 x 2048 motion features), the tiny f32 CLI runs' items per
# task and batch; all under the gitignored build/, removed at the end of
# the phase
P10_ITEMS = (200, 20, 20)
P10_IMAGES = 256
NQ_TASKS = ("CW", "TN")
NQ_ITEMS = (400, 100, 100)
NQ_VIDEOS = 256
P10_TINY = (24, 8, 8)
P10_TINY_BATCH = 16
P10_DIR = os.path.join(HERE, "build", "chip_smoke", "phase10")
# NExT-QA answers: words the vendored WordNet taxonomy knows and two it
# does not, so WUPS scores real Wu-Palmer pairs and its coverage shows
NQ_ANSWERS = ("dog", "cat", "man", "woman", "baby", "ball", "car", "bike",
              "table", "chair", "grass", "water", "playing", "eating",
              "walking", "red", "blue")


def write_obj_tsv(path, rows):
    """LXMERT-format tsv (the layout of the public COCO region features,
    ``data/tsv_convert.py::FIELDNAMES``): one image per line, its arrays
    base64-encoded. ``rows``: (img_id, features [n,2048], boxes [n,4] in
    pixels, img_h, img_w)."""
    b64 = lambda a: base64.b64encode(np.ascontiguousarray(a).tobytes()
                                     ).decode()
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        for img_id, feats, boxes, h, w_ in rows:
            n = feats.shape[0]
            w.writerow([img_id, h, w_, b64(np.arange(n, dtype=np.int64)),
                        b64(np.ones(n, np.float32)),
                        b64(np.zeros(n, np.int64)),
                        b64(np.ones(n, np.float32)), n,
                        b64(boxes.astype(np.float32)),
                        b64(feats.astype(np.float32))])


def write_vqa_root(root, tasks, items, n_images, seed=0):
    """A reference-format VQA v2 root (the layout ``VQADataModule``
    reads): ``vqa/Partition_Q/karpathy_{train,val,test}_{task}.json`` with
    ``items`` (train, val, test) questions per task over ``n_images``
    COCO images, ``QuesId_task_map.json``, ``ImgId_cate_map.json``,
    ``vqa/v2_mscoco_val2014_annotations.json`` and the region features
    (36 × 2048) as an LXMERT tsv converted by ``tsv_to_pack`` into
    ``COCO/features/coco_obj36.vfpack`` → the number of images packed."""
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, "COCO", "features")
    os.makedirs(os.path.join(root, "vqa", "Partition_Q"))
    os.makedirs(feat_dir)
    imgs = [f"COCO_val2014_{i:012d}" for i in range(1, n_images + 1)]
    cate = {img: int(rng.integers(0, 80)) for img in imgs}
    words = ("yes", "no", "two", "red", "dog", "table", "man", "car")
    ques_map, anns, qid = {}, [], 1
    for t_idx, task in enumerate(tasks):
        for split, n in zip(("karpathy_train", "karpathy_val",
                             "karpathy_test"), items):
            rows = []
            for _ in range(n):
                img = imgs[int(rng.integers(0, n_images))]
                ans = [words[int(a)] for a in rng.integers(0, len(words), 10)]
                vals, cnt = np.unique(ans, return_counts=True)
                rows.append({
                    "img_id": img, "question_id": qid,
                    "sent": f"what is the {words[cate[img] % 8]} in the "
                            f"picture {qid % 7}?",
                    "label": {str(a): min(1.0, c / 3) for a, c in
                              zip(vals, cnt)},
                    "answers": [{"answer": a} for a in ans],
                    "question_type": "what is", "answer_type": "other"})
                anns.append({"question_id": qid,
                             "answers": [{"answer": a} for a in ans],
                             "question_type": "what is",
                             "answer_type": "other"})
                ques_map[str(qid)] = t_idx
                qid += 1
            with open(os.path.join(root, "vqa", "Partition_Q",
                                   f"{split}_{task}.json"), "w") as f:
                json.dump(rows, f)
    with open(os.path.join(root, "QuesId_task_map.json"), "w") as f:
        json.dump(ques_map, f)
    with open(os.path.join(root, "ImgId_cate_map.json"), "w") as f:
        json.dump(cate, f)
    with open(os.path.join(root, "vqa",
                           "v2_mscoco_val2014_annotations.json"), "w") as f:
        json.dump({"annotations": anns}, f)

    def tsv_rows():
        for img in imgs:
            xy = rng.uniform(0, 400, (36, 2)).astype(np.float32)
            wh = rng.uniform(20, 200, (36, 2)).astype(np.float32)
            yield (img, rng.normal(size=(36, 2048)).astype(np.float32),
                   np.concatenate([xy, xy + wh], axis=1), 480, 640)

    tsv = os.path.join(root, "coco_obj36.tsv")
    write_obj_tsv(tsv, tsv_rows())
    n = tsv_to_pack([tsv], os.path.join(feat_dir, "coco_obj36.vfpack"))
    os.remove(tsv)
    return n


def nextqa_tables(tok, tasks, items, n_videos, seed=0):
    """NExT-QA over tables (``NextQADataModule``'s direct constructor):
    CSV-like rows through ``items_from_rows`` for each task and split
    (question ids ``"{video}_{qid}"``), answers from ``NQ_ANSWERS``, and
    16 × 2048 motion features per video (one table for every split)."""
    rng = np.random.default_rng(seed)
    videos = [str(4000 + i) for i in range(n_videos)]
    table = {v: rng.normal(size=(16, 2048)).astype(np.float32)
             for v in videos}
    rows, qid = {}, 0
    for task in tasks:
        rows[task] = {}
        for mode, n in zip(("train", "val", "test"), items):
            raw = []
            for _ in range(n):
                video = videos[int(rng.integers(0, n_videos))]
                raw.append({"video": video, "qid": str(qid),
                            "question": f"what does the {NQ_ANSWERS[qid % 9]}"
                                        f" do after {qid % 5}",
                            "answer": NQ_ANSWERS[int(rng.integers(
                                0, len(NQ_ANSWERS)))],
                            "type": task, "bigCate": int(rng.integers(1, 81))})
                qid += 1
            rows[task][mode] = items_from_rows(raw)
    features = {m: VideoFeatureStore(table=table)
                for m in ("train", "val", "test")}
    return NextQADataModule(tok, rows, features, tasks=tasks)


def cli_run(module, argv, label, ctx, num_layers):
    """``module.main(argv)`` as a user runs it, its launches counted into
    ``ctx``. The trainer that main makes is read through ``module.run``:
    with ``--now_train`` through ``drive_cl``; without it ``Test()``,
    whose K1 launches must equal ``num_layers`` × its predict batches
    (all strided with merged projections) and K1′ and K2 none →
    (trainer, record)."""
    orig = module.run
    got = {}

    def run(trainer, cli):
        got["trainer"] = trainer
        if cli.now_train:
            got["rec"] = drive_cl(trainer, label, ctx, num_layers,
                                  train=lambda: orig(trainer, cli))
            return got["rec"]["metrics"]
        before = launches.read()
        t0 = time.perf_counter()
        metrics = orig(trainer, cli)
        wall = time.perf_counter() - t0
        w = since(before)
        ctx.count(w)
        k, strided = list(w.k), list(w.strided)
        n = trainer.counts["predict_batches"]
        matrix = trainer.result_matrix.matrix().tolist()
        got["rec"] = {"wall_s": wall, "launches": k,
                      "strided_launches": strided, "predict_batches": n,
                      "predict_batch_ms_median": sorted(
                          trainer.times_ms["predict_batches"])[n // 2],
                      "result_matrix": matrix, "metrics": metrics}
        log(f"{label}: Test() wall {wall:.3f} s, {n} predict batches, "
            f"launches K1={k[0]} K1'={k[1]} K2={k[2]} (expected "
            f"{num_layers * n}/0/0), strided {strided}")
        if k != [num_layers * n, 0, 0] or n == 0 \
                or (trainer.cfg.model.merged_qkv is True and strided != k):
            fail(f"{label}: Test() launches {k} (strided {strided}) for "
                 f"{n} predict batches")
        if not np.isfinite(np.asarray(matrix)).all():
            fail(f"{label}: the result matrix is not finite: {matrix}")
        return metrics

    module.run = run
    try:
        module.main(argv)
    finally:
        module.run = orig
    return got["trainer"], got["rec"]


def training_entry_points(ctx):
    """The training entry points at t5-base. A reference-format VQA v2 root
    under ``build/`` (``P10_ITEMS`` questions per task of all ten tasks over
    ``P10_IMAGES`` images, the id maps, the v2 annotation file, the features
    as an LXMERT tsv converted by ``tsv_to_pack`` into
    ``coco_obj36.vfpack``), then ``cli/vqacl_train.py``'s ``main`` as a user
    runs it (``--from_scratch``, batch 80, eval batch 100, one epoch, memory
    200, ``--device_cache``, bf16): the files JAX's CLI leaves, wall per
    task, host-time shares and K1/K1′/K2 launches against its steps and
    batches (all strided); the same argv without ``--now_train``: ``Test()``
    over the ten checkpoints reproduces the training run's matrix, K1 only,
    12 per predict batch. ``make_trainer`` without ``--from_scratch``,
    ``--backbone`` a directory with phase 3's weights as
    ``model.safetensors``: its starting parameters bit-equal to the file
    (and the scratch start not). NExT-QA (``NQ_TASKS`` over tables,
    ``NQ_ITEMS`` per task, 16 × 2048 motion features) through
    ``cli/nextqa_train.py``'s geometry and ``make_trainer``: K1/K1′/K2 at
    the 39-position encoder against its steps and batches, the WUPS score,
    backend and vocabulary coverage. Tiny f32 runs of both CLIs through
    ``make_trainer`` at dropout 0 with ``--platform auto`` (the card) and
    ``--platform cpu``: equal result matrices, answers and metrics files,
    per-step losses within ``CL_LOSS_RTOL``. Everything written under
    ``build/`` is removed.

    Runs on phase 3's t5-base; every CLI run is counted."""
    params, tok = ctx.params, ctx.tok
    cnt = (ctx, parse_config([]).model.num_layers)
    out = {}
    shutil.rmtree(P10_DIR, ignore_errors=True)
    os.makedirs(P10_DIR)
    try:
        # ---- 10b. the VQA CLI at t5-base over a reference-format root ----
        root = os.path.join(P10_DIR, "vqa")
        t0 = time.perf_counter()
        n_packed = write_vqa_root(root, ALL_TASKS, P10_ITEMS, P10_IMAGES)
        root_s = time.perf_counter() - t0
        snap = os.path.join(P10_DIR, "snap")
        argv = ["--dataset_root", root, "--output", snap, "--from_scratch",
                "--batch_size", str(TRAIN_BATCH), "--valid_batch_size",
                str(EVAL_BATCH), "--epochs", "1", "--memory", "--m_size",
                str(CL_M_SIZE), "--device_cache", "--now_train"]
        log(f"cli_vqa: root of {len(ALL_TASKS)} tasks x {P10_ITEMS} items, "
            f"{n_packed} images through tsv_to_pack, written in "
            f"{root_s:.3f} s; vqacl_train.main {' '.join(argv)}")
        trainer, rec = cli_run(vqacl_train, argv, "cli_vqa", *cnt)
        packed = isinstance(trainer.data.features, PackedFeatureStore)
        files = sorted(os.listdir(snap))
        want = sorted([f"{t}_LAST.npz" for t in ALL_TASKS]
                      + ["Q_prototype.npy", "V_prototype.npy",
                         "metrics.json", "train_log.jsonl"])
        log(f"cli_vqa: {type(trainer).__name__}, feature store "
            f"{type(trainer.data.features).__name__}, dtype "
            f"{trainer.dtype}, merged_qkv {trainer.cfg.model.merged_qkv}; "
            f"files {files}")
        if not packed or files != want:
            fail(f"cli_vqa: the CLI left {files} (expected {want}) or read "
                 f"no pack")
        del trainer
        torch.cuda.empty_cache()
        _, test_rec = cli_run(vqacl_train,
                              [a for a in argv if a != "--now_train"],
                              "cli_vqa_test", *cnt)
        same = test_rec["result_matrix"] == rec["result_matrix"]
        log(f"cli_vqa: Test() matrix == the training run's: {same}")
        if not same:
            fail("cli_vqa: Test() over the saved checkpoints differs from "
                 "the training run's matrix")
        out["vqa"] = {k: v for k, v in rec.items() if k != "metrics"}
        out["vqa"].update(tasks=len(ALL_TASKS), items=list(P10_ITEMS),
                          images=n_packed, root_s=root_s)
        out["vqa_test"] = {k: v for k, v in test_rec.items()
                           if k != "metrics"}
        out["vqa_test"]["equal_to_training"] = same
        for t in ALL_TASKS:
            os.remove(os.path.join(snap, f"{t}_LAST.npz"))
        torch.cuda.empty_cache()

        # ---- 10c. the backbone start ------------------------------------
        m = parse_config([]).model
        st_dir = os.path.join(P10_DIR, "backbone")
        os.makedirs(st_dir)
        hf_import.write_safetensors(hf_import.to_state_dict(params, m),
                                    os.path.join(st_dir, "model.safetensors"))
        bargv = [a for a in argv if a not in ("--from_scratch",
                                              "--now_train")]
        t0 = time.perf_counter()
        trainer = vqacl_train.make_trainer(
            parse_config(bargv + ["--backbone", st_dir]))
        start_s = time.perf_counter() - t0
        got = ckpt._flat_tensors(trainer.state.params)
        ref = ckpt._flat_tensors(params)
        bit_equal = set(got) == set(ref) and all(
            torch.equal(got[k], ref[k]) for k in ref)
        del trainer, got
        scratch = vqacl_train.make_trainer(parse_config(argv))
        differs = not torch.equal(scratch.state.params["shared"],
                                  params["shared"])
        del scratch
        torch.cuda.empty_cache()
        out["backbone"] = {"bit_equal": bit_equal,
                           "scratch_differs": differs, "start_s": start_s}
        log(f"cli_backbone: make_trainer without --from_scratch, "
            f"--backbone {st_dir} (model.safetensors of phase 3's weights): "
            f"starting parameters bit-equal to the file: {bit_equal}; "
            f"the scratch start differs: {differs}; {start_s:.3f} s")
        if not (bit_equal and differs):
            fail("cli_backbone: the trainer did not start from --backbone")

        # ---- 10d. NExT-QA at t5-base -------------------------------------
        nq_snap = os.path.join(P10_DIR, "nextqa")
        cfg = parse_config(
            ["--output", nq_snap, "--from_scratch", "--batch_size",
             str(TRAIN_BATCH), "--valid_batch_size", str(EVAL_BATCH),
             "--epochs", "1", "--memory", "--m_size", str(CL_M_SIZE),
             "--proto_alpha", "0.3", "--proto_beta", "0.5", "--now_train"])
        nextqa_train.nextqa_geometry(cfg)
        t0 = time.perf_counter()
        ndata = nextqa_tables(tok, NQ_TASKS, NQ_ITEMS, NQ_VIDEOS)
        trainer = nextqa_train.make_trainer(cfg, data=ndata)
        set_up = time.perf_counter() - t0
        scores = []

        def evaluate(loader, task, evaluate=trainer.evaluate):
            scores.append(evaluate(loader, task))
            return scores[-1]

        trainer.evaluate = evaluate
        nm = trainer.cfg.model
        log(f"cli_nextqa: {type(trainer).__name__}, tasks {list(NQ_TASKS)} "
            f"x {NQ_ITEMS} items, encoder {nm.max_text_length} text + "
            f"{nm.n_boxes} clips = {nm.encoder_len}, {nm.n_ques_types} "
            f"question types, schedule {trainer.cfg.train.schedule}, "
            f"lambda_Q/V {trainer.cfg.train.lambda_Q}/"
            f"{trainer.cfg.train.lambda_V}, proto alpha/beta "
            f"{trainer.cfg.train.proto_alpha}/{trainer.cfg.train.proto_beta}"
            f"; set-up {set_up:.3f} s")
        rec = drive_cl(trainer, "cli_nextqa", *cnt)
        with open(os.path.join(nq_snap, "metrics.json")) as f:
            nq_metrics = json.load(f)
        backends = sorted({s["wups_backend"] for s in scores})
        cov = [s["wups_vocab_coverage"] for s in scores]
        wups = [s["overall"] for s in scores]
        log(f"cli_nextqa: metrics.json Avg_acc (WUPS-0) "
            f"{nq_metrics['Avg_acc']}, {len(scores)} evaluations: WUPS "
            f"{min(wups):.3f}-{max(wups):.3f}, wups_backend {backends}, "
            f"wups_vocab_coverage {min(cov):.3f}-{max(cov):.3f}")
        if nm.encoder_len != 39 or not scores or not all(
                0.0 <= c <= 1.0 for c in cov) or not set(backends) <= {
                "nltk-wordnet", "wndb-files", "vendored-taxonomy"}:
            fail("cli_nextqa: geometry or WUPS telemetry wrong")
        out["nextqa"] = {k: v for k, v in rec.items() if k != "metrics"}
        out["nextqa"].update(
            encoder_len=nm.encoder_len, avg_acc_wups=nq_metrics["Avg_acc"],
            wups_backend=backends, wups_vocab_coverage=[min(cov), max(cov)],
            wups_range=[min(wups), max(wups)])
        del trainer, ndata
        torch.cuda.empty_cache()

        # ---- 10e. tiny f32 CLI runs, card vs CPU -------------------------
        # at the CLI's default lr (the reference's 1e-4). At 1e-3 the VQA
        # run's per-step losses left the CPU run's by more than
        # CL_LOSS_RTOL, with equal answers and matrices, and as much with
        # the unfused attention as with the kernels: Adam turns the card's
        # and the host's f32 sum orders over the 2048-wide features into
        # different updates of near-zero gradient entries
        out["tiny"] = {}
        for name, module in (("vqa", vqacl_train), ("nextqa", nextqa_train)):
            runs = {}
            for platform in ("auto", "cpu"):
                tsnap = os.path.join(P10_DIR, f"tiny_{name}_{platform}")
                targv = ["--tiny_model", "--platform", platform, "--output",
                         tsnap, "--from_scratch", "--batch_size",
                         str(P10_TINY_BATCH), "--valid_batch_size",
                         str(P10_TINY_BATCH), "--epochs", "1", "--memory",
                         "--m_size", "16", "--dtype", "float32",
                         "--now_train"]
                if name == "vqa":
                    targv += ["--comp_cate", "G5"]
                tcfg = parse_config(targv)
                tcfg.model.dropout_rate = 0.0
                if name == "vqa":
                    tdata = VQADataModule(root, tok, tasks=ALL_TASKS[:2],
                                          train_topk=P10_TINY[0],
                                          valid_topk=P10_TINY[1])
                else:
                    nextqa_train.nextqa_geometry(tcfg)
                    tdata = nextqa_tables(tok, NQ_TASKS, P10_TINY, 32,
                                          seed=1)
                trainer = module.make_trainer(tcfg, data=tdata)
                answers = record_answers(trainer)
                tm = trainer.cfg.model
                r = drive_cl(trainer, f"cli_tiny_{name}_{platform}",
                             ctx if platform == "auto" else None,
                             tm.num_layers, train=lambda t=trainer,
                             c=tcfg._cli: module.run(t, c))
                r["answers"] = answers
                r["device"] = trainer.device.type
                r["cls"] = type(trainer).__name__
                r["metrics_json"] = {}
                for fname in ("metrics.json", "metrics_comp.json"):
                    if os.path.exists(os.path.join(tsnap, fname)):
                        with open(os.path.join(tsnap, fname)) as f:
                            r["metrics_json"][fname] = json.load(f)
                runs[platform] = r
                del trainer
            card, cpu = runs["auto"], runs["cpu"]
            err = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                            cpu["losses"]))
            same = {k: card[k] == cpu[k] for k in (
                "result_matrix", "answers", "metrics_json")}
            log(f"cli tiny f32 {name} ({card['cls']}), --platform auto on "
                f"{card['device']} vs cpu on {cpu['device']}: "
                f"{len(card['losses'])} / {len(cpu['losses'])} steps, loss "
                f"max rel err {err:.3e} (tol {CL_LOSS_RTOL:g}); equal: "
                f"{json.dumps(same)}")
            if card["device"] != "cuda" or cpu["device"] != "cpu" \
                    or len(card["losses"]) != len(cpu["losses"]) \
                    or not err <= CL_LOSS_RTOL or not all(same.values()):
                fail(f"cli tiny f32 {name}: the card run differs from the "
                     f"CPU run")
            out["tiny"][name] = {"loss_rel_err": err, "equal": same,
                                 "cls": card["cls"],
                                 "launches": card["launches"]}
    finally:
        shutil.rmtree(P10_DIR, ignore_errors=True)
    k = ctx.launched().k
    log(f"phase 10 launches K1={k[0]} K1'={k[1]} K2={k[2]}")
    return {"training_cli": out, "training_cli_launches": list(k)}
