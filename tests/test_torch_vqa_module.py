"""The port's ``VQADataModule`` against the JAX package's, over the
reference's on-disk layout.

Two roots are written from one seed: Partition_Q jsons of two tasks,
``QuesId_task_map.json``, ``ImgId_cate_map.json``, the official
``v2_mscoco_val2014_annotations.json`` (answers that differ from the
partition's, so that the file is seen to be read) and the region
features, once as ``COCO/features/val2014_obj36.h5`` and once as an
LXMERT tsv converted by the port's ``tsv_to_pack`` into
``coco_obj36.vfpack`` (the pack is taken when it exists). On each root
both packages must give the same items (whole splits and ``topk`` cuts),
the same feature store kind and every array of every loader batch bit
for bit; their evaluators the same dicts with and without the annotation
file (int and str question ids, the partition's answers as the
fallback, ``topk_score`` 0.0 on a question of another task); and
``VQACLTrainer`` of both packages on their modules, from the same tiny
weights at dropout 0, the same batches, answers, tokens and result
matrix, with losses within ``LOSS_RTOL``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoke.clis import write_obj_tsv  # noqa: E402
from torch_parity import (jax_tiny_params, record_trainer,  # noqa: E402
                          torch_cfg_like)
from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer  # noqa: E402
from vqacl_tpu.data import partition as JP  # noqa: E402
from vqacl_tpu.data.features import write_h5  # noqa: E402
from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok  # noqa: E402
from vqacl_tpu.data.vqa_module import VQADataModule as JModule  # noqa: E402
from vqacl_tpu.parallel import make_mesh  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cl.trainer import VQACLTrainer as TTrainer  # noqa: E402
from vqacl_tpu_torch.data import partition as TP  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok  # noqa: E402
from vqacl_tpu_torch.data.tsv_convert import tsv_to_pack  # noqa: E402
from vqacl_tpu_torch.data.vqa_module import VQADataModule as TModule  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

TASKS = ["q_recognition", "q_location"]
ITEMS = (24, 8, 8)
N_IMAGES = 20
N_BOXES, FEAT_DIM = 4, 16
WORDS = ("yes", "no", "two", "red", "dog", "table")
COLLATE = dict(max_text_length=6, n_boxes=N_BOXES, target_max_length=5,
               feat_dim=FEAT_DIM)
# per-step losses, relative, after a tiny CL run at lr 1e-3 (the two
# packages sum in other orders)
LOSS_RTOL = 1e-4


def write_root(root, features, annotations, seed=0):
    """The reference layout of ``TASKS`` (module docstring); ``features``
    "h5" or "pack"."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "vqa" / "Partition_Q")
    os.makedirs(root / "COCO" / "features")
    imgs = [f"COCO_val2014_{i:012d}" for i in range(1, N_IMAGES + 1)]
    cate = {img: int(rng.integers(0, 80)) for img in imgs}
    ques_map, anns, qid = {}, [], 1
    for t_idx, task in enumerate(TASKS):
        for split, n in zip(("karpathy_train", "karpathy_val",
                             "karpathy_test"), ITEMS):
            rows = []
            for _ in range(n):
                img = imgs[int(rng.integers(0, N_IMAGES))]
                ans = [WORDS[int(a)] for a in rng.integers(0, 3, 10)]
                vals, cnt = np.unique(ans, return_counts=True)
                rows.append({
                    "img_id": img, "question_id": qid,
                    "sent": f"is the {WORDS[cate[img] % 6]} here {qid}?",
                    "label": {str(a): min(1.0, c / 3)
                              for a, c in zip(vals, cnt)},
                    "answers": [{"answer": a} for a in ans],
                    "question_type": "is the", "answer_type": "yes/no"})
                # the official file: other answers than the partition's
                anns.append({"question_id": qid, "answers": [
                    {"answer": WORDS[int(a)]} for a in rng.integers(0, 6, 10)],
                    "question_type": "is there", "answer_type": "other"})
                ques_map[str(qid)] = t_idx
                qid += 1
            with open(root / "vqa" / "Partition_Q" / f"{split}_{task}.json",
                      "w") as f:
                json.dump(rows, f)
    with open(root / "QuesId_task_map.json", "w") as f:
        json.dump(ques_map, f)
    with open(root / "ImgId_cate_map.json", "w") as f:
        json.dump(cate, f)
    if annotations:
        with open(root / "vqa" / "v2_mscoco_val2014_annotations.json",
                  "w") as f:
            json.dump({"annotations": anns}, f)
    recs = []
    for img in imgs:
        xy = rng.uniform(0, 40, (N_BOXES, 2)).astype(np.float32)
        recs.append((img, rng.normal(size=(N_BOXES, FEAT_DIM)).astype(
            np.float32), np.concatenate([xy, xy + 20], axis=1), 100, 120))
    feat_dir = root / "COCO" / "features"
    if features == "h5":
        write_h5(str(feat_dir / "val2014_obj36.h5"),
                 [(i, {"features": f, "boxes": b, "img_h": h, "img_w": w})
                  for i, f, b, h, w in recs])
    else:
        tsv = str(root / "obj36.tsv")
        write_obj_tsv(tsv, recs)
        assert tsv_to_pack([tsv], str(feat_dir / "coco_obj36.vfpack"),
                           n_boxes=N_BOXES, feat_dim=FEAT_DIM) == N_IMAGES
    return str(root)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    cache = {}

    def get(features, annotations=True):
        key = (features, annotations)
        if key not in cache:
            cache[key] = write_root(
                tmp_path_factory.mktemp(f"vqa_{features}_{annotations}"),
                features, annotations)
        return cache[key]
    return get


def _modules(root, **kw):
    return (JModule(root, JTok(), tasks=TASKS, **kw),
            TModule(root, TTok(), tasks=TASKS, **kw))


@pytest.mark.parametrize("features", ["h5", "pack"])
def test_items_topk_and_store_match_jax(roots, features):
    root = roots(features)
    for topk in (-1, 5):
        jm, tm = _modules(root, train_topk=topk, valid_topk=topk)
        assert type(tm.features).__name__ == type(jm.features).__name__ \
            == ("H5FeatureStore" if features == "h5"
                else "PackedFeatureStore")
        assert tm.ques_map == jm.ques_map and tm.cate_map == jm.cate_map
        for task in TASKS:
            assert tm.train_items(task) == jm.train_items(task)
            for split, n in zip(("train", "val", "test"), ITEMS):
                items = tm._items(task, split)
                assert items == jm._items(task, split)
                assert len(items) == (n if topk < 0 else topk)
        img = tm.train_items(TASKS[0])[0]["img_id"]
        for a, b in zip(tm.features.get(img), jm.features.get(img)):
            np.testing.assert_array_equal(a, b)


def _assert_batches_equal(jbs, tbs):
    assert len(jbs) == len(tbs) > 0
    for jb, tb in zip(jbs, tbs):
        assert jb["tensors"].keys() == tb["tensors"].keys()
        for k, v in jb["tensors"].items():
            assert tb["tensors"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(tb["tensors"][k], v, err_msg=k)
        assert tb["meta"] == jb["meta"]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("features", ["h5", "pack"])
def test_loader_batches_match_jax(roots, features, workers):
    """Every split's loaders as the trainer builds them (group loaders
    shuffled with sampled answers in train mode, in order in val mode,
    the all-categories test loader) over two epochs."""
    jm, tm = _modules(roots(features))
    kw = dict(collate_kw=COLLATE, num_workers=workers)
    for t_idx, task in enumerate(TASKS):
        for split in ("train", "val", "test"):
            jds, tds = jm.dataset(task, split, t_idx), \
                tm.dataset(task, split, t_idx)
            if split == "test":
                jl = {"all": JP.all_loader(jds, 8, with_targets=False, **kw)}
                tl = {"all": TP.all_loader(tds, 8, with_targets=False, **kw)}
            else:
                jl = JP.group_loaders(jds, 8, shuffle=split == "train",
                                      seed=66666, **kw)
                tl = TP.group_loaders(tds, 8, shuffle=split == "train",
                                      seed=66666, **kw)
            assert tl.keys() == jl.keys()
            for g in jl:
                assert tl[g].num_examples == jl[g].num_examples
                for _ in range(2):
                    if jl[g].num_examples:
                        _assert_batches_equal(list(jl[g]), list(tl[g]))


@pytest.mark.parametrize("annotations", [True, False])
def test_evaluator_matches_jax(roots, annotations):
    jm, tm = _modules(roots("pack", annotations))
    rng = np.random.default_rng(1)
    outs = []
    for task in TASKS:
        qids = [d["question_id"] for s in ("train", "val", "test")
                for d in tm._items(task, s)]
        preds = {q: WORDS[int(rng.integers(0, 6))] for q in qids}
        preds[qids[0]] = " Yes. "              # normalised before scoring
        for q2a in (preds, {str(q): a for q, a in preds.items()}):
            got, want = tm.evaluator(task)(q2a), jm.evaluator(task)(q2a)
            assert got == want
            outs.append(got["overall"])
        other = tm._items(TASKS[1 - TASKS.index(task)], "test")[0]
        q2a = {other["question_id"]: "yes"}
        if annotations:
            # known to the official file, not to this task's items
            got, want = tm.evaluator(task)(q2a), jm.evaluator(task)(q2a)
            assert got == want and got["topk_score"] == 0.0
        else:
            for m in (tm, jm):
                with pytest.raises(KeyError):
                    m.evaluator(task)(q2a)
    assert any(o > 0 for o in outs)


def test_evaluator_reads_the_annotation_file(roots):
    """The official answers differ from the partition's, so the scores
    with the file differ from those of the fallback."""
    (_, with_file), (_, without) = _modules(roots("pack", True)), \
        _modules(roots("pack", False))
    q2a = {d["question_id"]: "yes" for d in with_file._items(TASKS[0],
                                                              "test")}
    a, b = with_file.evaluator(TASKS[0])(q2a), without.evaluator(TASKS[0])(q2a)
    assert a["perQuestionType"].keys() == {"is there"}
    assert b["perQuestionType"].keys() == {"is the"}


def _configs(out_j, out_t):
    jm, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200)
    jc = JConfig()
    jc.model = jm
    jc.train.lr = 1e-3
    jc.train.batch_size = jc.train.valid_batch_size = 8
    jc.train.epochs = 1
    jc.train.m_size = 12
    jc.output = str(out_j)
    tc = TConfig()
    tc.model = torch_cfg_like(jm)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    tc.output = str(out_t)
    return jc, tc, params


def test_trainer_on_the_module_follows_jax(roots, tmp_path):
    root = roots("pack")
    jc, tc, params = _configs(tmp_path / "jax", tmp_path / "port")
    jt = JTrainer(jc, JModule(root, JTok(), tasks=TASKS), JTok(),
                  verbose=False,
                  mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
                  init_params=jax.tree.map(jnp.asarray, params),
                  dtype=jnp.float32)
    tt = TTrainer(tc, TModule(root, TTok(), tasks=TASKS), TTok(),
                  verbose=False, device="cpu",
                  init_params=from_jax_params(params), dtype=torch.float32)
    jr, tr = record_trainer(jt), record_trainer(tt)
    jmet, tmet = jt.train(), tt.train()
    assert tr["batches"] == jr["batches"]
    assert [k for k, _ in tr["losses"]] == [k for k, _ in jr["losses"]]
    assert len(tr["losses"]) >= 8
    np.testing.assert_allclose([v for _, v in tr["losses"]],
                               [v for _, v in jr["losses"]], rtol=LOSS_RTOL)
    assert tr["answers"] == jr["answers"]
    for a, b in zip(tr["tokens"], jr["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert tt.result_matrix.to_dict() == jt.result_matrix.to_dict()
    assert tmet["Avg_acc"] == jmet["Avg_acc"]
