"""The port's NExT-QA data path (``nextqa/data.py``) against the JAX
package's.

A reference-format NExT-QA root is written from one seed: the CSV
partitions ``Partition_Q_v2/{mode}_{task}.csv`` of two tasks, the video
features ``vid_feat/app_mot_{mode}.h5`` (16 clips × [appearance 2048 ‖
motion 2048]) and ``add_reference_answer_test.json``. On it both
packages' ``NextQADataModule.from_root`` must give the same rows, maps
and motion-half tables; their loaders the same batches bit for bit; the
evaluators (WUPS-0, exact match for CC/CB, the extra reference answers)
the same dicts; and ``VQACLTrainer`` of both at NExT-QA's tiny geometry
(23 text + 16 clip positions, 6 answer tokens, 8 question types, the
linear schedule, λ_Q = λ_V = 0) from the same weights at dropout 0 the
same batches, answers and result matrix, losses within ``LOSS_RTOL``.
The constants (tasks, the 1-based category groups and their 0-based
labels) are equal too.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (jax_tiny_params, record_trainer,  # noqa: E402
                          torch_cfg_like)
from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer  # noqa: E402
from vqacl_tpu.data import partition as JP  # noqa: E402
from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok  # noqa: E402
from vqacl_tpu.nextqa import data as JN  # noqa: E402
from vqacl_tpu.parallel import make_mesh  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cl.trainer import VQACLTrainer as TTrainer  # noqa: E402
from vqacl_tpu_torch.data import partition as TP  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.nextqa import data as TN  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

TASKS = ["CW", "TN"]
ITEMS = (24, 8, 8)
ANSWERS = ("dog", "cat", "man", "baby", "ball", "playing", "walking",
           "red", "the dog")
COLLATE = dict(max_text_length=JN.TEXT_LEN, n_boxes=JN.N_CLIPS,
               target_max_length=JN.ANS_LEN, feat_dim=JN.FEAT_DIM)
LOSS_RTOL = 1e-4


def write_root(root, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "Partition_Q_v2")
    os.makedirs(root / "vid_feat")
    vids, feats, extra, n = {m: [] for m in ("train", "val", "test")}, \
        {m: [] for m in ("train", "val", "test")}, {}, 0
    for task in TASKS:
        for mode, k in zip(("train", "val", "test"), ITEMS):
            rows = []
            for i in range(k):
                video = f"{3000 + n}"
                n += 1
                rows.append({"video": video, "qid": str(i % 3),
                             "question": f"what does the baby do {i}",
                             "answer": ANSWERS[int(rng.integers(0, 9))],
                             "type": task, "bigCate": int(rng.integers(1, 81))})
                vids[mode].append(video.encode())
                feats[mode].append(rng.normal(size=(16, 4096)).astype(
                    np.float32))
                if mode == "test" and i % 2:
                    extra.setdefault(video, {})[str(i % 3)] = \
                        ANSWERS[int(rng.integers(0, 9))]
            with open(root / "Partition_Q_v2" / f"{mode}_{task}.csv", "w",
                      newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
    for mode in ("train", "val", "test"):
        with h5py.File(root / "vid_feat" / f"app_mot_{mode}.h5", "w") as f:
            f["ids"] = np.asarray(vids[mode])
            f["feat"] = np.stack(feats[mode])
    with open(root / "add_reference_answer_test.json", "w") as f:
        json.dump(extra, f)
    return str(root)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_root(tmp_path_factory.mktemp("nextqa"))


def _modules(root):
    ref = os.path.join(root, "add_reference_answer_test.json")
    return (JN.NextQADataModule.from_root(root, JTok(), tasks=TASKS,
                                          add_reference_path=ref),
            TN.NextQADataModule.from_root(root, TTok(), tasks=TASKS,
                                          add_reference_path=ref))


def test_constants_match_jax():
    for name in ("NEXTQA_TASKS", "NEXTQA_SPLITS", "NEXTQA_SPLITS_0BASED",
                 "N_CLIPS", "FEAT_DIM", "TEXT_LEN", "ANS_LEN"):
        assert getattr(TN, name) == getattr(JN, name), name
    assert TN.NextQADataModule.category_splits == \
        JN.NextQADataModule.category_splits
    np.testing.assert_array_equal(TN.dummy_boxes(), JN.dummy_boxes())


def test_from_root_matches_jax(root):
    jm, tm = _modules(root)
    assert tm._rows == jm._rows
    assert tm.cate_map == jm.cate_map and tm.ques_map == jm.ques_map
    assert tm.add_ref == jm.add_ref and tm.add_ref
    # question ids are "{video}_{qid}" strings, keyed alike everywhere
    qid = tm.train_items("CW")[0]["question_id"]
    assert isinstance(qid, str) and qid in tm.ques_map
    with h5py.File(os.path.join(root, "vid_feat", "app_mot_train.h5")) as f:
        raw = dict(zip((v.decode() for v in f["ids"][()]), f["feat"][()]))
    for mode in ("train", "val", "test"):
        jt, tt = jm.features[mode].table, tm.features[mode].table
        assert tt.keys() == jt.keys()
        for v in tt:
            assert tt[v].shape == (JN.N_CLIPS, JN.FEAT_DIM)
            np.testing.assert_array_equal(tt[v], jt[v])
            a, b = tm.features[mode].get(v), jm.features[mode].get(v)
            np.testing.assert_array_equal(a[1], b[1])
    for v, feat in raw.items():            # the motion half only
        np.testing.assert_array_equal(tm.features["train"].table[v],
                                      feat[:, JN.FEAT_DIM:])


@pytest.mark.parametrize("workers", [1, 2])
def test_loader_batches_match_jax(root, workers):
    jm, tm = _modules(root)
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
                                      seed=6666, splits=jm.category_splits,
                                      **kw)
                tl = TP.group_loaders(tds, 8, shuffle=split == "train",
                                      seed=6666, splits=tm.category_splits,
                                      **kw)
            assert tl.keys() == jl.keys()
            for g in jl:
                assert tl[g].num_examples == jl[g].num_examples
                if not jl[g].num_examples:
                    continue
                for _ in range(2):
                    jbs, tbs = list(jl[g]), list(tl[g])
                    assert len(jbs) == len(tbs)
                    for jb, tb in zip(jbs, tbs):
                        assert jb["tensors"].keys() == tb["tensors"].keys()
                        for k, v in jb["tensors"].items():
                            assert tb["tensors"][k].dtype == v.dtype
                            np.testing.assert_array_equal(tb["tensors"][k],
                                                          v, err_msg=k)
                        assert tb["meta"] == jb["meta"]


def test_module_evaluator_matches_jax(root):
    jm, tm = _modules(root)
    rng = np.random.default_rng(2)
    for task in TASKS:
        qids = [d["question_id"] for s in ("train", "val", "test")
                for d in tm._rows[task][s]]
        for _ in range(3):
            q2a = {q: ANSWERS[int(rng.integers(0, 9))] + " ." for q in qids}
            got, want = tm.evaluator(task)(q2a), jm.evaluator(task)(q2a)
            assert got == want
            assert got["wups_backend"] == "vendored-taxonomy"
            assert got["topk_score"] == got["overall"] / 100.0


def test_evaluator_exact_match_and_references_match_jax():
    """CC/CB score by exact match (against the answer or the extra
    reference), the other types by WUPS-0 with the reference as a second
    chance; both after punctuation, article and stopword removal."""
    id2datum = {}
    preds = {}
    cases = [("CC", "dog", "the dog"), ("CC", "dog", "cat"),
             ("CB", "ball", "ball ."), ("CB", "two", "2"),
             ("CW", "dog", "cat"), ("CW", "man walking", "woman"),
             ("TN", "red", "red"), ("TN", "zzyzx", "dog"),
             ("DL", "baby", "a baby"), ("CH", "playing", "")]
    add_ref = {}
    for i, (qtype, gt, pred) in enumerate(cases):
        qid = f"{100 + i}_0"
        id2datum[qid] = {"gt_answer": gt, "type": qtype,
                         "video": str(100 + i), "qid": "0"}
        preds[qid] = pred
        if i % 3 == 1:
            add_ref[str(100 + i)] = {"0": pred if i % 2 else "cat"}
    got = TN.NextQAEvaluator(id2datum, add_ref).evaluate_raw(preds)
    want = JN.NextQAEvaluator(id2datum, add_ref).evaluate_raw(preds)
    assert got == want
    no_ref = TN.NextQAEvaluator(id2datum).evaluate_raw(preds)
    assert no_ref == JN.NextQAEvaluator(id2datum).evaluate_raw(preds)
    assert got["overall"] > no_ref["overall"]
    assert 0.0 < got["wups_vocab_coverage"] < 1.0


def test_items_from_rows_matches_jax():
    rows = [{"video": 7, "qid": 3, "question": "why", "answer": "dog",
             "type": "CW", "bigCate": 12}]
    assert TN.items_from_rows(rows) == JN.items_from_rows(rows)
    assert TN.items_from_rows(rows)[0]["question_id"] == "7_3"


def test_trainer_at_nextqa_geometry_follows_jax(root, tmp_path):
    geometry = dict(max_text_length=JN.TEXT_LEN, n_boxes=JN.N_CLIPS,
                    target_max_length=JN.ANS_LEN, feat_dim=JN.FEAT_DIM,
                    n_ques_types=8)
    jmc, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200,
                                  **geometry)
    jc = JConfig()
    jc.model = jmc
    jc.train.lr = 1e-3
    jc.train.batch_size = jc.train.valid_batch_size = 8
    jc.train.epochs = 1
    jc.train.m_size = 12
    jc.train.schedule = "linear_warmup"
    jc.train.lambda_Q = jc.train.lambda_V = 0.0
    jc.train.proto_alpha, jc.train.proto_beta = 0.3, 0.5
    jc.output = str(tmp_path / "jax")
    tc = TConfig()
    tc.model = torch_cfg_like(jmc)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    tc.output = str(tmp_path / "port")
    jm, tm = _modules(root)
    jt = JTrainer(jc, jm, JTok(), verbose=False,
                  mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
                  init_params=jax.tree.map(jnp.asarray, params),
                  dtype=jnp.float32)
    tt = TTrainer(tc, tm, TTok(), verbose=False, device="cpu",
                  init_params=from_jax_params(params), dtype=torch.float32)
    assert tt.splits == jt.splits == JN.NEXTQA_SPLITS_0BASED
    jr, tr = record_trainer(jt), record_trainer(tt)
    jmet, tmet = jt.train(), tt.train()
    assert tr["batches"] == jr["batches"]
    assert len(tr["losses"]) >= 8
    np.testing.assert_allclose([v for _, v in tr["losses"]],
                               [v for _, v in jr["losses"]], rtol=LOSS_RTOL)
    assert tr["answers"] == jr["answers"]
    assert all(isinstance(q, str) for a in tr["answers"] for q in a)
    assert tt.result_matrix.to_dict() == jt.result_matrix.to_dict()
    assert tmet["Avg_acc"] == jmet["Avg_acc"]
