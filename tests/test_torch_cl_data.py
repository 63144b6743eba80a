"""The port's continual-learning data pipeline against the JAX package.

Each piece runs in both packages on the same seeds and must agree exactly
(the metric floats within 1e-12): the task-protocol constants and the
seeded group shuffle, the exemplar buffer's picks over three tasks, the
VQA accuracy on the answer cases of ``tests/test_vqa_acc.py``, the result
matrix and Avg-Acc/Forget on random matrices, ``SyntheticDataModule``'s
items and features, every array of every batch that ``group_loaders``
and ``all_loader`` yield over two epochs (one producer thread and two
workers, train and eval mode), and ``collate`` with DER logits. These are
numpy and Python only on both sides: nothing here compiles.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from vqacl_tpu.cl import exemplar as JE  # noqa: E402
from vqacl_tpu.cl import metrics as JM  # noqa: E402
from vqacl_tpu.cl import tasks as JK  # noqa: E402
from vqacl_tpu.data import collate as JC  # noqa: E402
from vqacl_tpu.data import partition as JP  # noqa: E402
from vqacl_tpu.data.synthetic_module import SyntheticDataModule as JData  # noqa: E402
from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok  # noqa: E402
from vqacl_tpu.evaluation import vqa_acc as JV  # noqa: E402
from vqacl_tpu_torch.cl import exemplar as TE  # noqa: E402
from vqacl_tpu_torch.cl import metrics as TM  # noqa: E402
from vqacl_tpu_torch.cl import tasks as TK  # noqa: E402
from vqacl_tpu_torch.data import collate as TC  # noqa: E402
from vqacl_tpu_torch.data import partition as TP  # noqa: E402
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule as TData  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok  # noqa: E402
from vqacl_tpu_torch.evaluation import vqa_acc as TV  # noqa: E402

METRIC_TOL = 1e-12
TASKS = ["q_recognition", "q_location", "q_judge"]
# SyntheticDataModule settings: the smoke default, and the Table-1
# surrogate's (a bounded image pool, task-dependent answers, category
# only in the features)
MODULES = {
    "smoke": dict(n_train_per_task=40, n_val_per_task=12, n_test_per_task=12,
                  feat_dim=16, n_boxes=4, answer_vocab=4, seed=0),
    "surrogate": dict(n_train_per_task=40, n_val_per_task=12,
                      n_test_per_task=12, feat_dim=16, n_boxes=4,
                      answer_vocab=5, seed=3, n_images=24, task_shift=1,
                      category_in_text=False, residue_centroids=True),
}
COLLATE = dict(max_text_length=6, n_boxes=4, target_max_length=5,
               feat_dim=16)


def _modules(name, tasks=TASKS):
    kw = MODULES[name]
    return (JData(JTok(), tasks=tasks, **kw), TData(TTok(), tasks=tasks, **kw))


def test_task_constants_and_group_shuffle_match_jax():
    for name in ("SEED", "ALL_TASKS", "COMP_TASKS", "CATEGORY_SPLITS",
                 "COMP_TASK_IDX", "NEXTQA_SEED", "NEXTQA_TASKS",
                 "NEXTQA_GROUPS"):
        assert getattr(TK, name) == getattr(JK, name), name
    d = {g: None for g in TK.CATEGORY_SPLITS}
    for seed in (0, 1, 66666):
        jr, tr = JK.make_rng(seed), TK.make_rng(seed)
        for _ in range(4):      # the trainer draws once per task
            assert list(TK.random_dic(d, tr)) == list(JK.random_dic(d, jr))
        assert tr.getstate() == jr.getstate()
    for c in range(80):
        assert TK.category_to_group(c) == JK.category_to_group(c)


def test_exemplar_buffer_matches_jax():
    """The same question ids in the same slots over three tasks, and the
    generator left in the same state."""
    jd, td = _modules("smoke", TASKS + ["q_commonsense"])
    jb, tb = JE.ExemplarBuffer(30), TE.ExemplarBuffer(30)
    jr, tr = JK.make_rng(66666), TK.make_rng(66666)
    for t in range(1, 4):
        jb.update(t, jd.train_items(TASKS[t - 1]), jd.cate_map, jr)
        tb.update(t, td.train_items(TASKS[t - 1]), td.cate_map, tr)
        ids = lambda b: {g: [[d["question_id"] for d in slot]
                             for slot in b.sets[g]] for g in b.sets}
        assert ids(tb) == ids(jb)
        assert len(tb) == len(jb) > 0
        assert [d["question_id"] for d in tb.all_examplars()] == \
            [d["question_id"] for d in jb.all_examplars()]
    assert tr.getstate() == jr.getstate()


def test_vqa_accuracy_matches_jax():
    """``tests/test_vqa_acc.py``'s answer cases, and every normalization
    helper on their strings."""
    strings = ["Two", "a cat", "the  None", "ten dogs", "isnt", "dont know",
               "yes; no", "black/white", "1,000", "U.S.", "net", "It's 3.5!"]
    for s in strings:
        assert TV.normalize_answer(s) == JV.normalize_answer(s), s
        assert TV.process_punctuation(s) == JV.process_punctuation(s), s
        assert TV.process_digit_article(s) == JV.process_digit_article(s), s
    net = [{"answer": "net"}] * 4 + [{"answer": "mesh"}] * 6
    red = [{"answer": "red"}] + [{"answer": "blue"}] * 9
    gt = {1: {"answers": net, "question_type": "what",
              "answer_type": "other"},
          2: {"answers": red, "question_type": "what color",
              "answer_type": "other"}}
    soft = {1: {"label": {"net": 0.9}}, 2: {"label": {"no": 0.3}}}
    for res in ({1: "net"}, {2: "red"}, {1: "mesh", 2: "Blue."},
                {1: "nets", 2: "no"}):
        j = JV.VQAEvaluator(id2datum=soft, id2datum_gt=gt)
        t = TV.VQAEvaluator(id2datum=soft, id2datum_gt=gt)
        assert t.evaluate_raw(res) == j.evaluate_raw(res)
        assert t.evaluate(res) == j.evaluate(res)
    assert TV.VQAEvaluator().evaluate_raw({}) == \
        JV.VQAEvaluator().evaluate_raw({})


@pytest.mark.parametrize("n,start", [(3, 0), (5, 0), (10, 0), (10, 2)])
def test_result_matrix_and_metrics_match_jax(n, start):
    rng = np.random.default_rng(n + start)
    tasks = TK.ALL_TASKS[:n]
    jm, tm = JM.ResultMatrix(tasks), TM.ResultMatrix(tasks)
    for i in range(n):
        for j in range(i + 1):
            acc = float(rng.uniform(0, 100))
            jm.record(tasks[i], tasks[j], acc)
            tm.record(tasks[i], tasks[j], acc)
    assert tm.to_dict() == jm.to_dict()
    assert tm.show(start) == jm.show(start)
    np.testing.assert_array_equal(tm.matrix(start), jm.matrix(start))
    jo = JM.evaluate_metric(jm.to_dict(), start=start)
    to = TM.evaluate_metric(tm.to_dict(), start=start)
    assert to.keys() == jo.keys()
    for k in jo:
        np.testing.assert_allclose(to[k], jo[k], rtol=0, atol=METRIC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(MODULES))
def test_synthetic_module_matches_jax(name):
    jd, td = _modules(name)
    assert td.cate_map == jd.cate_map and td.ques_map == jd.ques_map
    assert td.tasks == jd.tasks
    for task in TASKS:
        for split in ("train", "val", "test"):
            assert td._items[task][split] == jd._items[task][split]
    assert td.features.table.keys() == jd.features.table.keys()
    for img in jd.features.table:
        for a, b in zip(td.features.get(img), jd.features.get(img)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the evaluator scores the same answers the same way
    qs = [d["question_id"] for d in jd._items[TASKS[1]]["test"]]
    answers = {q: f"ans{q % 5}" for q in qs}
    assert td.evaluator(TASKS[1])(answers) == jd.evaluator(TASKS[1])(answers)


def _assert_batches_equal(jbs, tbs):
    assert len(jbs) == len(tbs) > 0
    for jb, tb in zip(jbs, tbs):
        assert jb["tensors"].keys() == tb["tensors"].keys()
        for k, v in jb["tensors"].items():
            assert tb["tensors"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(tb["tensors"][k], v, err_msg=k)
        assert tb["meta"] == jb["meta"]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("name", list(MODULES))
def test_loaders_yield_the_jax_batches(name, workers):
    """group_loaders (train mode, shuffled, answers sampled; val mode) and
    all_loader (test mode) over two epochs, as the trainer builds them."""
    jd, td = _modules(name)
    task = TASKS[0]
    for split, shuffle, targets in (("train", True, True),
                                    ("val", False, True),
                                    ("test", False, False)):
        # several answers per question, so that the train mode's draws
        # pick among them
        items = [dict(d, label=dict(d["label"], other=0.6, maybe=0.3))
                 for d in jd._items[task][split]]
        mode = "train" if split == "train" else "val"
        jds, tds = jd.make_dataset(items, mode, 0), td.make_dataset(items,
                                                                    mode, 0)
        kw = dict(collate_kw=COLLATE, num_workers=workers)
        if split == "test":
            jl = {"all": JP.all_loader(jds, 8, with_targets=targets, **kw)}
            tl = {"all": TP.all_loader(tds, 8, with_targets=targets, **kw)}
        else:
            jl = JP.group_loaders(jds, 8, shuffle=shuffle, seed=66666,
                                  with_targets=targets, **kw)
            tl = TP.group_loaders(tds, 8, shuffle=shuffle, seed=66666,
                                  with_targets=targets, **kw)
        assert tl.keys() == jl.keys()
        for g in jl:
            assert tl[g].num_examples == jl[g].num_examples
            assert len(tl[g]) == len(jl[g])
            for _ in range(2):
                if jl[g].num_examples:
                    _assert_batches_equal(list(jl[g]), list(tl[g]))
        # the serial path consumed the datasets' shared answer streams
        assert tds.rng.bit_generator.state == jds.rng.bit_generator.state


def test_memory_and_importance_loaders_match_jax():
    """The replay loader over exemplars of two tasks (the trainer's seed
    + 7) and the importance loader (seed + 13, drop_last), serial."""
    jd, td = _modules("smoke")
    jb, tb = JE.ExemplarBuffer(20), TE.ExemplarBuffer(20)
    jb.update(1, jd.train_items(TASKS[0]), jd.cate_map, JK.make_rng(1))
    tb.update(1, td.train_items(TASKS[0]), td.cate_map, TK.make_rng(1))
    jm = jd.make_dataset(jb.all_examplars(), mode="train", task_idx=1)
    tm = td.make_dataset(tb.all_examplars(), mode="train", task_idx=1)
    jl = JP.group_loaders(jm, 4, seed=66666 + 7, collate_kw=COLLATE)
    tl = TP.group_loaders(tm, 4, seed=66666 + 7, collate_kw=COLLATE)
    for g in jl:
        if jl[g].num_examples:
            _assert_batches_equal(list(jl[g]), list(tl[g]))
    jt, tt = jd.dataset(TASKS[1], "train", 1), td.dataset(TASKS[1], "train", 1)
    kw = dict(shuffle=True, seed=66666 + 13, drop_last=True,
              collate_kw=COLLATE)
    _assert_batches_equal(list(JP.BatchLoader(jt, np.arange(len(jt)), 16,
                                              **kw)),
                          list(TP.BatchLoader(tt, np.arange(len(tt)), 16,
                                              **kw)))


def test_der_examples_and_collate_match_jax():
    """A DER exemplar replays its pinned target and score, and collate
    stacks the stored logits [B,T,V] f16 (pad rows zero) as JAX's does."""
    jd, td = _modules("smoke")
    rng = np.random.default_rng(5)
    items = []
    for d in td.train_items(TASKS[0])[:3]:
        d = dict(d)
        d["der_logits"] = rng.normal(size=(5, 32)).astype(np.float16)
        d["der_target_ids"] = [7, 1, -100, -100, -100]
        d["der_score"] = 0.5
        items.append(d)
    jds = jd.make_dataset(items, mode="train", task_idx=0)
    tds = td.make_dataset(items, mode="train", task_idx=0)
    jex = [jds.example(i) for i in range(3)]
    tex = [tds.example(i) for i in range(3)]
    for a, b in zip(jex, tex):
        assert b["target_ids"] == a["target_ids"] == [7, 1, -100, -100, -100]
        assert b["score"] == a["score"] == 0.5
    jb = JC.collate(jex, pad_to_batch=4, **COLLATE)["tensors"]
    tb = TC.collate(tex, pad_to_batch=4, **COLLATE)["tensors"]
    assert tb.keys() == jb.keys() and "der_logits" in tb
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tb["der_logits"].shape == (4, 5, 32)
    assert not tb["der_logits"][3].any()
    # without targets no logits are stacked
    assert "der_logits" not in TC.collate(tex, with_targets=False,
                                          **COLLATE)["tensors"]


def test_answer_normalize_matches_jax():
    jd, td = _modules("smoke")
    items = [dict(d, label={"Two Dogs!": 1.0})
             for d in td.train_items(TASKS[0])[:2]]
    for mode in ("train", "val"):
        jds = JP.VQAPartitionDataset(items, JTok(), jd.features, jd.ques_map,
                                     jd.cate_map, mode=mode,
                                     answer_normalize=True)
        tds = TP.VQAPartitionDataset(items, TTok(), td.features, td.ques_map,
                                     td.cate_map, mode=mode,
                                     answer_normalize=True)
        assert tds.example(0)["target_ids"] == jds.example(0)["target_ids"]


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_reraises_a_failed_example(workers):
    """A bad feature row stops the epoch with its error, serial or with
    several workers, instead of ending it early."""
    _, td = _modules("smoke")
    ds = td.dataset(TASKS[0], "train", 0)
    ds.data[5] = dict(ds.data[5], img_id="MISSING")
    loader = TP.BatchLoader(ds, np.arange(len(ds)), 4, shuffle=False,
                            collate_kw=COLLATE, num_workers=workers)
    with pytest.raises(KeyError, match="MISSING"):
        list(loader)
