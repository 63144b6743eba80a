"""Synthetic DataModule: drives the FULL real pipeline with no artifacts
(counterpart of ``vqacl_tpu/data/synthetic_module.py``; the same seed
gives the same items and features).

Generates Partition_Q-shaped raw items (img_id / question_id / sent /
label / answers), an in-memory feature store, and the two id-maps —
then feeds them through the REAL ``VQAPartitionDataset`` → collate →
group-loader → exemplar path, so CL smoke tests and benches exercise
exactly the code that real data will.

Answers are real words ("ans0".."ansK") tokenized through the same
tokenizer the model decodes with, so generated strings round-trip and
the official VQA accuracy math runs unmodified.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from vqacl_tpu_torch.cl.tasks import ALL_TASKS
from vqacl_tpu_torch.data.features import MemoryFeatureStore
from vqacl_tpu_torch.data.partition import VQAPartitionDataset
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.evaluation.vqa_acc import VQAEvaluator

_Q_WORDS = ["what", "where", "is", "why", "how many", "doing",
            "color", "kind", "sub type", "because"]


class SyntheticDataModule:
    def __init__(self, tokenizer: VLT5Tokenizer,
                 tasks: Sequence[str] = ALL_TASKS,
                 n_train_per_task: int = 100, n_val_per_task: int = 20,
                 n_test_per_task: int = 20, feat_dim: int = 2048,
                 n_boxes: int = 36, n_categories: int = 80,
                 answer_vocab: int = 8, seed: int = 0,
                 n_images: Optional[int] = None,
                 task_shift: int = 0,
                 category_in_text: bool = True,
                 residue_centroids: bool = False):
        """``n_images``: size of the shared image pool (None → one image
        per question). Real VQA v2 has ~7 questions/image; a bounded
        pool keeps large-scale soaks within host/HBM budgets.

        ``task_shift``: answer = ans[(c + t_idx·task_shift) % vocab] —
        with a nonzero shift the SAME visual category maps to a
        DIFFERENT answer under each task (question type), so training
        task k overwrites earlier tasks' mappings unless the learner
        retains them (replay / prototypes). This is the forgetting
        pressure of the real VQACL protocol in miniature; the default 0
        keeps the task-agnostic easy mapping for smoke tests. The task
        identity is learnable from the question's leading words.

        ``category_in_text``: when True (default, smoke-test mode) the
        question text names the image's category, so the answer is
        readable off the text alone. The Table-1 surrogate sets False:
        the category is then only recoverable from the VISUAL features,
        which is the regime where the paper's V-prototype retrieval
        (a nearest-class-mean signal appended to the encoder output)
        has a mechanism to help — mirroring real VQA, where the
        question never names the object.

        ``residue_centroids``: when True, category centroids cluster by
        answer residue ``c % answer_vocab`` — a shared residue direction
        dominates, with per-category jitter keeping all ``n_categories``
        centroids distinct (so the V-prototype bank and the category
        group loaders still see 80 classes). This makes the
        answer-relevant visual signal ``answer_vocab``-way instead of
        ``n_categories``-way, i.e. LEARNABLE within the surrogate's
        ~200-step-per-task budget — without it a tiny model never gets
        above chance and no CL method can separate from any other."""
        self.tok = tokenizer
        self.tasks = list(tasks)
        self.feat_dim = feat_dim
        self.n_boxes = n_boxes
        rng = np.random.default_rng(seed)
        if residue_centroids:
            res_dir = rng.normal(
                size=(answer_vocab, feat_dim)).astype(np.float32)
            jitter = rng.normal(
                size=(n_categories, feat_dim)).astype(np.float32)
            self._centroids = (
                res_dir[np.arange(n_categories) % answer_vocab]
                + 0.25 * jitter)
        else:
            self._centroids = rng.normal(
                size=(n_categories, feat_dim)).astype(np.float32)
        self.features = MemoryFeatureStore()
        self.cate_map: Dict[str, int] = {}
        self.ques_map: Dict[str, int] = {}
        self._items: Dict[str, Dict[str, List[dict]]] = {}

        def new_image(c: int) -> str:
            img_id = f"synt_{len(self.cate_map)}"
            feats = (self._centroids[c][None] + 0.3 * rng.normal(
                size=(n_boxes, feat_dim))).astype(np.float32)
            x1y1 = rng.uniform(0, 0.5, size=(n_boxes, 2))
            wh = rng.uniform(0.1, 0.5, size=(n_boxes, 2))
            boxes = np.concatenate(
                [x1y1, np.clip(x1y1 + wh, 0, 1)], axis=1).astype(np.float32)
            self.features.put(img_id, feats, boxes)
            self.cate_map[img_id] = c
            return img_id

        pool: List[str] = []
        if n_images is not None:
            for _ in range(n_images):
                pool.append(new_image(int(rng.integers(0, n_categories))))

        qid = 0
        for t_idx, task in enumerate(self.tasks):
            per_split = {"train": n_train_per_task, "val": n_val_per_task,
                         "test": n_test_per_task}
            self._items[task] = {}
            for split, n in per_split.items():
                items = []
                for _ in range(n):
                    if pool:
                        img_id = pool[int(rng.integers(0, len(pool)))]
                        c = self.cate_map[img_id]
                    else:
                        c = int(rng.integers(0, n_categories))
                        img_id = new_image(c)
                    # answer determined by the image category (appears in
                    # both the features and the question text); with
                    # task_shift != 0 the mapping is task-DEPENDENT
                    ans = f"ans{(c + t_idx * task_shift) % answer_vocab}"
                    self.ques_map[str(qid)] = t_idx
                    sent = (f"{_Q_WORDS[t_idx % len(_Q_WORDS)]} is the "
                            f"object category {c}" if category_in_text
                            else f"{_Q_WORDS[t_idx % len(_Q_WORDS)]} is "
                                 f"the object in the image")
                    items.append({
                        "img_id": img_id,
                        "question_id": qid,
                        "sent": sent,
                        "label": {ans: 1.0},
                        "answers": [{"answer": ans}] * 10,
                        "question_type": task,
                        "answer_type": "other",
                    })
                    qid += 1
                self._items[task][split] = items

    # ---- DataModule interface -------------------------------------------
    def train_items(self, task: str) -> List[dict]:
        return self._items[task]["train"]

    def make_dataset(self, items: Sequence[dict], mode: str = "train",
                     task_idx: Optional[int] = None) -> VQAPartitionDataset:
        return VQAPartitionDataset(
            items, self.tok, self.features, self.ques_map, self.cate_map,
            mode=mode, task_idx=task_idx)

    def dataset(self, task: str, split: str,
                task_idx: Optional[int] = None) -> VQAPartitionDataset:
        mode = "train" if split == "train" else "val"
        return self.make_dataset(self._items[task][split], mode=mode,
                                 task_idx=task_idx)

    def evaluator(self, task: str, loader=None):
        id2datum, id2datum_gt = {}, {}
        for split_items in self._items[task].values():
            for d in split_items:
                id2datum[d["question_id"]] = d
                id2datum_gt[d["question_id"]] = {
                    "answers": d["answers"],
                    "question_type": d["question_type"],
                    "answer_type": d["answer_type"],
                }
        ev = VQAEvaluator(id2datum=id2datum, id2datum_gt=id2datum_gt)

        def score(quesid2ans):
            out = ev.evaluate_raw(quesid2ans)
            out["topk_score"] = ev.evaluate(quesid2ans)
            return out

        return score
