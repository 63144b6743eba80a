"""NExT-QA video-QA continual-learning data path (counterpart of
``vqacl_tpu/nextqa/data.py``).

Rebuild of VL-T5/nextqa/nextqa_data.py + nextqa/
Question_type.py for the 8-task video protocol:

- CSV partitions ``Partition_Q_v2/{mode}_{type}.csv`` with columns
  video, qid, question, answer, type, bigCate (:99-117);
- video features ``vid_feat/app_mot_{mode}.h5``: per-video
  ``feat[16, 4096]`` = 16 clips × [appearance 2048 ‖ motion 2048]; the
  reference uses ONLY the motion half (:143-149) — kept;
- 16 clips become 16 pseudo-region tokens with dummy [0,0,1,1] boxes
  (:172-186); question ≤23 tokens, answer ≤6 (:194-207);
- category label = bigCate − 1 (:160), groups G0..G4 over video object
  categories (nextqa/Question_type.py:11-15);
- WUPS-0 scoring with stopword removal, exact match for CC/CB, optional
  per-video extra reference answers (:950-1026).

The dual-level trainer is reused unchanged: this module plugs into
``VQACLTrainer`` via the same DataModule interface, overriding
``category_splits``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from vqacl_tpu_torch.data.partition import VQAPartitionDataset
from vqacl_tpu_torch.evaluation.vqa_acc import (process_digit_article,
                                          process_punctuation)
from vqacl_tpu_torch.evaluation.wups import get_wups, remove_stopwords

NEXTQA_TASKS = ["CW", "TN", "TC", "DL", "DB", "DC", "DO", "CH"]

# nextqa/Question_type.py:11-15
NEXTQA_SPLITS: Dict[str, List[int]] = {
    "G0": [50, 60, 15, 32, 79, 27, 53, 20, 36, 28, 24, 80, 41, 33, 18, 10],
    "G1": [54, 5, 57, 49, 69, 62, 7, 1, 14, 35, 56, 66, 58, 51, 46, 6],
    "G2": [59, 61, 74, 37, 47, 34, 19, 72, 75, 23, 63, 40, 67, 21, 73, 29],
    "G3": [22, 2, 48, 64, 68, 9, 65, 26, 45, 12, 8, 76, 55, 4, 77, 44],
    "G4": [78, 17, 52, 11, 30, 13, 38, 70, 25, 3, 43, 42, 39, 16, 71, 31],
}
# group ids are 1-based bigCate; img_cate labels are bigCate-1
NEXTQA_SPLITS_0BASED = {g: [c - 1 for c in ids]
                        for g, ids in NEXTQA_SPLITS.items()}

N_CLIPS = 16
FEAT_DIM = 2048
TEXT_LEN = 23
ANS_LEN = 6


def load_partition_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


def dummy_boxes() -> np.ndarray:
    """16 whole-frame pseudo-boxes (nextqa_data.py:172-186)."""
    b = np.zeros((N_CLIPS, 4), np.float32)
    b[:, 2] = 1.0
    b[:, 3] = 1.0
    return b


class VideoFeatureStore:
    """app_mot h5 → motion-half clip features keyed by video id."""

    def __init__(self, h5_path: Optional[str] = None,
                 table: Optional[Dict[str, np.ndarray]] = None):
        self._boxes = dummy_boxes()
        self.table: Dict[str, np.ndarray] = dict(table or {})
        if h5_path is not None:
            import h5py
            with h5py.File(h5_path, "r") as fp:
                vids = fp["ids"][()]
                feats = fp["feat"][()]
            for vid, feat in zip(vids, feats):
                key = vid.decode() if isinstance(vid, bytes) else str(vid)
                self.table[key] = np.asarray(feat[:, FEAT_DIM:], np.float32)

    def put(self, video: str, motion_feat: np.ndarray) -> None:
        self.table[str(video)] = np.asarray(motion_feat, np.float32)

    def get(self, video: str):
        return self.table[str(video)], self._boxes


def items_from_rows(rows: Sequence[Mapping]) -> List[dict]:
    """CSV rows → partition-dataset items (answer as a 1.0-score label)."""
    items = []
    for r in rows:
        qid = f"{r['video']}_{r['qid']}"
        items.append({
            "img_id": str(r["video"]),
            "question_id": qid,
            "sent": str(r["question"]),
            "label": {str(r["answer"]): 1.0},
            "answers": [{"answer": str(r["answer"])}],
            "question_type": str(r["type"]),
            "answer_type": "open",
            "bigCate": int(r["bigCate"]),
            "video": str(r["video"]),
            "qid": str(r["qid"]),
        })
    return items


class NextQAEvaluator:
    """WUPS-0 open-ended scoring (nextqa_data.py:949-1026)."""

    def __init__(self, id2datum: Mapping[str, dict],
                 add_reference: Optional[Mapping] = None):
        self.id2datum = dict(id2datum)
        self.add_ref = dict(add_reference or {})

    @staticmethod
    def _norm(ans: str) -> str:
        ans = ans.replace("\n", " ").replace("\t", " ").strip()
        ans = process_punctuation(ans)
        ans = process_digit_article(ans)
        return remove_stopwords(ans)

    def evaluate_raw(self, quesid2ans: Mapping[str, str]) -> Dict[str, float]:
        score = 0.0
        coverage = [0, 0]           # word pairs resolved / scored by WUPS
        for qid, res in quesid2ans.items():
            d = self.id2datum[qid]
            res_n = self._norm(res)
            gt_n = self._norm(d["gt_answer"])
            qtype = d["type"]
            extra = None
            video = d.get("video")
            if video in self.add_ref:
                raw = self.add_ref[video].get(d.get("qid"))
                if raw is not None:
                    extra = self._norm(raw)
            if qtype in ("CC", "CB"):
                cur = float(res_n == gt_n or (extra is not None
                                              and res_n == extra))
            else:
                cur = get_wups(res_n, gt_n, 0, coverage=coverage)
                if extra is not None:
                    cur = max(cur, get_wups(res_n, extra, 0,
                                            coverage=coverage))
            score += cur
        n = max(len(quesid2ans), 1)
        from vqacl_tpu_torch.evaluation.wups import wups_backend
        return {"overall": 100.0 * score / n,
                # surface which similarity source scored this run and how
                # much of it resolved to real Wu-Palmer values vs the
                # exact-match fallback (VERDICT r1/r2: a degraded eval
                # must be visibly degraded)
                "wups_backend": wups_backend(),
                "wups_vocab_coverage": (coverage[0] / coverage[1]
                                        if coverage[1] else 1.0)}


class NextQADataModule:
    """DataModule over {task: {split: items}} + per-split feature stores.

    Use ``from_root`` for the reference CSV/h5 artifact layout; the
    direct constructor takes prebuilt tables (synthetic tests)."""

    category_splits = NEXTQA_SPLITS_0BASED

    def __init__(self, tokenizer,
                 rows: Dict[str, Dict[str, List[dict]]],
                 features: Dict[str, VideoFeatureStore],
                 tasks: Sequence[str] = NEXTQA_TASKS,
                 add_reference: Optional[Mapping] = None):
        self.tok = tokenizer
        self.tasks = list(tasks)
        self.features = features
        self.add_ref = dict(add_reference or {})
        self._rows = rows
        self.cate_map: Dict[str, int] = {}
        self.ques_map: Dict[str, int] = {}
        for task in self.tasks:
            for items in self._rows[task].values():
                for d in items:
                    self.cate_map[d["img_id"]] = d["bigCate"] - 1
                    self.ques_map[str(d["question_id"])] = \
                        self.tasks.index(task)

    @classmethod
    def from_root(cls, root: str, tokenizer,
                  tasks: Sequence[str] = NEXTQA_TASKS,
                  add_reference_path: Optional[str] = None
                  ) -> "NextQADataModule":
        features = {
            mode: VideoFeatureStore(
                os.path.join(root, "vid_feat", f"app_mot_{mode}.h5"))
            for mode in ("train", "val", "test")
        }
        add_ref = None
        if add_reference_path and os.path.exists(add_reference_path):
            with open(add_reference_path) as f:
                add_ref = json.load(f)
        rows: Dict[str, Dict[str, List[dict]]] = {}
        for task in tasks:
            rows[task] = {}
            for mode in ("train", "val", "test"):
                path = os.path.join(root, "Partition_Q_v2",
                                    f"{mode}_{task}.csv")
                rows[task][mode] = items_from_rows(load_partition_csv(path)) \
                    if os.path.exists(path) else []
        return cls(tokenizer, rows, features, tasks, add_ref)

    def train_items(self, task: str) -> List[dict]:
        return self._rows[task]["train"]

    def make_dataset(self, items, mode="train", task_idx=None,
                     feature_mode: str = "train") -> VQAPartitionDataset:
        return VQAPartitionDataset(
            items, self.tok, self.features[feature_mode], self.ques_map,
            self.cate_map, max_text_length=TEXT_LEN,
            target_max_length=ANS_LEN, mode=mode, task_idx=task_idx)

    def dataset(self, task, split, task_idx=None) -> VQAPartitionDataset:
        mode = "train" if split == "train" else "val"
        fmode = split if split in ("train", "val", "test") else "val"
        return self.make_dataset(self._rows[task][split], mode=mode,
                                 task_idx=task_idx, feature_mode=fmode)

    def evaluator(self, task: str, loader=None):
        id2datum = {}
        for split_items in self._rows[task].values():
            for d in split_items:
                id2datum[d["question_id"]] = {
                    "gt_answer": next(iter(d["label"])),
                    "type": d["question_type"],
                    "video": d["video"], "qid": d["qid"],
                }
        ev = NextQAEvaluator(id2datum, self.add_ref)

        def score(quesid2ans):
            out = ev.evaluate_raw(quesid2ans)
            out["topk_score"] = out["overall"] / 100.0
            return out

        return score
