"""Real VQA v2 DataModule over the reference artifact layout (counterpart
of ``vqacl_tpu/data/vqa_module.py``).

Consumes exactly the artifacts of SURVEY §2.2:
  {root}/vqa/Partition_Q/karpathy_{split}_{task}.json
  {root}/QuesId_task_map.json, {root}/ImgId_cate_map.json
  {root}/COCO/features/{source}_obj36.h5   (or .vfpack converts)
  {root}/vqa/v2_mscoco_{train2014,val2014}_annotations.json (official eval)

and plugs into VQACLTrainer via the DataModule interface. Feature files
route by source substring like the reference (train2014/val2014/
test2015); the h5 files need ``h5py``, the pack does not. The official-eval ground truth prefers the v2 annotation
files; absent those it falls back to the 10-answer lists inside the
partition items.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from vqacl_tpu_torch.cl.tasks import ALL_TASKS
from vqacl_tpu_torch.data.features import H5FeatureStore
from vqacl_tpu_torch.data.partition import (VQAPartitionDataset, load_maps,
                                      load_partition)
from vqacl_tpu_torch.evaluation.vqa_acc import VQAEvaluator


class VQADataModule:
    def __init__(self, root: str, tokenizer,
                 tasks: Sequence[str] = ALL_TASKS,
                 feature_store=None,
                 train_split: str = "karpathy_train",
                 valid_split: str = "karpathy_val",
                 test_split: str = "karpathy_test",
                 train_topk: int = -1, valid_topk: int = -1,
                 seed: int = 66666):
        self.root = root
        self.tok = tokenizer
        self.tasks = list(tasks)
        self.seed = seed
        self.splits = {"train": train_split, "val": valid_split,
                       "test": test_split}
        self.topk = {"train": train_topk, "val": valid_topk,
                     "test": valid_topk}
        self.ques_map, self.cate_map = load_maps(root)
        if feature_store is None:
            feat_dir = os.path.join(root, "COCO", "features")
            pack = os.path.join(feat_dir, "coco_obj36.vfpack")
            if os.path.exists(pack):
                # native mmap pack tier (data/packed_cache.py) when the
                # one-time conversion has been run
                from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
                feature_store = PackedFeatureStore(pack)
            else:
                sources = {}
                for source in ("train2014", "val2014", "test2015"):
                    path = os.path.join(feat_dir, f"{source}_obj36.h5")
                    if os.path.exists(path):
                        sources[source] = path
                feature_store = H5FeatureStore(sources)
        self.features = feature_store
        self._cache: Dict[str, Dict[str, List[dict]]] = {}
        self._gt = None

    # ------------------------------------------------------------------
    def _items(self, task: str, split: str) -> List[dict]:
        self._cache.setdefault(task, {})
        if split not in self._cache[task]:
            items = load_partition(self.root, self.splits[split], task)
            k = self.topk[split]
            if k and k > 0:
                items = items[:k]
            self._cache[task][split] = items
        return self._cache[task][split]

    def train_items(self, task: str) -> List[dict]:
        return self._items(task, "train")

    def make_dataset(self, items, mode="train",
                     task_idx: Optional[int] = None) -> VQAPartitionDataset:
        return VQAPartitionDataset(items, self.tok, self.features,
                                   self.ques_map, self.cate_map,
                                   mode=mode, seed=self.seed,
                                   task_idx=task_idx)

    def dataset(self, task, split, task_idx=None) -> VQAPartitionDataset:
        mode = "train" if split == "train" else "val"
        return self.make_dataset(self._items(task, split), mode=mode,
                                 task_idx=task_idx)

    # ------------------------------------------------------------------
    def _load_gt(self) -> Dict[int, dict]:
        """Official GT from v2_mscoco annotations (VQADataset,
        vqa_data_memory.py:933-970)."""
        if self._gt is None:
            self._gt = {}
            for name in ("v2_mscoco_train2014_annotations.json",
                         "v2_mscoco_val2014_annotations.json"):
                path = os.path.join(self.root, "vqa", name)
                if os.path.exists(path):
                    with open(path) as f:
                        for ann in json.load(f)["annotations"]:
                            self._gt[int(ann["question_id"])] = {
                                "answers": ann["answers"],
                                "question_type": ann["question_type"],
                                "answer_type": ann["answer_type"],
                            }
        return self._gt

    def evaluator(self, task: str, loader=None):
        id2datum: Dict[int, dict] = {}
        id2datum_gt = dict(self._load_gt())
        for split in ("train", "val", "test"):
            for d in self._items(task, split):
                qid = int(d["question_id"])
                id2datum[qid] = d
                if qid not in id2datum_gt and "answers" in d:
                    answers = d["answers"]
                    if answers and isinstance(answers[0], str):
                        answers = [{"answer": a} for a in answers]
                    id2datum_gt[qid] = {
                        "answers": answers,
                        "question_type": d.get("question_type", "unknown"),
                        "answer_type": d.get("answer_type", "other"),
                    }
        ev = VQAEvaluator(id2datum=id2datum, id2datum_gt=id2datum_gt)

        def score(quesid2ans):
            qa = {int(q): a for q, a in quesid2ans.items()}
            out = ev.evaluate_raw(qa)
            try:
                out["topk_score"] = ev.evaluate(qa)
            except KeyError:
                out["topk_score"] = 0.0
            return out

        return score
