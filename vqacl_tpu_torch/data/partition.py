"""Partition_Q dataset: per-question-type VQA v2 splits + group loaders
(counterpart of ``vqacl_tpu/data/partition.py``).

The reference's ``VQAFineTuneDataset`` / ``get_loader*``
(``VL-T5/src/vqa_data_memory.py:36-912``):

- reads ``Partition_Q/karpathy_{split}_{task}.json`` items
  ``{img_id, question_id, sent, label{ans:score}, answers?, ...}``;
- per example: region features + [0,1]-clamped boxes, ``vqa: {sent}``
  prompt tokenized to ≤20 ids, answer sampled from the label dict by
  score-weighted multinomial (vqa_data_memory.py:260-276), category
  label from ImgId_cate_map and question-type label from
  QuesId_task_map;
- loaders are dict-of-groups {G1..G5 → iterator} split by the image's
  COCO category (get_loader, :858-912), plus an all-categories test
  loader (get_loader_test, :810) and an exemplar loader
  (get_loader_memory, :756).

As in the JAX package, batches are padded to a static batch size (masked
tail rows carry zero labels and scores, so they add nothing to the loss
or the prototypes), and iteration is plain numpy with a background
prefetch thread. Every random draw (the loader shuffles, the answer
sampling from the dataset's shared stream or, with several workers, from
per-example generators) is the JAX package's, in the same order, so the
same seeds give the same batches bit for bit. With ``slot_of`` set
({img_id: slot}, data/device_cache.py) a dataset's examples carry the
image's slot in the device feature cache instead of its features.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from vqacl_tpu_torch.cl.tasks import CATEGORY_SPLITS
from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.utils.profiling import span


def load_partition(root: str, split: str, task: str) -> List[Dict]:
    """datasets/vqa/Partition_Q/karpathy_{split}_{task}.json"""
    path = os.path.join(root, "vqa", "Partition_Q",
                        f"{split}_{task}.json")
    with open(path) as f:
        return json.load(f)


def load_maps(root: str):
    """QuesId_task_map.json + ImgId_cate_map.json (Question_type.py:29-33)."""
    with open(os.path.join(root, "QuesId_task_map.json")) as f:
        ques_map = json.load(f)
    with open(os.path.join(root, "ImgId_cate_map.json")) as f:
        cate_map = json.load(f)
    return ques_map, cate_map


class VQAPartitionDataset:
    """Examples from one task-split, tokenized + feature-joined lazily."""

    def __init__(self, data: Sequence[Dict], tokenizer, feature_store,
                 ques_map: Mapping[str, int], cate_map: Mapping[str, int],
                 max_text_length: int = 20, target_max_length: int = 10,
                 mode: str = "train", seed: int = 66666,
                 task_idx: Optional[int] = None,
                 answer_normalize: bool = False):
        self.data = list(data)
        self.tok = tokenizer
        self.features = feature_store
        self.ques_map = ques_map
        self.cate_map = cate_map
        self.L = max_text_length
        self.T = target_max_length
        self.mode = mode
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.task_idx = task_idx
        self.answer_normalize = answer_normalize
        # device-cache mode: {img_id: slot}; examples then carry the slot
        # and skip the host feature read
        self.slot_of: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.data)

    def example(self, i: int,
                rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
        """``rng``: answer-sampling stream override. The serial loader
        uses the dataset's shared stream; the multi-worker loader passes a
        per-example generator so the sampled answers are independent of
        worker count and schedule."""
        if rng is None:
            rng = self.rng
        d = self.data[i]
        img_id = d["img_id"]
        sent = d.get("sent", d.get("question"))
        input_ids = self.tok.encode(f"vqa: {sent}", max_length=self.L)
        qid = d["question_id"]
        ex: Dict[str, Any] = {
            "input_ids": input_ids,
            "question_id": qid,
            "sent": sent,
            "ques_label": int(self.ques_map.get(str(qid),
                                                self.task_idx or 0)),
            "cate_label": int(self.cate_map.get(str(img_id),
                                                self.cate_map.get(img_id, 0))),
        }
        if self.slot_of is not None:
            ex["slot"] = int(self.slot_of[str(img_id)])
        else:
            ex["vis_feats"], ex["boxes"] = self.features.get(img_id)
        if "label" in d and d["label"]:
            answers, scores = zip(*d["label"].items())
            ssum = float(sum(scores))
            if ssum <= 0:
                answer, score = "", 0.0
            elif self.mode == "train":
                # score-weighted multinomial (vqa_data_memory.py:268-276)
                p = np.asarray(scores, np.float64) / ssum
                choice = int(rng.choice(len(answers), p=p))
                answer, score = answers[choice], float(scores[choice])
            else:
                choice = int(np.argmax(scores))
                answer, score = answers[choice], float(scores[choice])
            if self.answer_normalize and answer:
                # --answer_normalize (vqa_data_memory.py:254-257)
                from vqacl_tpu_torch.evaluation.vqa_acc import \
                    normalize_answer
                answer = normalize_answer(answer)
            ex["target_ids"] = self.tok.encode(answer, max_length=self.T)
            ex["score"] = score
            ex["answers"] = list(answers)
            ex["label"] = d["label"]
        if "der_logits" in d:
            # DER exemplar (cl/trainer.py::_der_capture): replay with the
            # teacher-forcing target sampled at buffer-insert time; a new
            # multinomial draw here would misalign the stored logits with
            # the decoder inputs
            ex["target_ids"] = [int(x) for x in d["der_target_ids"]]
            ex["score"] = float(d.get("der_score", 1.0))
            ex["der_logits"] = d["der_logits"]
        return ex


def split_by_group(dataset: VQAPartitionDataset,
                   splits: Mapping[str, List[int]] = CATEGORY_SPLITS
                   ) -> Dict[str, List[int]]:
    """Index lists per category group (get_loader semantics: an example
    joins the group containing its image's COCO category)."""
    out: Dict[str, List[int]] = {g: [] for g in splits}
    cate_of = {}
    for g, ids in splits.items():
        for c in ids:
            cate_of[c] = g
    for i, d in enumerate(dataset.data):
        img_id = str(d["img_id"])
        c = dataset.cate_map.get(img_id)
        if c is None:
            continue
        g = cate_of.get(int(c))
        if g is not None:
            out[g].append(i)
    return out


class BatchLoader:
    """Static-shape batch iterator over a set of example indices, with a
    one-deep background prefetch thread (overlaps feature reads and
    tokenizing with device compute).

    ``num_workers > 1`` stands for the reference's
    ``DataLoader(num_workers=4)`` (vqa_data_memory.py:880): N threads
    build whole batches concurrently and a reorder buffer yields them in
    batch order. Answer sampling in this mode draws from a per-example
    generator seeded by (dataset seed, epoch, example index), so it is
    reproducible and invariant to worker count and schedule.
    ``num_workers <= 1`` keeps the single producer, which draws from the
    dataset's shared stream in batch order.

    An iteration that is closed or dropped before its end stops its
    threads: they finish the batch in hand and return. The consumer's
    blocking wait for a batch is the recorder's span ``loader.wait``
    (utils/profiling.py)."""

    def __init__(self, dataset: VQAPartitionDataset, indices: Sequence[int],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 with_targets: bool = True, drop_last: bool = False,
                 collate_kw: Optional[Dict] = None, num_workers: int = 1):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.with_targets = with_targets
        self.drop_last = drop_last
        self.collate_kw = collate_kw or {}
        self.num_workers = max(1, int(num_workers))
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self) -> int:
        return len(self.indices)

    def _make_batches(self) -> Iterator[Dict]:
        order = self._batch_order()
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            exs = [self.dataset.example(int(i)) for i in idx]
            yield collate(exs, pad_to_batch=self.batch_size,
                          with_targets=self.with_targets, **self.collate_kw)

    def _batch_order(self) -> np.ndarray:
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def _build_batch(self, order: np.ndarray, start: int) -> Dict:
        """One collated batch from ``order[start:start+bs]`` with
        per-example generators (multi-worker path)."""
        idx = order[start:start + self.batch_size]
        exs = [self.dataset.example(
                   int(i),
                   rng=np.random.default_rng(
                       (self.dataset.seed, self._epoch, int(i))))
               for i in idx]
        return collate(exs, pad_to_batch=self.batch_size,
                       with_targets=self.with_targets, **self.collate_kw)

    def _iter_parallel(self) -> Iterator[Dict]:
        order = self._batch_order()
        n = len(order)
        starts = list(range(0, n, self.batch_size))
        if self.drop_last and starts and n - starts[-1] < self.batch_size:
            starts.pop()
        n_batches = len(starts)
        next_ticket = [0]
        ticket_lock = threading.Lock()
        done: Dict[int, Any] = {}
        cond = threading.Condition()
        failure: list = []
        stop = threading.Event()
        # workers stay ≤ 2·num_workers batches ahead of the consumer
        window = threading.Semaphore(self.num_workers * 2)

        def worker():
            while True:
                window.acquire()
                with ticket_lock:
                    b = next_ticket[0]
                    if b >= n_batches or failure or stop.is_set():
                        window.release()
                        return
                    next_ticket[0] = b + 1
                try:
                    batch = self._build_batch(order, starts[b])
                except BaseException as e:   # re-raised in the consumer
                    with cond:
                        failure.append(e)
                        cond.notify_all()
                    return
                with cond:
                    done[b] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, max(n_batches, 1)))]
        for t in threads:
            t.start()
        try:
            for b in range(n_batches):
                with cond:
                    if b not in done and not failure:
                        with span("loader.wait"):
                            while b not in done and not failure:
                                cond.wait()
                    if failure:
                        raise failure[0]
                    batch = done.pop(b)
                window.release()
                yield batch
            if failure:
                raise failure[0]
        finally:
            # a worker blocked on the window wakes, sees the flag, passes
            # the release on and returns
            stop.set()
            window.release()

    def __iter__(self) -> Iterator[Dict]:
        self._epoch += 1
        if self.num_workers > 1:
            yield from self._iter_parallel()
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        failure: list = []
        stop = threading.Event()

        def producer():
            try:
                for b in self._make_batches():
                    q.put(b)
                    if stop.is_set():
                        break
            except BaseException as e:  # re-raised in the consumer: a bad
                # feature row must stop the run, not silently end the epoch
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("loader.wait"):
                    item = q.get()
                if item is sentinel:
                    if failure:
                        raise failure[0]
                    break
                yield item
        finally:
            # the producer puts at most its batch in hand and the sentinel
            # into the emptied queue, then returns
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def group_loaders(dataset: VQAPartitionDataset, batch_size: int,
                  shuffle: bool = True, seed: int = 0,
                  with_targets: bool = True,
                  splits: Mapping[str, List[int]] = CATEGORY_SPLITS,
                  **kw) -> Dict[str, BatchLoader]:
    """{G1..G5: BatchLoader} (get_loader, vqa_data_memory.py:858-912).
    ``splits`` swaps in the NExT-QA G0..G4 video-category groups."""
    groups = split_by_group(dataset, splits)
    return {g: BatchLoader(dataset, idx, batch_size, shuffle=shuffle,
                           seed=seed, with_targets=with_targets, **kw)
            for g, idx in groups.items()}


def all_loader(dataset: VQAPartitionDataset, batch_size: int,
               with_targets: bool = False, **kw) -> BatchLoader:
    """All-categories loader (get_loader_test, vqa_data_memory.py:810)."""
    return BatchLoader(dataset, np.arange(len(dataset)), batch_size,
                       shuffle=False, with_targets=with_targets, **kw)
