"""The QA generator: questions, answers and a feature table from the seed.

A frozen copy of what ``vqacl_tpu_torch/data/synthetic_module.py`` makes,
driven by a mix file (``traffic/<mix>.json``): an image (or video) pool
whose features cluster around a centroid per category
(``centroid[c] + noise·N(0, 1)`` per region or clip), and Partition_Q
items ``{img_id, question_id, sent, label, answers, question_type}`` whose
answer is ``ans{(c + task·task_shift) % answer_vocab}`` for the image's
category ``c``. The features are drawn on the device by one
``torch.Generator`` in chunks of ``CHUNK`` images and kept on the host in
f32, the form the port's feature stores hand out; the items come from a
numpy generator. Both streams start from the seed, so the same seed
gives the same items and features.

Mix keys: ``tasks`` (the protocol's task names, in order), ``groups``
(category group → category ids), ``images``, ``categories``,
``answer_vocab``, ``task_shift``, ``noise``, ``boxes`` ("random" boxes
as the synthetic module draws them, or "whole_frame" [0, 0, 1, 1], as
NExT-QA's clips), ``question`` (``{"style": "category"}``: the synthetic
module's sentence naming the category; ``{"style": "words", "min_words",
"max_words"}``: a task word and random words from ``WORDS``), and
``splits``, a list of ``{"task": index, "split": name, "qa": count}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# the synthetic module's leading question words, one per task index
Q_WORDS = ["what", "where", "is", "why", "how many", "doing", "color",
           "kind", "sub type", "because"]
WORDS = ["the", "a", "man", "woman", "boy", "girl", "dog", "cat", "ball",
         "table", "after", "before", "while", "did", "does", "do", "with",
         "in", "on", "at", "video", "first", "end", "start", "hold", "play",
         "walk", "look", "pick", "up", "down", "baby", "toy", "room"]
CHUNK = 1024


@dataclass
class FeatureTable:
    """feats [n, N, feat_dim] f32 and boxes [n, N, 4] f32 on the host, one
    row per id; ``get`` hands out views, as the port's stores do."""
    ids: List[str]
    feats: np.ndarray
    boxes: np.ndarray
    row: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self.row = {k: i for i, k in enumerate(self.ids)}

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        i = self.row[str(img_id)]
        return self.feats[i], self.boxes[i]

    def __contains__(self, img_id: str) -> bool:
        return str(img_id) in self.row


@dataclass
class Traffic:
    tasks: List[str]
    groups: Dict[str, List[int]]
    items: Dict[str, Dict[str, List[dict]]]
    cate_map: Dict[str, int]
    ques_map: Dict[str, int]
    table: FeatureTable
    by_qid: Dict[Any, dict] = field(default_factory=dict)

    def __post_init__(self):
        self.by_qid = {d["question_id"]: d
                       for splits in self.items.values()
                       for items in splits.values() for d in items}


def _question(rng: np.random.Generator, style: Dict[str, Any], t: int,
              c: int) -> str:
    lead = Q_WORDS[t % len(Q_WORDS)]
    if style["style"] == "category":
        return f"{lead} is the object category {c}"
    k = int(rng.integers(style["min_words"], style["max_words"] + 1))
    words = rng.choice(len(WORDS), size=k)
    return " ".join([lead] + [WORDS[int(w)] for w in words])


def feature_table(mix: Dict[str, Any], n_boxes: int, feat_dim: int,
                  seed: int, device) -> Tuple[FeatureTable, np.ndarray]:
    """The pool's features (on the host) and categories [n] from the
    seed: categories from numpy, features on ``device``."""
    n, n_cat = int(mix["images"]), int(mix["categories"])
    rng = np.random.default_rng([int(seed), 1])
    cats = rng.integers(0, n_cat, size=n)
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 7 + 3) % (2 ** 63))
    cent = torch.randn((n_cat, feat_dim), generator=g, device=device)
    feats = torch.empty((n, n_boxes, feat_dim), dtype=torch.float32)
    boxes = torch.empty((n, n_boxes, 4), dtype=torch.float32)
    cats_dev = torch.from_numpy(cats).to(device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        noise = torch.randn((e - s, n_boxes, feat_dim), generator=g,
                            device=device)
        feats[s:e].copy_(cent[cats_dev[s:e]][:, None, :]
                         + float(mix["noise"]) * noise)
        if mix["boxes"] == "random":
            x1y1 = 0.5 * torch.rand((e - s, n_boxes, 2), generator=g,
                                    device=device)
            wh = 0.1 + 0.4 * torch.rand((e - s, n_boxes, 2), generator=g,
                                        device=device)
            boxes[s:e].copy_(torch.cat([x1y1, (x1y1 + wh).clamp(0.0, 1.0)],
                                       dim=-1))
        elif mix["boxes"] == "whole_frame":
            boxes[s:e] = torch.tensor([0.0, 0.0, 1.0, 1.0])
        else:
            raise ValueError(f"boxes {mix['boxes']!r}")
    ids = [f"img_{i}" for i in range(n)]
    return FeatureTable(ids, feats.numpy(), boxes.numpy()), cats


def make(mix: Dict[str, Any], config: Dict[str, Any], seed: int,
         device) -> Traffic:
    """The mix's items and feature table for the model sizes ``config``
    from ``seed``."""
    table, cats = feature_table(mix, config["n_boxes"], config["feat_dim"],
                                seed, device)
    rng = np.random.default_rng([int(seed), 2])
    tasks = list(mix["tasks"])
    vocab, shift = int(mix["answer_vocab"]), int(mix.get("task_shift", 0))
    items: Dict[str, Dict[str, List[dict]]] = {t: {} for t in tasks}
    cate_map = {img: int(c) for img, c in zip(table.ids, cats)}
    ques_map: Dict[str, int] = {}
    qid = 0
    for part in mix["splits"]:
        t = int(part["task"])
        n = int(part["qa"])
        imgs = rng.integers(0, len(table.ids), size=n)
        out = []
        for i in imgs:
            img = table.ids[int(i)]
            c = cate_map[img]
            ans = f"ans{(c + t * shift) % vocab}"
            ques_map[str(qid)] = t
            out.append({"img_id": img, "question_id": qid,
                        "sent": _question(rng, mix["question"], t, c),
                        "label": {ans: 1.0},
                        "answers": [{"answer": ans}] * 10,
                        "question_type": tasks[t], "answer_type": "other"})
            qid += 1
        items[tasks[t]].setdefault(part["split"], []).extend(out)
    groups = {g: [int(c) for c in ids] for g, ids in mix["groups"].items()}
    return Traffic(tasks, groups, items, cate_map, ques_map, table)
