"""The reference's own inputs: tokens and batches from the raw items.

``encode`` is the VL-T5 tokenizer's word-hash form (a frozen copy: each
lower-cased word → 3 + md5(word) mod 31997, then EOS = 1, truncated to
``max_length``). ``batch`` builds a batch of ``rows`` (padded to ``Bp``
rows) from the benchmark's items and raw f32 feature table, as the
Partition_Q dataset describes one: the ``vqa: {sent}`` prompt, the
answer's tokens with −100 padding, its score, one-hot question-type and
category labels, features and boxes clipped to [0, 1]; pad rows are
zeros with −100 targets.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np
import torch

SP_VOCAB, PAD, EOS = 32000, 0, 1


def encode(text: str, max_length: int) -> List[int]:
    ids = [3 + int.from_bytes(hashlib.md5(w.encode()).digest()[:8],
                              "little") % (SP_VOCAB - 3)
           for w in text.lower().split()]
    return (ids + [EOS])[:max_length]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def features(table, img_ids: Sequence[str], Bp: int, table_dtype: str,
             device) -> Dict[str, torch.Tensor]:
    """vis_feats / boxes [Bp, ...] of ``img_ids`` (pad rows zero), the
    features as the stated table type holds them."""
    n = len(img_ids)
    N, fd = table.feats.shape[1:]
    f = np.zeros((Bp, N, fd), np.float32)
    b = np.zeros((Bp, N, 4), np.float32)
    for i, img in enumerate(img_ids):
        f[i], b[i] = table.get(img)
    f = torch.from_numpy(f).to(device)
    if table_dtype == "bfloat16":
        f[:n] = round_bf16(f[:n])
    return {"vis_feats": f,
            "boxes": torch.from_numpy(np.clip(b, 0.0, 1.0)).to(device)}


def batch(traffic, qids: Sequence, Bp: int, cfg: Dict, table_dtype: str,
          device) -> Dict[str, torch.Tensor]:
    L, T = cfg["max_text_length"], cfg["target_max_length"]
    items = [traffic.by_qid[q] for q in qids]
    ids = np.zeros((Bp, L), np.int64)
    tgt = np.full((Bp, T), -100, np.int64)
    scores = np.zeros((Bp,), np.float32)
    ql = np.zeros((Bp, cfg["n_ques_types"]), np.float32)
    cl = np.zeros((Bp, cfg["n_categories"]), np.float32)
    for i, d in enumerate(items):
        x = encode(f"vqa: {d['sent']}", L)
        ids[i, :len(x)] = x
        (ans, score), = d["label"].items()
        t = encode(ans, T)
        tgt[i, :len(t)] = t
        scores[i] = score
        ql[i, traffic.ques_map[str(d["question_id"])]] = 1.0
        cl[i, traffic.cate_map[str(d["img_id"])]] = 1.0
    out = {"input_ids": torch.from_numpy(ids).to(device),
           "target_ids": torch.from_numpy(tgt).to(device),
           "scores": torch.from_numpy(scores).to(device),
           "ques_labels": torch.from_numpy(ql).to(device),
           "cate_labels": torch.from_numpy(cl).to(device)}
    out.update(features(traffic.table, [d["img_id"] for d in items], Bp,
                        table_dtype, device))
    return out
