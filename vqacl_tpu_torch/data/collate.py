"""Static-shape batch collation (counterpart of ``vqacl_tpu/data/collate.py``).

Every batch is padded to the global geometry (text 20, boxes 36, answer
10) and, with ``pad_to_batch``, to a fixed batch size, so the serving
path sees one set of shapes. Produces numpy arrays:
  input_ids   [B, L]   int32, pad=0
  vis_feats   [B, N, feat_dim] float32
  boxes       [B, N, 4]    float32 (x1,y1,x2,y2 clipped to [0,1])
  target_ids  [B, T]   int32, -100 on padding (only ``with_targets``)
  scores      [B]      float32
  ques_labels [B, n_ques_types]  float32 one-hot
  cate_labels [B, n_categories]  float32 one-hot
  der_logits  [B, T, V] float16 (DER replay examples only)
In slot mode (examples that carry ``"slot"``, an index into the device
feature cache, data/device_cache.py) ``slots`` [B] int32 replaces
vis_feats and boxes, with −1 in the pad rows (the cache gives them
zeros), plus host-side metadata (question_ids, sents, answers, n_real).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np


def collate(examples: Sequence[Dict[str, Any]],
            max_text_length: int = 20,
            n_boxes: int = 36,
            target_max_length: int = 10,
            n_ques_types: int = 10,
            n_categories: int = 80,
            feat_dim: int = 2048,
            pad_to_batch: Optional[int] = None,
            with_targets: bool = True) -> Dict[str, Any]:
    """examples: dicts with input_ids (list[int]), vis_feats [N,feat_dim]
    and boxes [N,4] (or slot (int)), ques_label (int), cate_label (int),
    and optionally target_ids, score, question_id, sent, answers,
    der_logits [T,V]."""
    B = len(examples)
    Bp = pad_to_batch or B
    L, N, T = max_text_length, n_boxes, target_max_length
    slot_mode = B > 0 and "slot" in examples[0]

    input_ids = np.zeros((Bp, L), np.int32)
    if slot_mode:
        slots = np.full((Bp,), -1, np.int32)
    else:
        vis_feats = np.zeros((Bp, N, feat_dim), np.float32)
        boxes = np.zeros((Bp, N, 4), np.float32)
    scores = np.zeros((Bp,), np.float32)
    ques_labels = np.zeros((Bp, n_ques_types), np.float32)
    cate_labels = np.zeros((Bp, n_categories), np.float32)
    target_ids = np.full((Bp, T), -100, np.int32) if with_targets else None
    # DER replay batches carry the logits stored at buffer-insert time
    # (cl/trainer.py::_der_capture), f16 on the host. Pad rows stay zero:
    # their targets are all -100, so the loss masks them.
    der_logits = None
    if B > 0 and with_targets and "der_logits" in examples[0]:
        V = int(np.asarray(examples[0]["der_logits"]).shape[-1])
        der_logits = np.zeros((Bp, T, V), np.float16)

    question_ids, sents, answers = [], [], []
    for i, ex in enumerate(examples):
        ids = ex["input_ids"][:L]
        input_ids[i, :len(ids)] = ids
        if slot_mode:
            slots[i] = ex["slot"]
        else:
            vis_feats[i] = ex["vis_feats"]
            boxes[i] = np.clip(ex["boxes"], 0.0, 1.0)
        if with_targets and "target_ids" in ex:
            t = ex["target_ids"][:T]
            target_ids[i, :len(t)] = t
            scores[i] = ex.get("score", 1.0)
        if der_logits is not None:
            z = np.asarray(ex["der_logits"], np.float16)
            der_logits[i, :z.shape[0]] = z[:T]
        ques_labels[i, ex["ques_label"]] = 1.0
        cate_labels[i, ex["cate_label"]] = 1.0
        question_ids.append(ex.get("question_id", i))
        sents.append(ex.get("sent", ""))
        answers.append(ex.get("answers"))

    batch: Dict[str, Any] = {
        "input_ids": input_ids,
        "scores": scores,
        "ques_labels": ques_labels,
        "cate_labels": cate_labels,
    }
    if slot_mode:
        batch["slots"] = slots
    else:
        batch["vis_feats"] = vis_feats
        batch["boxes"] = boxes
    if with_targets:
        batch["target_ids"] = target_ids
    if der_logits is not None:
        batch["der_logits"] = der_logits
    meta = {"question_ids": question_ids, "sents": sents,
            "answers": answers, "n_real": B}
    return {"tensors": batch, "meta": meta}
