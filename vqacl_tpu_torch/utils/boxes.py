"""Small box utilities (parity with the reference's VL-T5/src/utils.py).

numpy only: the same functions as ``vqacl_tpu/utils/boxes.py``.
"""

from __future__ import annotations

import numpy as np


def get_area(pos: np.ndarray) -> np.ndarray:
    """utils.py:8-21 — area from (x1,x2,y1,y2)-documented layout,
    computed as (pos[...,3]-pos[...,2])*(pos[...,1]-pos[...,0])."""
    return (pos[..., 3] - pos[..., 2]) * (pos[..., 1] - pos[..., 0])


def get_relative_distance(pos: np.ndarray) -> np.ndarray:
    """utils.py:23-37 — pairwise box-coordinate differences
    [B, N, N, 4]."""
    return pos[:, :, None, :] - pos[:, None, :, :]


def get_iou(anchors: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """utils.py:91-133 — IoU between anchors [N,4] and gt [K,4] in
    (x1,y1,x2,y2), +1 pixel convention (legacy detection style)."""
    N = anchors.shape[0]
    K = gt_boxes.shape[0]
    gt_area = ((gt_boxes[:, 2] - gt_boxes[:, 0] + 1)
               * (gt_boxes[:, 3] - gt_boxes[:, 1] + 1)).reshape(1, K)
    anchor_area = ((anchors[:, 2] - anchors[:, 0] + 1)
                   * (anchors[:, 3] - anchors[:, 1] + 1)).reshape(N, 1)
    boxes = np.repeat(anchors.reshape(N, 1, 4), K, axis=1)
    query = np.repeat(gt_boxes.reshape(1, K, 4), N, axis=0)
    iw = (np.minimum(boxes[:, :, 2], query[:, :, 2])
          - np.maximum(boxes[:, :, 0], query[:, :, 0]) + 1)
    iw[iw < 0] = 0
    ih = (np.minimum(boxes[:, :, 3], query[:, :, 3])
          - np.maximum(boxes[:, :, 1], query[:, :, 1]) + 1)
    ih[ih < 0] = 0
    ua = anchor_area + gt_area - iw * ih
    return iw * ih / ua


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """utils.py:136-138 — (x,y,w,h) → (x1,y1,x2,y2), w/h−1 convention."""
    return np.hstack((boxes[:, 0:2],
                      boxes[:, 0:2] + boxes[:, 2:4] - 1))
