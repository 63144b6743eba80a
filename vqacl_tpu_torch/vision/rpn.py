"""Region Proposal Network + proposal selection, fixed shapes.

Counterpart of ``vqacl_tpu/vision/rpn.py``: the RPN the reference drives
through Detectron2 (RPN_POST_NMS 300) and its torch port
(VL-T5/inference/modeling_frcnn.py: ``AnchorGenerator``, ``RPNHead``,
``find_top_rpn_proposals``, ``Box2BoxTransform``):

- 15 anchors per cell (sizes 32..512 × aspects 0.5/1/2) on the stride-16
  map;
- 3×3 conv → objectness [A] + deltas [4A];
- decode deltas (dw/dh clamped at log(1000/16)), clip to the image, drop
  empty boxes, top-K pre-NMS, IoU-0.7 greedy NMS (N1 on the card),
  top-300 post-NMS.

"A variable number of proposals" is a fixed [300] set with a validity
mask: boxes that cannot be kept score -inf, rank last (ties in index
order, as ``lax.top_k`` ranks them) and are never kept.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vqacl_tpu_torch.ops import nms
from vqacl_tpu_torch.ops.topk import top_k

Params = Dict[str, Any]

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_ASPECTS = (0.5, 1.0, 2.0)
STRIDE = 16
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def num_anchors() -> int:
    return len(ANCHOR_SIZES) * len(ANCHOR_ASPECTS)


def init_rpn(g: torch.Generator, cin: int = 1024) -> Params:
    """RPN head weights (OIHW) as CPU f32 tensors drawn from ``g``."""
    A = num_anchors()
    std = (2.0 / (9 * cin)) ** 0.5
    return {
        "conv_w": std * torch.randn((cin, cin, 3, 3), generator=g),
        "conv_b": torch.zeros(cin),
        "obj_w": 0.01 * torch.randn((A, cin, 1, 1), generator=g),
        "obj_b": torch.zeros(A),
        "delta_w": 0.01 * torch.randn((4 * A, cin, 1, 1), generator=g),
        "delta_b": torch.zeros(4 * A),
    }


def anchor_grid(feat_h: int, feat_w: int, device="cpu") -> torch.Tensor:
    """[H*W*A, 4] anchors in input-pixel coords (x1,y1,x2,y2): centres at
    (x·stride, y·stride) plus base anchors centred at 0, in (h, w, a)
    order, as the torch port of the reference places them."""
    base = []
    for size in ANCHOR_SIZES:
        area = float(size * size)
        for aspect in ANCHOR_ASPECTS:
            w = (area / aspect) ** 0.5
            h = aspect * w
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base_a = torch.tensor(base, dtype=torch.float32, device=device)  # [A,4]
    ys = torch.arange(feat_h, dtype=torch.float32, device=device) * STRIDE
    xs = torch.arange(feat_w, dtype=torch.float32, device=device) * STRIDE
    shift_x, shift_y = torch.meshgrid(xs, ys, indexing="xy")       # [H, W]
    shifts = torch.stack([shift_x, shift_y, shift_x, shift_y], -1)  # [H,W,4]
    anchors = shifts[:, :, None, :] + base_a[None, None]         # [H,W,A,4]
    return anchors.reshape(-1, 4)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas (modeling_frcnn.py)."""
    wx, wy, ww, wh = weights
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[:, 3] / wh, max=BBOX_XFORM_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=1)


def rpn_head(p: Params, feat: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [B,C,H,W] → (logits [B,H*W*A], deltas [B,H*W*A,4]), anchors
    in (h, w, a) order; delta channels grouped per anchor (a0: x,y,w,h,
    a1: ...)."""
    dt = feat.dtype
    x = F.relu(F.conv2d(feat, p["conv_w"].to(dt), padding=1)
               + p["conv_b"].to(dt)[:, None, None])
    obj = F.conv2d(x, p["obj_w"].to(dt)).float() \
        + p["obj_b"].float()[:, None, None]
    dl = F.conv2d(x, p["delta_w"].to(dt)).float() \
        + p["delta_b"].float()[:, None, None]
    B, A, H, W = obj.shape
    return (obj.permute(0, 2, 3, 1).reshape(B, H * W * A),
            dl.permute(0, 2, 3, 1).reshape(B, H * W * A, 4))


def select_proposals(logits: torch.Tensor, boxes: torch.Tensor,
                     image_hw: torch.Tensor,
                     pre_nms_topk: int = 6000,
                     post_nms_topk: int = 300,
                     nms_thresh: float = 0.7,
                     min_size: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image: decoded boxes [N,4] + logits [N] → (proposals
    [min(post_nms_topk, k), 4], valid mask), k = min(pre_nms_topk, N).
    Masked greedy NMS (N1 on CUDA tensors), nothing leaves the device."""
    h, w = image_hw[0], image_hw[1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[:, 0], zero), w),
        torch.minimum(torch.maximum(boxes[:, 1], zero), h),
        torch.minimum(torch.maximum(boxes[:, 2], zero), w),
        torch.minimum(torch.maximum(boxes[:, 3], zero), h)], dim=1)
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    keepable = (bw > min_size) & (bh > min_size)
    scores = torch.where(keepable, logits,
                         torch.tensor(-math.inf, device=logits.device))

    k = min(pre_nms_topk, scores.shape[0])
    top_scores, top_idx = top_k(scores, k)
    top_boxes = boxes[top_idx]

    # greedy NMS over the top-k (score-sorted already)
    thr = torch.tensor([nms_thresh], dtype=torch.float32,
                       device=boxes.device)
    kept = nms.greedy_nms(top_boxes, torch.isfinite(top_scores), thr)[0]
    rank = torch.argsort((~kept).to(torch.uint8), stable=True)[:post_nms_topk]
    return top_boxes[rank], kept[rank]
