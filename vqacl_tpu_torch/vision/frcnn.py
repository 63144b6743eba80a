"""End-to-end 36-box region-feature extractor.

Counterpart of ``vqacl_tpu/vision/frcnn.py``: the reference's offline
pipeline (feature_extraction/detectron2_proposal_maxnms.py ``doit``):
backbone C4 → RPN (300 proposals, N1) → RoIAlign + res5 → mean-pool
2048-d → class/attribute/box heads → class-agnostic max-NMS down to
exactly 36 boxes (threshold sweep 0.5→0.9, N1) → features + boxes in the
record schema the h5 cache stores.

Every stage has a fixed shape and stays on the device: images are
resized shortest-edge-800 (cap 1333) on the host and padded to a few
canonical sizes (``PAD_BUCKETS``), so cuDNN sees a handful of shapes.
Images enter as [H,W,3] BGR (the decoded image's own layout) and are
NCHW from the backbone on. ``_extract_regions_impl`` (and
``extract_regions``/``extract_image``) take an optional ``mark(stage)``
callback, called at the start (``start``) and after each stage
(``backbone``, ``rpn``, ``roi_align``, ``res5_heads``, ``nms36``,
``attr``), which the chip check uses to time the stages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.ops.nms import max_nms_fixed
from vqacl_tpu_torch.ops.roi_align import roi_align
from vqacl_tpu_torch.utils.device import resolve_device
from vqacl_tpu_torch.vision import resnet, rpn

Params = Dict[str, Any]

# VG detector heads (detectron2_proposal_maxnms.py: 1600 classes + bg,
# 400 attributes)
N_CLASSES = 1600
N_ATTRS = 400
PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7754], np.float32)


def init_heads(g: torch.Generator) -> Params:
    d = 2048
    n = lambda *s: torch.randn(s, generator=g)   # noqa: E731
    return {
        "cls_w": 0.01 * n(d, N_CLASSES + 1),
        "cls_b": torch.zeros(N_CLASSES + 1),
        "bbox_w": 0.001 * n(d, 4),                # class-agnostic
        "bbox_b": torch.zeros(4),
        "attr_emb": 0.01 * n(N_CLASSES + 1, 256),
        "attr_fc_w": 0.01 * n(d + 256, 512),
        "attr_fc_b": torch.zeros(512),
        "attr_w": 0.01 * n(512, N_ATTRS + 1),
        "attr_b": torch.zeros(N_ATTRS + 1),
    }


def init_frcnn(seed: int = 0, device="cuda") -> Params:
    """Random detector weights (f32) from ``seed``, drawn on the CPU by a
    ``torch.Generator`` and moved to ``device``: the same weights on
    every device. Conv kernels OIHW, linear weights [in, out]."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    tree = {"backbone": resnet.init_resnet101_c4(g), "rpn": rpn.init_rpn(g),
            "heads": init_heads(g)}

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return node.to(dev)

    return move(tree)


class Regions(NamedTuple):
    features: torch.Tensor   # [36, 2048]
    boxes: torch.Tensor      # [36, 4] pixel xyxy (input-resolution frame)
    obj_id: torch.Tensor     # [36]
    obj_conf: torch.Tensor   # [36]
    attr_id: torch.Tensor    # [36]
    attr_conf: torch.Tensor  # [36]
    valid: torch.Tensor      # [36]


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] BGR → mean-subtracted [B,3,H,W]."""
    mean = torch.as_tensor(PIXEL_MEAN_BGR, device=images.device)
    return (images - mean).permute(0, 3, 1, 2).contiguous()


def _no_mark(stage: str) -> None:
    pass


def _pooled(params: Params, feat: torch.Tensor, boxes: torch.Tensor,
            mark: Callable[[str], None] = _no_mark) -> torch.Tensor:
    """RoIAlign 14×14 on one C4 map [1,C,h,w] (stride 16) → res5 → mean
    pool → [R, 2048]."""
    roi = roi_align(feat[0], boxes, spatial_scale=1.0 / rpn.STRIDE,
                    output_size=(14, 14), sampling_ratio=2, aligned=False)
    mark("roi_align")
    return resnet.res5_head(params["backbone"], roi).mean(dim=(2, 3))


def _regions_tail(params: Params, feat: torch.Tensor,
                  image_hw: torch.Tensor, n_boxes: int, n_proposals: int,
                  mark: Callable[[str], None]) -> Regions:
    """Everything after the backbone, for one image's C4 map [1,C,h,w]."""
    logits, deltas = rpn.rpn_head(params["rpn"], feat)
    anchors = rpn.anchor_grid(feat.shape[2], feat.shape[3], feat.device)
    boxes_all = rpn.decode_deltas(anchors, deltas[0])
    proposals, prop_valid = rpn.select_proposals(
        logits[0], boxes_all, image_hw, post_nms_topk=n_proposals)
    mark("rpn")

    pooled = _pooled(params, feat, proposals, mark)

    h = params["heads"]
    cls_logits = pooled @ h["cls_w"] + h["cls_b"]             # [300,1601]
    probs = torch.softmax(cls_logits, dim=-1)
    # class-agnostic max score, background (col 0) dropped
    # (fast_rcnn_inference_single_image in the reference)
    fg_conf, fg_arg = probs[:, 1:].max(dim=1)
    max_conf = torch.where(prop_valid, fg_conf,
                           torch.tensor(-1.0, device=probs.device))
    cls_id = fg_arg + 1
    mark("res5_heads")

    idx, valid = max_nms_fixed(proposals, max_conf, n_keep=n_boxes)
    mark("nms36")

    sel_pooled = pooled[idx]
    sel_cls = cls_id[idx]
    # attribute head (VG detector: class embedding ‖ pooled → fc → attr)
    emb = h["attr_emb"][sel_cls]
    a = torch.relu(torch.cat([sel_pooled, emb], dim=1) @ h["attr_fc_w"]
                   + h["attr_fc_b"])
    attr_probs = torch.softmax(a @ h["attr_w"] + h["attr_b"], dim=-1)
    attr_conf, attr_arg = attr_probs[:, 1:].max(dim=1)
    mark("attr")
    return Regions(features=sel_pooled, boxes=proposals[idx],
                   obj_id=sel_cls, obj_conf=max_conf[idx],
                   attr_id=attr_arg + 1, attr_conf=attr_conf,
                   valid=valid & prop_valid[idx])


def _extract_regions_impl(params: Params, image: torch.Tensor,
                          image_hw: torch.Tensor, n_boxes: int = 36,
                          n_proposals: int = 300,
                          mark: Optional[Callable[[str], None]] = None
                          ) -> Regions:
    """image [H,W,3] BGR float (raw pixels; the mean is subtracted here),
    image_hw = the true (unpadded) size [2] f32. One image per call; use
    ``extract_regions_batch`` for a batch of one bucket."""
    mark = mark or _no_mark
    mark("start")
    feat = resnet.backbone_c4(params["backbone"], _nchw(image[None]))
    mark("backbone")
    return _regions_tail(params, feat, image_hw, n_boxes, n_proposals, mark)


@torch.inference_mode()
def extract_regions(params: Params, image: torch.Tensor,
                    image_hw: torch.Tensor, n_boxes: int = 36,
                    n_proposals: int = 300,
                    mark: Optional[Callable[[str], None]] = None) -> Regions:
    return _extract_regions_impl(params, image, image_hw, n_boxes,
                                 n_proposals, mark)


@torch.inference_mode()
def extract_regions_batch(params: Params, images: torch.Tensor,
                          image_hw: torch.Tensor, n_boxes: int = 36,
                          n_proposals: int = 300) -> Regions:
    """Batched extraction: images [B,H,W,3] padded to one bucket,
    per-image true sizes image_hw [B,2]. The backbone runs once over the
    batch, the rest image by image; fields stacked to [B, ...]."""
    feat = resnet.backbone_c4(params["backbone"], _nchw(images))
    per = [_regions_tail(params, feat[i:i + 1], image_hw[i], n_boxes,
                         n_proposals, _no_mark)
           for i in range(images.shape[0])]
    return Regions(*(torch.stack(f) for f in zip(*per)))


@torch.inference_mode()
def extract_given_boxes(params: Params, image: torch.Tensor,
                        boxes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Features at caller-provided boxes (the reference's
    detectron2_given_box_maxnms.py: RoI features at GT boxes, no RPN or
    NMS). image [H,W,3] BGR, boxes [R,4] in image pixels →
    (features [R,2048], obj_id [R], obj_conf [R])."""
    feat = resnet.backbone_c4(params["backbone"], _nchw(image[None]))
    pooled = _pooled(params, feat, boxes)
    h = params["heads"]
    probs = torch.softmax(pooled @ h["cls_w"] + h["cls_b"], dim=-1)
    conf, arg = probs[:, 1:].max(dim=1)
    return pooled, arg + 1, conf


# ---------------------------------------------------------------------------
# host side (resize / pad / record)
# ---------------------------------------------------------------------------

def resize_shortest_edge(img: np.ndarray, short: int = 800,
                         max_size: int = 1333) -> Tuple[np.ndarray, float]:
    """PIL-free bilinear resize (processing_image.py semantics)."""
    h, w = img.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    out = (img[y0][:, x0] * (1 - fy) * (1 - fx)
           + img[y0][:, x1] * (1 - fy) * fx
           + img[y1][:, x0] * fy * (1 - fx)
           + img[y1][:, x1] * fy * fx)
    return out.astype(np.float32), scale


PAD_BUCKETS = (512, 640, 800, 1024, 1184, 1344)


def pad_to_bucket(img: np.ndarray) -> np.ndarray:
    """Pad H/W up to the nearest bucket, so the device sees O(buckets²)
    shapes instead of one per image size."""
    h, w = img.shape[:2]
    ph = next((b for b in PAD_BUCKETS if b >= h), h)
    pw = next((b for b in PAD_BUCKETS if b >= w), w)
    out = np.zeros((ph, pw, 3), np.float32)
    out[:h, :w] = img
    return out


def _device_of(params: Params) -> torch.device:
    return params["backbone"]["stem"]["w"].device


def extract_image(params: Params, img_bgr: np.ndarray,
                  n_boxes: int = 36,
                  mark: Optional[Callable[[str], None]] = None
                  ) -> Dict[str, np.ndarray]:
    """Full host pipeline for one raw BGR uint8 image → the reference h5
    record, on the device the weights are on (boxes rescaled to the
    ORIGINAL pixel coords, as detector_postprocess does)."""
    dev = _device_of(params)
    raw_h, raw_w = img_bgr.shape[:2]
    resized, scale = resize_shortest_edge(img_bgr.astype(np.float32))
    hw = np.asarray(resized.shape[:2], np.float32)
    padded = pad_to_bucket(resized)
    regions = extract_regions(params, torch.from_numpy(padded).to(dev),
                              torch.from_numpy(hw).to(dev), n_boxes=n_boxes,
                              mark=mark)
    r = {k: v.cpu().numpy() for k, v in regions._asdict().items()}
    boxes = r["boxes"] / scale
    boxes[:, (0, 2)] = boxes[:, (0, 2)].clip(0, raw_w)
    boxes[:, (1, 3)] = boxes[:, (1, 3)].clip(0, raw_h)
    return {
        "features": r["features"].astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "img_h": raw_h, "img_w": raw_w,
        "obj_id": r["obj_id"].astype(np.int32),
        "obj_conf": r["obj_conf"],
        "attr_id": r["attr_id"].astype(np.int32),
        "attr_conf": r["attr_conf"],
    }
