"""Fixed-shape NMS: class-agnostic max-score suppression with the
reference's exactly-36-boxes threshold-sweep semantics.

Counterpart of ``vqacl_tpu/ops/nms.py``. The reference pipeline
(feature_extraction/detectron2_proposal_maxnms.py:43-132) does, per
image: per-box class score = max over 1600 classes (background
dropped); torchvision ``nms(boxes, max_scores, thresh)``; sweep thresh
0.5→0.9 in 0.1 steps until ≥36 boxes survive, then keep the top 36 by
score. Here, as in JAX, the sweep is one program with no trip to the
host: the greedy suppression runs at all thresholds at once, the first
threshold with ≥36 survivors is picked on the device, and when even 0.9
keeps fewer than 36 the rows are padded with the best suppressed boxes
(the reference would raise IndexError there).

``greedy_nms`` is the greedy suppression itself (N1). On CUDA tensors it
launches the kernel of ``csrc/nms.cu`` (the note at its top says what
bounds it) or raises, counting each launch in ``greedy_nms.launches``;
on CPU tensors it takes the plain loop ``greedy_nms_reference``. Both
``max_nms_fixed`` and the RPN's ``select_proposals`` call it.

Sorts are stable and score-descending (``argsort(-s, stable=True)``),
so ties keep index order, as torchvision's sort and JAX's do.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

DEFAULT_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)
# the kernel's limits: boxes (its scratch mask is T·N·⌈N/64⌉ words) and
# thresholds at once
NMS_MAX_N = 16384
NMS_MAX_T = 8


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a [N,4], b [M,4] in (x1,y1,x2,y2) → [N,M].
    Areas use (x2-x1)*(y2-y1) (torchvision convention, no +1)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def greedy_nms_reference(boxes: torch.Tensor, valid: torch.Tensor,
                         thresholds: torch.Tensor) -> torch.Tensor:
    """Plain version of N1. boxes [N,4] f32 in score order, valid [N]
    bool, thresholds [T] f32 → keep [T,N] bool: box i is kept at
    threshold t iff it is valid and no earlier kept box has IoU > t with
    it."""
    over = box_iou(boxes, boxes)[None] > thresholds[:, None, None]  # [T,N,N]
    N = boxes.shape[0]
    kept = torch.zeros((thresholds.shape[0], N), dtype=torch.bool,
                       device=boxes.device)
    for i in range(N):
        suppressed = (kept[:, :i] & over[:, :i, i]).any(dim=1)
        kept[:, i] = valid[i] & ~suppressed
    return kept


def _validate(boxes: torch.Tensor, valid: torch.Tensor,
              thresholds: torch.Tensor) -> None:
    if boxes.dim() != 2 or boxes.shape[1] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError(f"greedy_nms: boxes must be [N,4] float32, got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    N = boxes.shape[0]
    if valid.shape != (N,) or valid.dtype != torch.bool:
        raise ValueError(f"greedy_nms: valid must be [{N}] bool, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if thresholds.dim() != 1 or thresholds.dtype != torch.float32:
        raise ValueError(f"greedy_nms: thresholds must be [T] float32, got "
                         f"{thresholds.dtype} {tuple(thresholds.shape)}")
    T = thresholds.shape[0]
    if not 1 <= N <= NMS_MAX_N:
        raise ValueError(f"greedy_nms: N={N} boxes, the kernel takes 1.."
                         f"{NMS_MAX_N}")
    if not 1 <= T <= NMS_MAX_T:
        raise ValueError(f"greedy_nms: T={T} thresholds, the kernel takes "
                         f"1..{NMS_MAX_T}")
    if not (boxes.device == valid.device == thresholds.device):
        raise ValueError("greedy_nms: boxes, valid and thresholds on "
                         "different devices")


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor,
               thresholds: torch.Tensor) -> torch.Tensor:
    """Greedy suppression over score-sorted ``boxes`` [N,4] f32 with a
    validity mask [N] bool at thresholds [T] f32 → keep [T,N] bool: the
    kernel N1 on CUDA tensors, the plain loop on CPU tensors. N and T are
    checked before any launch."""
    _validate(boxes, valid, thresholds)
    if boxes.device.type == "cpu":
        return greedy_nms_reference(boxes, valid, thresholds)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {boxes.device}")
    from vqacl_tpu_torch.ops import _build

    boxes, valid = boxes.contiguous(), valid.contiguous()
    thresholds = thresholds.contiguous()
    N, T = boxes.shape[0], thresholds.shape[0]
    lib = _build.load("nms")
    scratch = torch.empty((T, N, (N + 63) // 64), dtype=torch.int64,
                          device=boxes.device)
    keep = torch.empty((T, N), dtype=torch.bool, device=boxes.device)
    stream = ctypes.c_void_p(
        torch.cuda.current_stream(boxes.device).cuda_stream)
    err = lib.greedy_nms(boxes.data_ptr(), valid.data_ptr(),
                         thresholds.data_ptr(), scratch.data_ptr(),
                         keep.data_ptr(), N, T, stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms launch failed: "
                           f"{lib.greedy_nms_error_string(err).decode()}")
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0


def _nms_sweep_masks(boxes: torch.Tensor, scores: torch.Tensor,
                     thresholds: torch.Tensor) -> torch.Tensor:
    """[T, N] keep-masks in SCORE-SORTED order, all thresholds at once."""
    order = torch.argsort(-scores, stable=True)
    valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    return greedy_nms(boxes[order], valid, thresholds)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask (original box order). Single threshold."""
    thr = torch.tensor([iou_threshold], dtype=torch.float32,
                       device=boxes.device)
    keep_sorted = _nms_sweep_masks(boxes, scores, thr)[0]
    order = torch.argsort(-scores, stable=True)
    mask = torch.zeros(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    mask[order] = keep_sorted
    return mask


def max_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                  n_keep: int = 36,
                  thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full reference sweep → exactly ``n_keep`` box indices.

    boxes [N,4], scores [N] (already class-maxed). Returns (indices
    [n_keep] into the input arrays, valid [n_keep] bool — False only on
    pad rows when even the loosest threshold keeps < n_keep). Nothing
    leaves the device."""
    thr = torch.tensor(tuple(thresholds), dtype=torch.float32,
                       device=boxes.device)
    kept = _nms_sweep_masks(boxes, scores, thr)           # [T, N] sorted
    enough = kept.sum(dim=1) >= n_keep                    # [T]
    # first threshold with ≥ n_keep survivors; fall back to the last
    t_idx = torch.where(enough.any(), enough.int().argmax(),
                        torch.tensor(thr.shape[0] - 1, device=boxes.device))
    mask = kept[t_idx]                                    # [N] sorted order
    # kept boxes first (stable: score order kept), then the
    # highest-scoring suppressed boxes
    order = torch.argsort(-scores, stable=True)
    rank = torch.argsort((~mask).to(torch.uint8), stable=True)
    sel_sorted = rank[:n_keep]
    return order[sel_sorted], mask[sel_sorted]
