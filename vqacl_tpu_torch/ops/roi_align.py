"""RoIAlign / RoIPool as plain PyTorch gathers and weighted sums.

Counterpart of ``vqacl_tpu/ops/roi_align.py``: the torchvision ops the
reference leans on (``RoIPool`` in VL-T5/inference/modeling_frcnn.py,
Detectron2's RoIAlign in feature_extraction/
detectron2_proposal_maxnms.py), with torchvision's semantics:

- ``roi_align``: continuous coordinates, the ``aligned`` half-pixel
  shift, ``sampling_ratio`` bilinear samples per output cell averaged
  (an explicit ratio: the adaptive -1 is data-dependent), samples
  outside the map give 0;
- ``roi_pool``: integer-quantised bins (exact integer floor/ceil), max
  over each bin, 0 for an empty bin.

The same arithmetic on every device: one gather of the four corners plus
a weighted sum. The map is gathered as rows of channels ([H·W, C], one
``index_select`` per corner), so each sample reads C contiguous floats.
At the extractor's shape (300 RoIs, 1024 channels, 28×28 samples) one
gathered corner is ~1 GB in f32, so ``roi_align`` works through the RoIs
in chunks whose corner stays under ``CHUNK_BYTES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

# bytes of one gathered corner per chunk of RoIs
CHUNK_BYTES = 128 << 20


def _bilinear_gather(rows: torch.Tensor, H: int, W: int, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """rows [H·W, C] (the map, one row per pixel); y/x same-shaped sample
    grids → [*y.shape, C]. Out-of-bounds samples → 0 (torchvision
    semantics). Each corner is one ``index_select`` of whole rows."""
    C = rows.shape[1]
    oob = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = y.clamp(0.0, H - 1)
    x = x.clamp(0.0, W - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx

    def g(yy, xx):
        return rows.index_select(0, (yy * W + xx).reshape(-1)).reshape(
            y.shape + (C,))

    val = (g(y0, x0) * (hy * hx)[..., None] + g(y0, x1) * (hy * lx)[..., None]
           + g(y1, x0) * (ly * hx)[..., None]
           + g(y1, x1) * (ly * lx)[..., None])
    return torch.where(oob[..., None], torch.zeros((), dtype=val.dtype,
                                                   device=val.device), val)


def roi_align(feat: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float = 1.0,
              output_size: Tuple[int, int] = (14, 14),
              sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """feat [C,H,W]; rois [R,4] (x1,y1,x2,y2) in input coords →
    [R, C, out_h, out_w]."""
    C, H, W = feat.shape
    out_h, out_w = output_size
    sr = sampling_ratio
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_w = roi_w / out_w
    bin_h = roi_h / out_h

    dev = feat.device
    ar_h = torch.arange(out_h * sr, device=dev)
    ar_w = torch.arange(out_w * sr, device=dev)
    iy, fy = ar_h // sr, (ar_h % sr + 0.5) / sr
    ix, fx = ar_w // sr, (ar_w % sr + 0.5) / sr
    ys = y1[:, None] + (iy + fy)[None] * bin_h[:, None]     # [R, oh·sr]
    xs = x1[:, None] + (ix + fx)[None] * bin_w[:, None]     # [R, ow·sr]
    R = rois.shape[0]
    grid = (R, out_h * sr, out_w * sr)
    rows = feat.reshape(C, H * W).t().contiguous()          # [H·W, C]
    per_roi = C * out_h * sr * out_w * sr * feat.element_size()
    step = max(1, CHUNK_BYTES // per_roi)
    out = []
    for r0 in range(0, R, step):
        sl = slice(r0, min(R, r0 + step))
        n = sl.stop - r0
        gy = ys[sl, :, None].expand(n, *grid[1:])
        gx = xs[sl, None, :].expand(n, *grid[1:])
        v = _bilinear_gather(rows, H, W, gy, gx)     # [n, oh·sr, ow·sr, C]
        v = v.reshape(n, out_h, sr, out_w, sr, C).mean(dim=(2, 4))
        out.append(v.permute(0, 3, 1, 2))
    if not out:
        return feat.new_zeros((0, C, out_h, out_w))
    return torch.cat(out).contiguous()


def roi_pool(feat: torch.Tensor, rois: torch.Tensor,
             spatial_scale: float = 1.0,
             output_size: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """torchvision RoIPool: quantized bins, max-pool each bin.
    feat [C,H,W]; rois [R,4] → [R,C,out_h,out_w].

    Each bin's max is a masked max over the whole H×W map, one bin at a
    time (static shapes, as in JAX)."""
    C, H, W = feat.shape
    out_h, out_w = output_size
    dev = feat.device
    x1 = torch.round(rois[:, 0] * spatial_scale).int()
    y1 = torch.round(rois[:, 1] * spatial_scale).int()
    x2 = torch.round(rois[:, 2] * spatial_scale).int()
    y2 = torch.round(rois[:, 3] * spatial_scale).int()
    roi_w = (x2 - x1).clamp(min=1)
    roi_h = (y2 - y1).clamp(min=1)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    out = feat.new_zeros((rois.shape[0], C, out_h, out_w))
    for ph in range(out_h):
        # exact integer floor/ceil of the bin edges
        h0 = (y1 + (ph * roi_h) // out_h).clamp(0, H)
        h1 = (y1 + ((ph + 1) * roi_h + out_h - 1) // out_h).clamp(0, H)
        for pw in range(out_w):
            w0 = (x1 + (pw * roi_w) // out_w).clamp(0, W)
            w1 = (x1 + ((pw + 1) * roi_w + out_w - 1) // out_w).clamp(0, W)
            m = ((ys[None, :, None] >= h0[:, None, None])
                 & (ys[None, :, None] < h1[:, None, None])
                 & (xs[None, None, :] >= w0[:, None, None])
                 & (xs[None, None, :] < w1[:, None, None]))   # [R,H,W]
            v = torch.where(m[:, None], feat[None],
                            torch.tensor(float("-inf"), device=dev,
                                         dtype=feat.dtype)).amax(dim=(2, 3))
            empty = ~m.flatten(1).any(dim=1)
            out[:, :, ph, pw] = torch.where(empty[:, None],
                                            torch.zeros_like(v), v)
    return out
