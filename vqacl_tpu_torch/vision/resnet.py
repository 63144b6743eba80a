"""ResNet-101-C4 backbone (caffe-style), NCHW.

Counterpart of ``vqacl_tpu/vision/resnet.py``: the Detectron2 backbone
the reference uses for region features (feature_extraction/
detectron2_proposal_maxnms.py, config
``faster_rcnn_R_101_C4_attr_caffemaxpool``) and its torch port
(VL-T5/inference/modeling_frcnn.py):

- caffe-style stem: 7×7/2 conv → frozen BN (affine scale/bias) → ReLU →
  3×3/2 max-pool with ceil-mode padding;
- bottleneck stages res2(3)/res3(4)/res4(23) → stride-16 C4 map;
- res5(3) lives in the RoI head (applied per region after RoIAlign),
  stride 2 in its first block;
- BatchNorm is frozen in caffe detection checkpoints and folded to a
  per-channel (scale, bias) pair at conversion time.

Layout: NCHW activations, OIHW conv kernels, ``F.conv2d``. "SAME"
padding is XLA's: at stride 2 it pads less before than after (the 7×7/2
stem on an even size pads 2 and 3), so it is padded explicitly with
``F.pad``. Weights are drawn from a ``torch.Generator`` on the CPU and
then moved, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# (name, n_blocks, out_channels, bottleneck_channels, stride)
R101_STAGES = [
    ("res2", 3, 256, 64, 1),
    ("res3", 4, 512, 128, 2),
    ("res4", 23, 1024, 256, 2),
]
RES5 = ("res5", 3, 2048, 512, 2)


def _conv_init(g: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    # MSRA/caffe init, OIHW; converted checkpoints overwrite this anyway
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return std * torch.randn((cout, cin, kh, kw), generator=g)


def init_conv_bn(g: torch.Generator, kh, kw, cin, cout) -> Params:
    return {
        "w": _conv_init(g, kh, kw, cin, cout),
        "scale": torch.ones(cout),   # folded frozen-BN γ/√var
        "bias": torch.zeros(cout),   # folded β - μγ/√var
    }


def same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding along one axis → (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_bn(p: Params, x: torch.Tensor, stride: int = 1,
            relu: bool = True) -> torch.Tensor:
    """"SAME" conv (OIHW kernel) + folded-BN affine + optional ReLU."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=stride)
    y = y * p["scale"].to(x.dtype)[:, None, None] \
        + p["bias"].to(x.dtype)[:, None, None]
    return F.relu(y) if relu else y


def init_bottleneck(g: torch.Generator, cin, cout, cmid) -> Params:
    p: Params = {
        "conv1": init_conv_bn(g, 1, 1, cin, cmid),
        "conv2": init_conv_bn(g, 3, 3, cmid, cmid),
        "conv3": init_conv_bn(g, 1, 1, cmid, cout),
    }
    if cin != cout:
        p["shortcut"] = init_conv_bn(g, 1, 1, cin, cout)
    return p


def bottleneck(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Caffe ResNet bottleneck: the stride sits on conv1 (1×1), as in the
    caffe R-101 models detectron2's VG detector converts from
    (``stride_in_1x1=True``)."""
    sc = conv_bn(p["shortcut"], x, stride, relu=False) if "shortcut" in p \
        else (x[:, :, ::stride, ::stride] if stride > 1 else x)
    y = conv_bn(p["conv1"], x, stride)
    y = conv_bn(p["conv2"], y, 1)
    y = conv_bn(p["conv3"], y, 1, relu=False)
    return F.relu(y + sc)


def init_stage(g: torch.Generator, n_blocks, cin, cout, cmid) -> Params:
    return {f"block_{i}": init_bottleneck(g, cin if i == 0 else cout, cout,
                                          cmid)
            for i in range(n_blocks)}


def stage(p: Params, x: torch.Tensor, n_blocks: int, stride: int
          ) -> torch.Tensor:
    for i in range(n_blocks):
        x = bottleneck(p[f"block_{i}"], x, stride if i == 0 else 1)
    return x


def init_resnet101_c4(g: torch.Generator) -> Params:
    """Backbone (stem, ``R101_STAGES``) and the RoI head's ``RES5`` as CPU
    f32 tensors drawn from ``g``."""
    p: Params = {"stem": init_conv_bn(g, 7, 7, 3, 64)}
    cin = 64
    for name, n, cout, cmid, _ in R101_STAGES:
        p[name] = init_stage(g, n, cin, cout, cmid)
        cin = cout
    name, n, cout, cmid, _ = RES5
    p[name] = init_stage(g, n, 1024, cout, cmid)
    return p


def caffe_maxpool(x: torch.Tensor) -> torch.Tensor:
    """3×3/2 max pool, caffe ceil mode: pads only bottom and right, with
    -inf, so the output is ceil((H-3)/2)+1."""
    H, W = x.shape[2], x.shape[3]
    out_h = -(-(H - 3) // 2) + 1
    out_w = -(-(W - 3) // 2) + 1
    pad_h = max(0, (out_h - 1) * 2 + 3 - H)
    pad_w = max(0, (out_w - 1) * 2 + 3 - W)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=-math.inf)
    return F.max_pool2d(x, 3, 2)


def backbone_c4(p: Params, images: torch.Tensor) -> torch.Tensor:
    """images NCHW (BGR, caffe-normalized) → stride-16 C4 map
    [B, 1024, H/16, W/16]."""
    x = conv_bn(p["stem"], images, stride=2)
    x = caffe_maxpool(x)
    for name, n, cout, cmid, s in R101_STAGES:
        x = stage(p[name], x, n, s)
    return x


def res5_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-RoI res5: [R, 1024, 14, 14] → [R, 2048, 7, 7] (stride 2)."""
    name, n, cout, cmid, s = RES5
    return stage(p[name], x, n, s)
