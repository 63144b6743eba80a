"""Kinetics 3D-ResNeXt-101 (the motion backbone), NCDHW.

Counterpart of ``vqacl_tpu/vision/resnext3d.py``. NExT-QA's
``app_mot_{mode}.h5`` motion half comes from a Kinetics-pretrained 3D
ResNeXt-101 (Hara et al., CVPR 2018: the ``resnext-101-kinetics.pth``
checkpoint of 3D-ResNets-PyTorch, applied at 16 clips × 16 frames ×
112² per video). This module is that architecture with ``F.conv3d``
(grouped where ResNeXt groups) and a converter from the published
checkpoint's state dict:

- stem: 7×7×7 conv, stride (1,2,2), pad 3, 64 ch → BN → ReLU → 3×3×3
  max-pool stride 2 pad 1;
- 4 stages of ResNeXt bottlenecks (expansion 2, cardinality 32,
  ``mid = cardinality * planes // 32``): layers (3, 4, 23, 3), planes
  (128, 256, 512, 1024), stride 2 on stages 2-4 (on the grouped 3×3×3
  conv); a 1×1×1 conv + BN shortcut whenever the shape changes;
- global average pool over (D, H, W) → the 2048-d clip feature (the fc
  classifier is dropped).

BatchNorm is folded to per-channel (scale, bias) at conversion. Padding
is torch's symmetric padding. Conv kernels are OIDHW, [O, I/groups,
kD, kH, kW], so the groups of a conv are recovered from its kernel's
shape and its input's channels.

Input: clips [B, 3, T, S, S] RGB float in [0, 255] minus the Kinetics
activity mean (``preprocess_clip`` gives [T, S, S, 3] per clip).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from vqacl_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

CARDINALITY = 32
EXPANSION = 2
# (n_blocks, planes, stride)
R3D101_STAGES = [(3, 128, 1), (4, 256, 2), (23, 512, 2), (3, 1024, 2)]
FEAT_DIM = 2048
CLIP_LEN = 16
SAMPLE_SIZE = 112
# ActivityNet mean of 3D-ResNets-PyTorch (its published Kinetics
# checkpoints were trained with this mean, RGB order, [0,255] scale)
KINETICS_MEAN_RGB = (114.7748, 107.7354, 99.4750)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def conv_bn3d(p: Params, x: torch.Tensor, stride=(1, 1, 1), pad=0,
              relu: bool = True) -> torch.Tensor:
    """3D conv (OIDHW kernel, symmetric ``pad``) + folded-BN affine +
    optional ReLU; groups = input channels / the kernel's I/groups."""
    w = p["w"].to(x.dtype)
    y = F.conv3d(x, w, stride=stride, padding=pad,
                 groups=x.shape[1] // w.shape[1])
    y = y * p["scale"].to(x.dtype)[:, None, None, None] \
        + p["bias"].to(x.dtype)[:, None, None, None]
    return F.relu(y) if relu else y


def bottleneck3d(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """ResNeXt bottleneck: 1×1×1 → grouped 3×3×3 (the stride here) →
    1×1×1; identity or projection shortcut."""
    s3 = (stride, stride, stride)
    sc = conv_bn3d(p["shortcut"], x, s3, 0, relu=False) \
        if "shortcut" in p else x
    y = conv_bn3d(p["conv1"], x)
    y = conv_bn3d(p["conv2"], y, s3, 1)
    y = conv_bn3d(p["conv3"], y, relu=False)
    return F.relu(y + sc)


def maxpool3d(x: torch.Tensor) -> torch.Tensor:
    """3×3×3 / stride 2 / pad 1 max pool (floor mode, -inf padding)."""
    return F.max_pool3d(x, 3, 2, padding=1)


def resnext3d_features(p: Params, clips: torch.Tensor, stages=None
                       ) -> torch.Tensor:
    """[B, 3, T, S, S] preprocessed RGB clips → [B, 2048] pooled
    stage-4 features (global D,H,W mean == the classifier checkpoint's
    AvgPool3d at the canonical geometry)."""
    x = conv_bn3d(p["stem"], clips, (1, 2, 2), 3)
    x = maxpool3d(x)
    for si, (n, planes, stride) in enumerate(stages or R3D101_STAGES):
        st = p[f"stage_{si}"]
        for b in range(n):
            x = bottleneck3d(st[f"block_{b}"], x, stride if b == 0 else 1)
    return x.mean(dim=(2, 3, 4))


def preprocess_clip(frames_rgb: np.ndarray) -> np.ndarray:
    """uint8/float RGB [T, S, S, 3] in [0,255] → mean-subtracted f32
    (the 3D-ResNets-PyTorch eval normalization: mean only, no std)."""
    return np.asarray(frames_rgb, np.float32) - np.asarray(
        KINETICS_MEAN_RGB, np.float32)


# ---------------------------------------------------------------------------
# init (random weights — converted checkpoints overwrite these)
# ---------------------------------------------------------------------------

def _init_conv_bn3d(g: torch.Generator, kd, kh, kw, cin, cout,
                    groups: int = 1) -> Params:
    std = (2.0 / (kd * kh * kw * (cin // groups))) ** 0.5
    return {"w": std * torch.randn((cout, cin // groups, kd, kh, kw),
                                   generator=g),
            "scale": torch.ones(cout), "bias": torch.zeros(cout)}


def init_resnext3d(seed: int = 0, stages=None,
                   cardinality: int = CARDINALITY, device="cuda") -> Params:
    """Random weights (f32) from ``seed``, drawn on the CPU by a
    ``torch.Generator`` and moved to ``device``."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    stages = stages or R3D101_STAGES
    p: Params = {"stem": _init_conv_bn3d(g, 7, 7, 7, 3, 64)}
    cin = 64
    for si, (n, planes, _) in enumerate(stages):
        mid = cardinality * (planes // 32)
        cout = planes * EXPANSION
        st: Params = {}
        for b in range(n):
            blk: Params = {
                "conv1": _init_conv_bn3d(g, 1, 1, 1,
                                         cin if b == 0 else cout, mid),
                "conv2": _init_conv_bn3d(g, 3, 3, 3, mid, mid,
                                         groups=cardinality),
                "conv3": _init_conv_bn3d(g, 1, 1, 1, mid, cout),
            }
            if b == 0 and cin != cout:
                blk["shortcut"] = _init_conv_bn3d(g, 1, 1, 1, cin, cout)
            st[f"block_{b}"] = blk
        p[f"stage_{si}"] = st
        cin = cout

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return node.to(dev)

    return move(p)


# ---------------------------------------------------------------------------
# torch-checkpoint converter
# ---------------------------------------------------------------------------

def _fold(sd: Mapping[str, np.ndarray], conv_key: str, bn_key: str,
          used: set) -> Params:
    from vqacl_tpu_torch.vision.convert_weights import fold_bn
    scale, bias = fold_bn(sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"],
                          sd[f"{bn_key}.running_mean"],
                          sd[f"{bn_key}.running_var"])
    used.update({f"{conv_key}.weight", f"{bn_key}.weight", f"{bn_key}.bias",
                 f"{bn_key}.running_mean", f"{bn_key}.running_var"})
    w = np.asarray(sd[f"{conv_key}.weight"], np.float32)   # OIDHW already
    return {"w": torch.from_numpy(np.ascontiguousarray(w)),
            "scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}


def from_torch_state_dict(sd: Mapping[str, Any], stages=None) -> Params:
    """3D-ResNets-PyTorch ``resnext-101-kinetics.pth`` state dict (its
    ``state_dict`` entry; ``module.`` DataParallel prefixes accepted) →
    this module's tree (CPU f32 tensors). The classifier ``fc.*`` is
    dropped; every other entry must be consumed (layout drift raises)."""
    def arr(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)

    sd = {(k[7:] if k.startswith("module.") else k): arr(v)
          for k, v in sd.items()}
    # fc.* (classifier, dropped) and BN bookkeeping counters are ignored
    used: set = set(k for k in sd if k.startswith("fc.")
                    or k.endswith(".num_batches_tracked"))
    p: Params = {"stem": _fold(sd, "conv1", "bn1", used)}
    for si, (n, _, _) in enumerate(stages or R3D101_STAGES):
        st: Params = {}
        for b in range(n):
            pre = f"layer{si + 1}.{b}"
            blk: Params = {
                f"conv{i}": _fold(sd, f"{pre}.conv{i}", f"{pre}.bn{i}", used)
                for i in (1, 2, 3)}
            if f"{pre}.downsample.0.weight" in sd:
                blk["shortcut"] = _fold(sd, f"{pre}.downsample.0",
                                        f"{pre}.downsample.1", used)
            st[f"block_{b}"] = blk
        p[f"stage_{si}"] = st
    leftover = set(sd) - used
    if leftover:
        raise ValueError(f"unconsumed checkpoint entries: {sorted(leftover)}")
    return p


def load_torch_checkpoint(path: str, stages=None) -> Params:
    """Load ``resnext-101-kinetics.pth`` (a ``torch.save`` dict with a
    ``state_dict`` entry, or a bare state dict) → CPU tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return from_torch_state_dict(sd, stages=stages)
