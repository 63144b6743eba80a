"""Detector weight conversion: caffe2 VG checkpoint → the port's tree,
and the bridge to the JAX package's tree.

Counterpart of ``vqacl_tpu/vision/convert_weights.py``. The reference
loads detectron2's ``faster_rcnn_R_101_C4_attr_caffemaxpool`` caffe2
weights: a pickle of caffe2-named arrays (``res4_22_branch2c_w``,
``conv1_bn_s`` …, OIHW conv kernels, frozen-BN scale/bias pairs). This
module maps that naming onto the ResNet/RPN/head tree of
``vision/frcnn.py``:

- conv ``*_w`` [O,I,kh,kw] stays OIHW (the port's layout);
- frozen BN ``*_bn_s``/``*_bn_b`` → the (scale, bias) of
  ``vision.resnet.conv_bn`` (``fold_bn`` folds raw γ,β,μ,σ²);
- branch2a/2b/2c → conv1/2/3, branch1 → shortcut;
- RPN ``conv_rpn_*``, ``rpn_cls_logits_*``, ``rpn_bbox_pred_*``;
- box head ``cls_score_*``, ``bbox_pred_*``; attribute head ``*attr*``
  (linear weights [in, out], as the JAX tree keeps them).

``from_jax_params``/``to_jax_params`` move a tree between the packages:
every key kept, 4-D kernels HWIO ↔ OIHW and 5-D kernels (the 3D
ResNeXt's) DHWIO ↔ OIDHW, everything else as it is. The ``.npz`` files
keep the JAX package's flat keys and HWIO, so one file loads into both.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]

_STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 23, "res5": 3}
# the JAX layout → the port's, by kernel rank (HWIO → OIHW, DHWIO → OIDHW)
_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    scale = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    bias = np.asarray(beta) - np.asarray(mean) * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _conv_bn(sd: Mapping[str, np.ndarray], name: str) -> Params:
    out = {"w": _t(sd[f"{name}_w"])}
    if f"{name}_bn_s" in sd:
        out["scale"] = _t(sd[f"{name}_bn_s"])
        out["bias"] = _t(sd[f"{name}_bn_b"])
    elif f"{name}_bn_gamma" in sd:
        scale, bias = fold_bn(
            sd[f"{name}_bn_gamma"], sd[f"{name}_bn_beta"],
            sd[f"{name}_bn_running_mean"], sd[f"{name}_bn_running_var"])
        out["scale"], out["bias"] = _t(scale), _t(bias)
    else:
        cout = out["w"].shape[0]
        out["scale"] = torch.ones(cout)
        out["bias"] = _t(sd.get(f"{name}_b", np.zeros((cout,))))
    return out


def from_caffe2_dict(sd: Mapping[str, np.ndarray]) -> Params:
    """caffe2 name→array dict → the port's FRCNN tree (backbone + rpn +
    heads, CPU f32 tensors; missing heads are left absent for the caller
    to init)."""
    backbone: Params = {"stem": _conv_bn(sd, "conv1")}
    for stage, n_blocks in _STAGE_BLOCKS.items():
        sp: Params = {}
        for i in range(n_blocks):
            blk: Params = {
                "conv1": _conv_bn(sd, f"{stage}_{i}_branch2a"),
                "conv2": _conv_bn(sd, f"{stage}_{i}_branch2b"),
                "conv3": _conv_bn(sd, f"{stage}_{i}_branch2c"),
            }
            if f"{stage}_{i}_branch1_w" in sd:
                blk["shortcut"] = _conv_bn(sd, f"{stage}_{i}_branch1")
            sp[f"block_{i}"] = blk
        backbone[stage] = sp

    params: Params = {"backbone": backbone}

    if "conv_rpn_w" in sd:
        params["rpn"] = {
            "conv_w": _t(sd["conv_rpn_w"]),
            "conv_b": _t(sd["conv_rpn_b"]),
            "obj_w": _t(sd["rpn_cls_logits_w"]),
            "obj_b": _t(sd["rpn_cls_logits_b"]),
            "delta_w": _t(sd["rpn_bbox_pred_w"]),
            "delta_b": _t(sd["rpn_bbox_pred_b"]),
        }

    heads: Params = {}
    if "cls_score_w" in sd:
        heads["cls_w"] = _t(np.asarray(sd["cls_score_w"]).T)
        heads["cls_b"] = _t(sd["cls_score_b"])
    if "bbox_pred_w" in sd:
        heads["bbox_w"] = _t(np.asarray(sd["bbox_pred_w"]).T)
        heads["bbox_b"] = _t(sd["bbox_pred_b"])
    for key in sd:
        if "cls_embedding" in key and key.endswith("_w"):
            heads["attr_emb"] = _t(sd[key])
        if "attr_fc" in key and key.endswith("_w"):
            heads["attr_fc_w"] = _t(np.asarray(sd[key]).T)
        if "attr_fc" in key and key.endswith("_b"):
            heads["attr_fc_b"] = _t(sd[key])
        if key in ("attr_score_w", "attr_logits_w"):
            heads["attr_w"] = _t(np.asarray(sd[key]).T)
        if key in ("attr_score_b", "attr_logits_b"):
            heads["attr_b"] = _t(sd[key])
    if heads:
        params["heads"] = heads
    return params


def load_caffe2_pkl(path: str) -> Params:
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data) if isinstance(data, dict) else data
    blobs = {k: v for k, v in blobs.items()
             if isinstance(v, np.ndarray)}
    return from_caffe2_dict(blobs)


# ---- the bridge to the JAX package's tree -------------------------------

def from_jax_params(tree: Params, device="cpu") -> Params:
    """A JAX detector (or 3D ResNeXt) tree of arrays → the port's tree of
    f32 tensors on ``device``: HWIO → OIHW, DHWIO → OIDHW, every key
    kept."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if a.ndim in _TO_TORCH:
            a = a.transpose(_TO_TORCH[a.ndim])
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return walk(tree)


def to_jax_params(params: Params) -> Params:
    """The port's tree → the JAX package's tree of numpy f32 arrays:
    OIHW → HWIO, OIDHW → DHWIO, every key kept."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = node.detach().float().cpu().numpy()
        if a.ndim in _TO_JAX:
            a = a.transpose(_TO_JAX[a.ndim])
        return np.ascontiguousarray(a)

    return walk(params)


# ---- npz round trip (pickle-free distribution of converted weights) ----

def save_npz_params(path: str, params: Params) -> None:
    """Write the port's tree as the JAX package's ``.npz`` (flat keys,
    HWIO): either package loads it."""
    from vqacl_tpu_torch.train.checkpoint import _flatten
    np.savez(path, **_flatten(to_jax_params(params)))


def load_npz_params(path: str, device="cpu") -> Params:
    """Read an ``.npz`` written by either package → the port's tree on
    ``device``."""
    from vqacl_tpu_torch.train.checkpoint import _unflatten
    z = np.load(path, allow_pickle=False)
    return from_jax_params(_unflatten({k: z[k] for k in z.files}), device)
