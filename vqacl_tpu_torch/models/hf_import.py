"""Weight import and export: HF ``t5-base`` / reference VL-T5 state dicts
↔ the port's parameter tree.

Counterpart of ``vqacl_tpu/models/hf_import.py``. The reference builds
its model with HF ``from_pretrained('t5-base')`` and saves torch
``state_dict`` ``.pth`` files with a ``vis_encoder.`` → ``encoder.`` key
remap (and ``module.`` under DDP). This module maps either naming onto
the port's tree (the JAX pytree's keys, linear weights in the JAX
``[in, out]`` orientation) and back, so HF weights and reference-trained
checkpoints can start the port, and port-trained weights load back into
the reference stack.

Everything reads local files only: ``load_t5_base`` takes a directory
holding ``model.safetensors`` or ``pytorch_model.bin``, or a model name
looked up in the HF cache layout on disk, and never the network.
``.safetensors`` files are read and written here (``read_safetensors``,
``write_safetensors``: an 8-byte header length, a JSON header, the raw
little-endian data), so no package beyond torch and numpy is needed.
Loaders return f32 tensors on the CPU; the caller moves them.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from vqacl_tpu_torch.models.convert import from_jax_params, to_jax_params

Params = Dict[str, Any]


def _t(x) -> np.ndarray:
    """A torch ``[out, in]`` weight as the tree's ``[in, out]`` (and
    back): the f32 transpose, contiguous."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _stack_params(sd: Mapping[str, np.ndarray], prefix: str, n_layers: int,
                  is_decoder: bool) -> Params:
    out: Params = {}
    for i in range(n_layers):
        b = f"{prefix}.block.{i}.layer"
        blk: Params = {
            "attn": {
                "wq": _t(sd[f"{b}.0.SelfAttention.q.weight"]),
                "wk": _t(sd[f"{b}.0.SelfAttention.k.weight"]),
                "wv": _t(sd[f"{b}.0.SelfAttention.v.weight"]),
                "wo": _t(sd[f"{b}.0.SelfAttention.o.weight"]),
            },
            "ln1": _a(sd[f"{b}.0.layer_norm.weight"]),
        }
        if is_decoder:
            blk["cross_attn"] = {
                "wq": _t(sd[f"{b}.1.EncDecAttention.q.weight"]),
                "wk": _t(sd[f"{b}.1.EncDecAttention.k.weight"]),
                "wv": _t(sd[f"{b}.1.EncDecAttention.v.weight"]),
                "wo": _t(sd[f"{b}.1.EncDecAttention.o.weight"]),
            }
            blk["ln2"] = _a(sd[f"{b}.1.layer_norm.weight"])
            ff = 2
        else:
            ff = 1
        blk["mlp"] = {
            "wi": _t(sd[f"{b}.{ff}.DenseReluDense.wi.weight"]),
            "wo": _t(sd[f"{b}.{ff}.DenseReluDense.wo.weight"]),
        }
        blk[f"ln{ff + 1}"] = _a(sd[f"{b}.{ff}.layer_norm.weight"])
        out[f"block_{i}"] = blk
    out["final_ln"] = _a(sd[f"{prefix}.final_layer_norm.weight"])
    out["rel_bias"] = _a(
        sd[f"{prefix}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
    return out


def _maybe_visual_embedding(sd: Mapping[str, np.ndarray]) -> Optional[Params]:
    """A VL-T5 checkpoint's visual-embedding weights; None for a vanilla
    t5-base one."""
    for pre in ("encoder.visual_embedding", "vis_encoder.visual_embedding"):
        if f"{pre}.feat_embedding.0.weight" in sd:
            p: Params = {
                "feat_w": _t(sd[f"{pre}.feat_embedding.0.weight"]),
                "feat_b": _a(sd[f"{pre}.feat_embedding.0.bias"]),
                "pos_w": _t(sd[f"{pre}.absolute_vis_pos_embedding.0.weight"]),
                "pos_b": _a(sd[f"{pre}.absolute_vis_pos_embedding.0.bias"]),
            }
            if f"{pre}.feat_embedding.1.weight" in sd:
                p["feat_ln"] = _a(sd[f"{pre}.feat_embedding.1.weight"])
                p["pos_ln"] = _a(
                    sd[f"{pre}.absolute_vis_pos_embedding.1.weight"])
            if f"{pre}.layer_norm.weight" in sd:
                p["joint_ln"] = _a(sd[f"{pre}.layer_norm.weight"])
            if f"{pre}.img_order_embedding.weight" in sd:
                p["img_order"] = _a(sd[f"{pre}.img_order_embedding.weight"])
            return p
    return None


def _resize_vocab(emb: np.ndarray, vocab_size: int, seed: int = 0
                  ) -> np.ndarray:
    """Extend or truncate the shared embedding to the VL-T5 vocabulary
    (32100 sentencepiece ids + 100 ``<vis_extra_id_*>`` rows at the top).
    New rows are N(0,1) from ``np.random.default_rng(seed)``, the numbers
    JAX's import draws."""
    v0, d = emb.shape
    if v0 == vocab_size:
        return emb
    if v0 > vocab_size:
        return emb[:vocab_size]
    extra = np.random.default_rng(seed).standard_normal(
        (vocab_size - v0, d)).astype(np.float32)
    return np.concatenate([emb, extra], axis=0)


def _numpy_values(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A state dict's values as numpy (torch tensors on any device and
    dtype are widened to f32 when floating)."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.is_floating_point() else v).numpy()
        out[k] = v
    return out


def from_state_dict(sd: Mapping[str, Any], cfg,
                    strict_visual: bool = False) -> Params:
    """An HF T5 / reference VL-T5 ``state_dict`` (numpy arrays or
    tensors) → the port's tree of f32 CPU tensors. Strips a leading
    ``module.`` (DDP) and maps ``vis_encoder.`` to ``encoder.``, as the
    reference's loader does."""
    sd = _numpy_values(sd)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    sd = {("encoder." + k[len("vis_encoder."):] if k.startswith("vis_encoder.")
           else k): v for k, v in sd.items()}
    params: Params = {
        "shared": _resize_vocab(_a(sd["shared.weight"]), cfg.vocab_size),
        "encoder": _stack_params(sd, "encoder", cfg.num_layers, False),
        "decoder": _stack_params(sd, "decoder", cfg.num_decoder_layers, True),
    }
    vis = _maybe_visual_embedding(sd)
    if vis is not None:
        params["visual_embedding"] = vis
    elif strict_visual:
        raise KeyError("checkpoint has no visual_embedding weights")
    return from_jax_params(params)


def to_state_dict(params: Params, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`from_state_dict`: the port's tree → a torch
    state dict (f32, CPU) with the reference/HF T5 key naming, linear
    weights back in torch's ``[out, in]``. The tied
    ``encoder/decoder.embed_tokens``, ``lm_head`` and visual
    ``obj_order_embedding`` copies of ``shared`` are emitted (as one
    tensor) so strict loads find every key. Prototype banks are not
    exported: the reference keeps them outside its state dict."""
    tree = to_jax_params(params)
    sd: Dict[str, np.ndarray] = {}

    def put_stack(stack: Params, prefix: str, n_layers: int,
                  is_decoder: bool) -> None:
        for i in range(n_layers):
            blk = stack[f"block_{i}"]
            b = f"{prefix}.block.{i}.layer"
            for nm, w in (("q", "wq"), ("k", "wk"), ("v", "wv"),
                          ("o", "wo")):
                sd[f"{b}.0.SelfAttention.{nm}.weight"] = _t(blk["attn"][w])
            sd[f"{b}.0.layer_norm.weight"] = _a(blk["ln1"])
            if is_decoder:
                for nm, w in (("q", "wq"), ("k", "wk"), ("v", "wv"),
                              ("o", "wo")):
                    sd[f"{b}.1.EncDecAttention.{nm}.weight"] = \
                        _t(blk["cross_attn"][w])
                sd[f"{b}.1.layer_norm.weight"] = _a(blk["ln2"])
                ff = 2
            else:
                ff = 1
            sd[f"{b}.{ff}.DenseReluDense.wi.weight"] = _t(blk["mlp"]["wi"])
            sd[f"{b}.{ff}.DenseReluDense.wo.weight"] = _t(blk["mlp"]["wo"])
            sd[f"{b}.{ff}.layer_norm.weight"] = _a(blk[f"ln{ff + 1}"])
        sd[f"{prefix}.final_layer_norm.weight"] = _a(stack["final_ln"])
        sd[f"{prefix}.block.0.layer.0.SelfAttention"
           ".relative_attention_bias.weight"] = _a(stack["rel_bias"])

    shared = _a(tree["shared"])
    for k in ("shared", "encoder.embed_tokens", "decoder.embed_tokens",
              "lm_head"):
        sd[f"{k}.weight"] = shared
    put_stack(tree["encoder"], "encoder", cfg.num_layers, False)
    put_stack(tree["decoder"], "decoder", cfg.num_decoder_layers, True)
    vis = tree.get("visual_embedding")
    if vis is not None:
        pre = "encoder.visual_embedding"
        sd[f"{pre}.feat_embedding.0.weight"] = _t(vis["feat_w"])
        sd[f"{pre}.feat_embedding.0.bias"] = _a(vis["feat_b"])
        sd[f"{pre}.absolute_vis_pos_embedding.0.weight"] = _t(vis["pos_w"])
        sd[f"{pre}.absolute_vis_pos_embedding.0.bias"] = _a(vis["pos_b"])
        if "feat_ln" in vis:
            sd[f"{pre}.feat_embedding.1.weight"] = _a(vis["feat_ln"])
            sd[f"{pre}.absolute_vis_pos_embedding.1.weight"] = \
                _a(vis["pos_ln"])
        if "joint_ln" in vis:
            sd[f"{pre}.layer_norm.weight"] = _a(vis["joint_ln"])
        if "img_order" in vis:
            sd[f"{pre}.img_order_embedding.weight"] = _a(vis["img_order"])
        # the reference ties obj_order_embedding to shared, and the tied
        # copy lands in its saved state dicts
        sd[f"{pre}.obj_order_embedding.weight"] = shared
    # own copies (never views of the live parameters), one per array, so
    # the tied keys stay one tensor
    copies: Dict[int, torch.Tensor] = {}
    for v in sd.values():
        if id(v) not in copies:
            copies[id(v)] = torch.from_numpy(np.array(v))
    return {k: copies[id(v)] for k, v in sd.items()}


def save_reference_pth(params: Params, path: str, cfg) -> None:
    """The port's tree as a reference-loadable ``.pth`` state dict (the
    round-trip partner of :func:`load_reference_pth`)."""
    torch.save(to_state_dict(params, cfg), path)


def load_reference_pth(path: str, cfg) -> Params:
    """A reference-trained checkpoint (``{task}_LAST.pth``: a torch state
    dict, or ``{"model": state_dict}``) → the port's tree, with the
    ``module.``/``vis_encoder.`` remaps. Loads tensors only
    (``weights_only``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"],
                                                          "items"):
        sd = sd["model"]
    return from_state_dict({k: v for k, v in sd.items()
                            if isinstance(v, torch.Tensor)}, cfg)


# ---- .safetensors, read and written with numpy -----------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU: an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the data, offsets relative to its start."""
    with open(path, "rb") as f:
        n, = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(data[begin:end].copy())
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """The inverse of :func:`read_safetensors`: tensors in name order,
    the header padded with spaces to 8 bytes, ``{"format": "pt"}``
    metadata as HF's writer adds (``transformers`` reads it)."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata or
                                                   {"format": "pt"})}
    blobs: List[bytes] = []
    off = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(blob)]}
        blobs.append(blob)
        off += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def _hf_cache_pattern(name: str) -> str:
    """The glob of model ``name``'s snapshot directories in the HF cache
    layout on disk (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``)."""
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache", "huggingface"), "hub")
    return os.path.join(hub, "models--" + name.replace("/", "--"),
                        "snapshots", "*")


def load_t5_base(cfg, name_or_path: str = "t5-base") -> Params:
    """HF t5-base weights from local files → the port's tree (f32, CPU).

    ``name_or_path`` is a directory holding ``model.safetensors`` or
    ``pytorch_model.bin`` (a ``save_pretrained`` directory), or a model
    name looked up in the HF cache on disk. Nothing is fetched: without
    such files it raises FileNotFoundError naming the paths it tried."""
    if os.path.isdir(name_or_path):
        dirs = [name_or_path]
    else:
        dirs = sorted(glob.glob(_hf_cache_pattern(name_or_path)))
    tried = [] if dirs else [_hf_cache_pattern(name_or_path)]
    for d in dirs:
        st = os.path.join(d, "model.safetensors")
        if os.path.isfile(st):
            return from_state_dict(read_safetensors(st), cfg)
        pt = os.path.join(d, "pytorch_model.bin")
        if os.path.isfile(pt):
            return from_state_dict(
                torch.load(pt, map_location="cpu", weights_only=True), cfg)
        tried += [st, pt]
    raise FileNotFoundError(f"load_t5_base: no local weights for "
                            f"{name_or_path!r} (tried {', '.join(tried)}); "
                            f"nothing is downloaded")
