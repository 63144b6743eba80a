"""Checkpoint save/load on ``vqacl_tpu``'s ``.npz`` format.

One archive holds the parameters (flattened pytree paths joined with
``::`` under ``params::``), the prototype state (``proto::<field>``) and
the step (``meta::step``), so the port serves a checkpoint the JAX
package wrote and the JAX package loads one the port wrote.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models.convert import from_jax_params, to_jax_params
from vqacl_tpu_torch.models.prototype import ProtoState

SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, params: Any, proto: ProtoState,
                    step: int = 0) -> None:
    """Write ``<path>.npz`` through a temp file and ``os.replace``, so a
    crash mid-write never leaves a truncated archive."""
    flat = _flatten({"params": to_jax_params(params)})
    for value, name in zip(proto, proto._fields):
        flat[f"proto{SEP}{name}"] = value.detach().cpu().numpy()
    flat[f"meta{SEP}step"] = np.asarray(step)
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[Dict[str, Any], ProtoState, int]:
    """→ (params as f32 tensors, ProtoState, step), on ``device``."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    pre, ppre = "params" + SEP, "proto" + SEP
    params = _unflatten({k[len(pre):]: v for k, v in flat.items()
                         if k.startswith(pre)})
    fields = {k[len(ppre):]: v for k, v in flat.items()
              if k.startswith(ppre)}
    proto = ProtoState(**{name: torch.from_numpy(np.array(fields[name]))
                          .to(device) for name in ProtoState._fields})
    step = int(flat.get(f"meta{SEP}step", np.asarray(0)))
    return from_jax_params(params, device=device), proto, step
