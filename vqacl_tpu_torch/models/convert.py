"""Weight bridge between ``vqacl_tpu``'s parameter pytree and the port.

The port's parameters are the JAX pytree itself, as a nested dict of
tensors with the same keys (``shared``, ``encoder/block_i/attn/wq``,
``visual_embedding/feat_w``, ...). Linear weights keep the JAX
orientation ``[in, out]`` and are applied as ``x @ W``; nothing is
transposed, so a weight moves between the packages as the same array.
The checkpoint's flat ``params::…`` keys (``train/checkpoint.py``) are
that tree flattened.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def from_jax_params(tree: Params, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Params:
    """JAX parameter pytree as numpy arrays → the port's parameters.
    Floating leaves become ``dtype`` tensors on ``device``; integer
    leaves keep their type."""
    def leaf(x):
        t = torch.from_numpy(np.array(x))   # own, writable copy
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def to_device(params: Params, device) -> Params:
    """The same tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


def to_jax_params(params: Params) -> Params:
    """The port's parameters → the JAX pytree as numpy arrays. bf16
    leaves are widened to f32 (numpy has no bf16; the widening is
    exact)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return walk(params)
