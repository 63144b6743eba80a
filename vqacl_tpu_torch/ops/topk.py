"""Top-k that ranks ties as ``jax.lax.top_k`` does.

Shared by beam search (``models/generate.py``) and the RPN's pre-NMS
selection (``vision/rpn.py``), both of which tie values (a dead beam's
``NEG``, the ``-inf`` of every box that cannot be kept) and must order
them as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row of f32 ``x`` (no NaN), in
    descending order, with their indices; equal values rank the lower
    index first, as ``jax.lax.top_k`` ranks them (``torch.topk`` keeps
    no order among ties). Each value maps to an int32 whose order is the
    float order; the key value·2³² + (n−1−index) is unique in its row, so
    one ``topk`` over the keys has no ties."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    rev = (n - 1) - torch.arange(n, device=x.device)
    keys, _ = torch.topk(ordered * (1 << 32) + rev, k, dim=-1)
    idx = (n - 1) - (keys & 0xFFFFFFFF)
    return x.gather(-1, idx), idx
