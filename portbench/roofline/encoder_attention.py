"""The least time of one encoder-attention launch, from its shapes.

q, k, v [B, S, H·dk] in ``dtype``, the relative bias [H, L, L] f32 on
the text block, the key mask [B, S] f32. Each input byte is counted
once and each output byte once. The inference forward (K1) reads q, k, v
and writes o. The training forward (K1′) also writes the pre-dropout
probabilities p [B, H, S, S] f32 and reads the seed. The backward (K2)
reads q, k, v, do and p and writes dq, dk, dv and the bias gradient.
Operations: q·kᵀ and p·v are 2·B·H·S·S·dk each; the backward's four
products twice that. The bound is the larger of bytes over the HBM rate
and operations over the tensor cores' dense rate (NVIDIA H100 SXM data
sheet).
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEM = {"bfloat16": 2, "float32": 4}


def shape(m: Dict, batch: int) -> Tuple[int, int, int, int, int]:
    """(B, S, H, dk, L) of the encoder attention at ``batch`` rows."""
    L = m["max_text_length"]
    return batch, L + m["n_boxes"], m["num_heads"], m["d_kv"], L


def work(kind: str, B: int, S: int, H: int, dk: int, L: int,
         dtype: str) -> Tuple[int, int]:
    """(bytes, FLOPs) of one launch of ``kind``: "fwd", "fwd_train" or
    "bwd"."""
    panel = B * S * H * dk * ELEM[dtype]
    small = B * S * 4 + H * L * L * 4
    p = B * H * S * S * 4
    prod = 2 * B * H * S * S * dk
    if kind == "fwd":
        return 4 * panel + small, 2 * prod
    if kind == "fwd_train":
        return 4 * panel + p + small + 4, 2 * prod
    if kind == "bwd":
        return 4 * panel + p + 3 * panel + H * L * L * 4 + 4, 4 * prod
    raise ValueError(kind)


def bound_s(kind: str, m: Dict, batch: int, dtype: str) -> float:
    nbytes, flops = work(kind, *shape(m, batch), dtype)
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
