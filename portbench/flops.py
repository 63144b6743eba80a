"""Model FLOPs of VL-T5 per question, counted from the sizes.

Each matrix product of m × k by k × n counts 2·m·k·n. Counted: the
visual embedding's two projections, per encoder layer the q/k/v/o
projections, the scores and the probabilities' product over all S × S
positions, and the MLP; per decoder layer the self q/k/v/o projections,
the cross q and o projections, both attentions and the MLP; each
decoder layer's cross k/v of the S + 2 encoder positions (the two
prototypes appended); the tied head. Training is forward + backward = 3×
the forward, with no recompute counted. Norms, softmax,
dropout and the prototype step are left out (elementwise, well under 1 %
of the products).
"""

from __future__ import annotations

from typing import Dict


def _sizes(m: Dict):
    D = m["d_model"]
    inner = m["num_heads"] * m["d_kv"]
    S = m["max_text_length"] + m["n_boxes"]
    return D, inner, m["d_ff"], S, S + 2


def encoder(m: Dict) -> int:
    D, inner, F, S, _ = _sizes(m)
    N, fd = m["n_boxes"], m["feat_dim"]
    vis = 2 * N * fd * D + 2 * N * 5 * D
    layer = 8 * S * D * inner + 4 * S * S * inner + 4 * S * D * F
    return vis + m["num_layers"] * layer


def cross_kv(m: Dict) -> int:
    D, inner, _, _, S2 = _sizes(m)
    return m["num_decoder_layers"] * 4 * S2 * D * inner


def decoder_train(m: Dict) -> int:
    D, inner, F, _, S2 = _sizes(m)
    T = m["target_max_length"]
    layer = (8 * T * D * inner + 4 * T * D * inner + 4 * T * T * inner
             + 4 * T * S2 * inner + 4 * T * D * F)
    return m["num_decoder_layers"] * layer


def head(m: Dict, positions: int) -> int:
    return 2 * positions * m["d_model"] * m["vocab_size"]


def train_forward(m: Dict) -> int:
    return encoder(m) + cross_kv(m) + decoder_train(m) \
        + head(m, m["target_max_length"])


def train_qa(m: Dict) -> int:
    """Forward + backward of one question in a train or replay step."""
    return 3 * train_forward(m)

