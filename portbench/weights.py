"""VL-T5 weights and prototype banks made from the seed, on the device.

The layout is the port's nested dict (the keys, shapes and init scales of
``vqacl_tpu_torch/models/vlt5.py::_init_numpy``, T5's factor 1.0), but the
values come from one ``torch.Generator`` on the device in one large
normal draw, so set-up makes 225 M parameters in a few calls instead of
leaf by leaf on the host. The benchmark hands the same tree to the
program (``init_params``) and to the reference, which makes it again
from the same seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]
# (path, shape, std) of a normal leaf; std None: ones; std 0: zeros
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]


def layout(m: Dict[str, Any]) -> List[Leaf]:
    """Every leaf of the tree for the model sizes ``m`` (a configuration
    file's top level), in sorted path order."""
    D, H, dk, F = m["d_model"], m["num_heads"], m["d_kv"], m["d_ff"]
    inner = H * dk
    out: List[Leaf] = []

    def attention(p):
        out.extend([(p + ("wq",), (D, inner), (D * dk) ** -0.5),
                    (p + ("wk",), (D, inner), D ** -0.5),
                    (p + ("wv",), (D, inner), D ** -0.5),
                    (p + ("wo",), (inner, D), inner ** -0.5)])

    def stack(name, n, decoder):
        for i in range(n):
            p = (name, f"block_{i}")
            attention(p + ("attn",))
            out.append((p + ("ln1",), (D,), None))
            out.extend([(p + ("mlp", "wi"), (D, F), D ** -0.5),
                        (p + ("mlp", "wo"), (F, D), F ** -0.5)])
            out.append((p + ("ln2",), (D,), None))
            if decoder:
                attention(p + ("cross_attn",))
                out.append((p + ("ln3",), (D,), None))
        out.append(((name, "final_ln"), (D,), None))
        out.append(((name, "rel_bias"),
                    (m["relative_attention_num_buckets"], H), D ** -0.5))

    out.append((("shared",), (m["vocab_size"], D), 1.0))
    stack("encoder", m["num_layers"], False)
    stack("decoder", m["num_decoder_layers"], True)
    fd = m["feat_dim"]
    v = ("visual_embedding",)
    out.extend([(v + ("feat_w",), (fd, D), fd ** -0.5),
                (v + ("feat_b",), (D,), 0.0),
                (v + ("pos_w",), (5, D), 1.0),
                (v + ("pos_b",), (D,), 0.0),
                (v + ("feat_ln",), (D,), None),
                (v + ("pos_ln",), (D,), None),
                (v + ("img_order",), (2, D), 1.0)])
    return sorted(out, key=lambda leaf: leaf[0])


def _put(tree: Tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_weights(m: Dict[str, Any], seed: int, device) -> Tree:
    """The f32 parameter tree for the sizes ``m`` from ``seed``: one normal
    draw covers every random leaf (each a view of it, scaled in place)."""
    leaves = layout(m)
    sizes = []
    for _, shape, std in leaves:
        k = 1
        for s in shape:
            k *= s
        sizes.append(k if std not in (None, 0.0) else 0)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    tree: Tree = {}
    off = 0
    for (path, shape, std), k in zip(leaves, sizes):
        if std is None:
            t = torch.ones(shape, device=device)
        elif std == 0.0:
            t = torch.zeros(shape, device=device)
        else:
            t = flat[off:off + k].view(shape)
            t.mul_(std)
            off += k
        _put(tree, path, t)
    return tree


BANK_SCALE = 0.5


def make_banks(m: Dict[str, Any], seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """Prototype banks standing for those a previous task left: Q and V
    retrieval banks and the Q memory bank, normal × ``BANK_SCALE``, from
    a stream of their own."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 5 + 11)
                                                   % (2 ** 63))
    D, nq, nv = m["d_model"], m["n_ques_types"], m["n_categories"]
    x = torch.randn(2 * nq + nv, D, generator=g, device=device) * BANK_SCALE
    return {"q_proto": x[:nq].clone(), "v_proto": x[nq:nq + nv].clone(),
            "q_mem_proto": x[nq + nv:].clone()}


def flatten(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in sorted path order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], prefix + (k,)))
    return out


def unflatten(pairs) -> Tree:
    """The tree of (path, leaf) pairs."""
    tree: Tree = {}
    for path, t in pairs:
        _put(tree, path, t)
    return tree
