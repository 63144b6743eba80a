"""Parameter sharding rules for the VL-T5 parameter tree (counterpart of
``vqacl_tpu/parallel/sharding.py``).

The rules are data: each parameter path ("encoder/block_0/attn/wq") maps
to a spec tuple naming the mesh axis of each dimension, as JAX's
``PartitionSpec``s do (``(None, "tp")``: the output dimension over tp;
``()``: replicated). The tp half (``shard_params``, the Megatron layout)
is not ported yet and raises. The dp half is FSDP (ZeRO-3 style):
``fsdp_rules`` gives each leaf of at least 2^14 elements a dimension
sharded over dp, and ``FsdpLayout`` keeps only this rank's slice of such
a leaf, and of its Adam moments, between steps. Weights are stored
``[in, out]`` and applied as ``x @ W``.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import torch

from vqacl_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten

Spec = Tuple[Optional[str], ...]

# (path regex, spec). Anything unmatched is replicated.
RULES: List[Tuple[str, Spec]] = [
    # attention input projections: out dim = heads*d_kv → out over tp
    (r".*/attn/wq$", (None, "tp")),
    (r".*/attn/wk$", (None, "tp")),
    (r".*/attn/wv$", (None, "tp")),
    # attention output projection: in dim = heads*d_kv → in over tp
    (r".*/attn/wo$", ("tp", None)),
    (r".*/cross_attn/wq$", (None, "tp")),
    (r".*/cross_attn/wk$", (None, "tp")),
    (r".*/cross_attn/wv$", (None, "tp")),
    (r".*/cross_attn/wo$", ("tp", None)),
    # MLP: the first matmul's hidden out, the second's hidden in
    (r".*/mlp/wi$", (None, "tp")),
    (r".*/mlp/wi_0$", (None, "tp")),
    (r".*/mlp/wi_1$", (None, "tp")),
    (r".*/mlp/wo$", ("tp", None)),
    # embeddings / norms / rel-pos bias / visual embedding: replicated
]


def param_sharding_rules(path: str) -> Spec:
    for pat, spec in RULES:
        if re.match(pat, path):
            return spec
    return ()


def _tree_paths(tree: Any, prefix: str = "") -> Any:
    """The tree with 'a/b/c' path strings at its leaves."""
    if isinstance(tree, dict):
        return {k: _tree_paths(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return prefix


def apply_rules(ctx, params: Any) -> Any:
    """The tp spec of every leaf of ``params`` (a tree of spec tuples)."""
    return tree_map(param_sharding_rules, _tree_paths(params))


def shard_params(ctx, params: Any) -> Any:
    """The tensor-parallel layout: not ported yet."""
    raise ValueError("shard_params: the tensor-parallel layout ('tp') is not "
                     "ported yet")


def fsdp_rules(ctx, params: Any, min_size: int = 1 << 14) -> Any:
    """ZeRO-3-style specs, JAX's choice exactly (sharding.py:73-102): a
    leaf of at least ``min_size`` elements gets "dp" on its largest
    dimension that is not tp-marked (the marks count at tp = 1 too) and
    that dp divides; everything else keeps its tp spec."""
    dp = ctx.dp

    def spec_for(path: str, x) -> Spec:
        base = param_sharding_rules(path)
        shape = tuple(x.shape)
        numel = 1
        for s in shape:
            numel *= s
        if dp > 1 and numel >= min_size:
            axes = list(base) + [None] * (len(shape) - len(base))
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if axes[d] is None and shape[d] % dp == 0:
                    axes[d] = "dp"
                    break
            base = tuple(axes)
        return base

    return tree_map(spec_for, _tree_paths(params), params)


class FsdpLayout:
    """Which dimension of each leaf is sharded over dp (``fsdp_rules``),
    and the moves between full leaves and this rank's slices: rank r
    keeps ``[r·n/dp, (r+1)·n/dp)`` of that dimension. Leaves without
    "dp" stay whole on every rank."""

    def __init__(self, ctx, params: Any, min_size: int = 1 << 14):
        self.ctx = ctx
        self.specs = fsdp_rules(ctx, params, min_size)
        self._dims = [s.index("dp") if "dp" in s else None
                      for s in tree_leaves(self.specs)]
        self._shapes = [tuple(p.shape) for p in tree_leaves(params)]

    def _part(self, i: int) -> Tuple[int, int, int]:
        """(dim, start, length) of this rank's slice of leaf i."""
        d = self._dims[i]
        n = self._shapes[i][d] // self.ctx.dp
        return d, self.ctx.rank * n, n

    def shard(self, tree: Any) -> Any:
        """This rank's slices (copies) of a full tree's sharded leaves."""
        out = []
        for i, x in enumerate(tree_leaves(tree)):
            if self._dims[i] is not None:
                x = x.narrow(*self._part(i)).clone()
            out.append(x)
        return tree_unflatten(tree, out)

    def slice(self, tree: Any) -> Any:
        """Like ``shard``, as views of the full leaves (no copy)."""
        return tree_unflatten(tree, [
            x if self._dims[i] is None else x.narrow(*self._part(i))
            for i, x in enumerate(tree_leaves(tree))])

    def gather(self, tree: Any) -> Any:
        """The full tree from every rank's slices: one bucket, each rank
        writing its slices into a zeroed buffer of the sharded leaves'
        bytes, combined by one ``all_reduce`` bit for bit."""
        leaves = tree_leaves(tree)
        offs, total = [], 0
        for i, x in enumerate(leaves):
            offs.append(total)
            if self._dims[i] is not None:
                n = x.element_size()
                for s in self._shapes[i]:
                    n *= s
                total += -(-n // 16) * 16        # 16-byte aligned leaves
        if total == 0:
            return tree
        dev = leaves[0].device
        words = torch.zeros(total // 4, dtype=torch.int32, device=dev)
        raw = words.view(torch.uint8)
        out = []
        for i, x in enumerate(leaves):
            if self._dims[i] is None:
                out.append(x)
                continue
            shape = self._shapes[i]
            n = x.element_size()
            for s in shape:
                n *= s
            full = raw[offs[i]:offs[i] + n].view(x.dtype).view(shape)
            full.narrow(*self._part(i)).copy_(x)
            out.append(full)
        self.ctx.all_reduce(words)
        return tree_unflatten(tree, out)

    def global_sq_norm(self, shards: Any) -> torch.Tensor:
        """Σ x² in f32 over the whole tree from this rank's slices: the
        sharded leaves' sums all-reduced, the whole leaves' added once."""
        sharded = [x.float().pow(2).sum() for i, x in
                   enumerate(tree_leaves(shards)) if self._dims[i] is not None]
        whole = [x.float().pow(2).sum() for i, x in
                 enumerate(tree_leaves(shards)) if self._dims[i] is None]
        dev = tree_leaves(shards)[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        part = self.ctx.all_reduce(torch.stack(sharded).sum()
                                   if sharded else zero.clone())
        return part + (torch.stack(whole).sum() if whole else zero)


def shard_params_fsdp(ctx, params: Any) -> Any:
    """This rank's FSDP slices of ``params`` (``FsdpLayout.shard``)."""
    return FsdpLayout(ctx, params).shard(params)
