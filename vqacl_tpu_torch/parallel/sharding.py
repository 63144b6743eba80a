"""Parameter sharding rules for the VL-T5 parameter tree (counterpart of
``vqacl_tpu/parallel/sharding.py``).

The rules are data: each parameter path ("encoder/block_0/attn/wq") maps
to a spec tuple naming the mesh axis of each dimension, as JAX's
``PartitionSpec``s do (``(None, "tp")``: the output dimension over tp;
``()``: replicated). The tp half is the Megatron layout: ``TpLayout``
(and ``shard_params``) keeps tp rank t's slice ``[t·n/tp, (t+1)·n/tp)``
of each ``RULES``-marked dimension (q/k/v and the MLP's first product by
their outputs, the two wo by their inputs: a rank's heads and its part
of the hidden), which the tp blocks of models/t5.py run on. The dp half
is FSDP (ZeRO-3 style): ``fsdp_rules`` gives each leaf of at least 2^14
elements a dimension sharded over dp, and ``FsdpLayout`` keeps only this
rank's slice of such a leaf, and of its Adam moments, between steps;
composed with tp, it shards the rank's tp slices on the dimension JAX's
rule picks (never a tp-marked one). ``StoredLayout`` chains the two for
the trainer and the checkpoints. Every gather is one zeroed bucket
all-reduced bit for bit over the group (tp or dp). Weights are stored
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
    """This rank's tensor-parallel slices of ``params`` (copies; the whole
    tree at tp = 1): ``TpLayout.shard``."""
    return TpLayout(ctx, params).shard(params)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _bucket_gather(ctx, group: str, tree: Any, dims, full_shapes,
                   part) -> Any:
    """The full leaves of ``tree`` from the ranks' slices: each leaf i
    with ``dims[i]`` set is written at ``part(i)`` (dim, start, length)
    of a zeroed bucket of the full leaves' bytes (16-byte aligned), which
    one ``all_reduce`` over ``group`` combines as int32 words, bit for
    bit; the other leaves pass as they are."""
    leaves = tree_leaves(tree)
    offs, total = [], 0
    for i, x in enumerate(leaves):
        offs.append(total)
        if dims[i] is not None:
            total += -(-_numel(full_shapes[i]) * x.element_size() // 16) * 16
    if total == 0:
        return tree
    words = torch.zeros(total // 4, dtype=torch.int32,
                        device=leaves[0].device)
    raw = words.view(torch.uint8)
    out = []
    for i, x in enumerate(leaves):
        if dims[i] is None:
            out.append(x)
            continue
        n = _numel(full_shapes[i]) * x.element_size()
        full = raw[offs[i]:offs[i] + n].view(x.dtype).view(full_shapes[i])
        full.narrow(*part(i)).copy_(x)
        out.append(full)
    ctx.all_reduce(words, group)
    return tree_unflatten(tree, out)


def _sq_norm(ctx, leaves, tp_dims, dp_dims) -> torch.Tensor:
    """Σ x² in f32 over a tree stored as slices: the squares of the leaves
    sharded over dp summed over dp, then those of the leaves sharded over
    tp (over dp too or not) summed over tp, the whole leaves added
    once."""
    dev = leaves[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sums = {}
    for x, td, dd in zip(leaves, tp_dims, dp_dims):
        sums.setdefault((td is not None, dd is not None), []).append(
            x.float().pow(2).sum())
    s = {k: torch.stack(v).sum() for k, v in sums.items()}
    both, tp_only = s.get((True, True), zero), s.get((True, False), zero)
    dp_only, none = s.get((False, True), zero), s.get((False, False), zero)
    if any(d is not None for d in dp_dims):
        if (True, True) in s:
            both, dp_only = ctx.all_reduce(torch.stack([both, dp_only]),
                                           "dp")
        else:
            dp_only = ctx.all_reduce(dp_only.clone(), "dp")
    total = dp_only + none
    if any(d is not None for d in tp_dims):
        total = total + ctx.all_reduce(both + tp_only, "tp")
    return total


class TpLayout:
    """The Megatron layout of a parameter tree: which dimension of each
    leaf ``RULES`` marks "tp", and the moves between full leaves and tp
    rank t's slices ``[t·n/tp, (t+1)·n/tp)`` of it. At tp = 1 every leaf
    stays whole. Raises ValueError for a marked dimension tp does not
    divide (the heads or the MLP hidden)."""

    def __init__(self, ctx, params: Any):
        self.ctx = ctx
        self.specs = apply_rules(ctx, params)
        self._shapes = [tuple(p.shape) for p in tree_leaves(params)]
        self._dims = [s.index("tp") if ctx.tp > 1 and "tp" in s else None
                      for s in tree_leaves(self.specs)]
        for d, shape, path in zip(self._dims, self._shapes,
                                  tree_leaves(_tree_paths(params))):
            if d is not None and shape[d] % ctx.tp:
                raise ValueError(f"TpLayout: {path} dimension {d} of "
                                 f"{shape[d]} not divisible by tp={ctx.tp}")

    @property
    def dims(self):
        return list(self._dims)

    def local_shapes(self):
        """The shapes of this rank's slices."""
        return [s if d is None else s[:d] + (s[d] // self.ctx.tp,)
                + s[d + 1:] for s, d in zip(self._shapes, self._dims)]

    def _part(self, i: int) -> Tuple[int, int, int]:
        d = self._dims[i]
        n = self._shapes[i][d] // self.ctx.tp
        return d, self.ctx.tp_index * n, n

    def shard(self, tree: Any) -> Any:
        """This rank's slices (copies) of a full tree's sharded leaves."""
        return tree_unflatten(tree, [
            x if self._dims[i] is None else x.narrow(*self._part(i)).clone()
            for i, x in enumerate(tree_leaves(tree))])

    def slice(self, tree: Any) -> Any:
        """Like ``shard``, as views of the full leaves (no copy)."""
        return tree_unflatten(tree, [
            x if self._dims[i] is None else x.narrow(*self._part(i))
            for i, x in enumerate(tree_leaves(tree))])

    def gather(self, tree: Any) -> Any:
        """The full tree from the tp ranks' slices: one bucket, all-reduced
        over the tp group bit for bit."""
        return _bucket_gather(self.ctx, "tp", tree, self._dims,
                              self._shapes, self._part)

    def global_sq_norm(self, shards: Any) -> torch.Tensor:
        """Σ x² in f32 over the whole tree from this rank's slices: the
        sharded leaves' squares summed over tp, the whole ones once."""
        leaves = tree_leaves(shards)
        return _sq_norm(self.ctx, leaves, self._dims, [None] * len(leaves))


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
    """Which dimension of each leaf is sharded over dp (``fsdp_rules``,
    chosen on the full ``params``), and the moves between the leaves and
    this rank's slices: the rank of dp index d keeps ``[d·n/dp,
    (d+1)·n/dp)`` of that dimension. Leaves without "dp" stay whole on
    every rank. With a ``tp`` layout the leaves are that layout's tp
    slices (never cut on a tp-marked dimension, so the dp dimension has
    its full length), as JAX composes the two (sharding.py:73-102)."""

    def __init__(self, ctx, params: Any, min_size: int = 1 << 14,
                 tp: Optional[TpLayout] = None):
        self.ctx = ctx
        self.tp = tp
        self.specs = fsdp_rules(ctx, params, min_size)
        self._dims = [s.index("dp") if "dp" in s else None
                      for s in tree_leaves(self.specs)]
        self._shapes = tp.local_shapes() if tp is not None else \
            [tuple(p.shape) for p in tree_leaves(params)]

    def _part(self, i: int) -> Tuple[int, int, int]:
        """(dim, start, length) of this rank's slice of leaf i."""
        d = self._dims[i]
        n = self._shapes[i][d] // self.ctx.dp
        return d, self.ctx.dp_index * n, n

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
        """The leaves from every dp rank's slices: one bucket, each rank
        writing its slices into a zeroed buffer of the sharded leaves'
        bytes, combined by one ``all_reduce`` over dp bit for bit."""
        return _bucket_gather(self.ctx, "dp", tree, self._dims,
                              self._shapes, self._part)

    def global_sq_norm(self, shards: Any) -> torch.Tensor:
        """Σ x² in f32 over the whole tree from this rank's slices: the
        dp-sharded leaves' sums all-reduced over dp, the tp-sharded ones'
        (with a ``tp`` layout) over tp, the whole leaves' added once."""
        leaves = tree_leaves(shards)
        tp_dims = self.tp.dims if self.tp is not None else \
            [None] * len(leaves)
        return _sq_norm(self.ctx, leaves, tp_dims, self._dims)


class StoredLayout:
    """How a trainer keeps its parameters: the tp slices (``tp``, a
    ``TpLayout``), then their dp slices (``fsdp``, an ``FsdpLayout``
    built over the same ``tp``); either may be None. ``shard`` takes the
    full tree to this rank's storage, ``gather`` back (every rank calls
    it)."""

    def __init__(self, tp: Optional[TpLayout] = None,
                 fsdp: Optional[FsdpLayout] = None):
        self.tp, self.fsdp = tp, fsdp

    def shard(self, tree: Any) -> Any:
        if self.tp is not None:
            tree = self.tp.shard(tree)
        return tree if self.fsdp is None else self.fsdp.shard(tree)

    def gather(self, tree: Any) -> Any:
        if self.fsdp is not None:
            tree = self.fsdp.gather(tree)
        return tree if self.tp is None else self.tp.gather(tree)


def shard_params_fsdp(ctx, params: Any) -> Any:
    """This rank's FSDP slices of ``params`` (``FsdpLayout.shard``)."""
    return FsdpLayout(ctx, params).shard(params)
