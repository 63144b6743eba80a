"""Optimizer and LR schedule (counterpart of ``vqacl_tpu/train/optim.py``).

The JAX package builds the update from optax; the card's machine has no
optax, so the port writes the same transforms as plain functions on the
parameter dict with explicit state (no ``torch.optim``):

- global-norm clipping with optax's rule: ``g`` when ``‖g‖ < max``,
  else ``g / ‖g‖ · max`` (not ``clip_grad_norm_``'s ``max/(‖g‖+1e-6)``);
- the Adam direction, either HF AdamW's (the reference's, ``"hf"``:
  √(1−β₂ᵗ)/(1−β₁ᵗ) · m/(√v+ε), the correction computed in f32) or
  optax/torch AdamW's (``"torch"``: m̂/(√v̂+ε)); moments stored in
  ``adam_dtype`` with f32 arithmetic;
- decoupled weight decay, masked: leaves named ``*_b`` and ``rel_bias``
  are not decayed, layer norms are (the reference's 'bias' substring
  test never matches T5's ``layer_norm`` names);
- ``freeze``: only the shared embedding trains;
- the HF constant- or linear-with-warmup schedule, whose first step is a
  zero update.

The train step multiplies the direction by ``dynamic_lr`` and subtracts:
``p ← p − lr·(adam_dir + wd·p)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, Any]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf by leaf over nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the order JAX flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """Inverse of ``tree_leaves``: a nested dict shaped like ``like``
    from its leaves in sorted-key order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        return next(it)

    return build(like)


def _map_with_path(fn: Callable, tree: Tree, path: Tuple[str, ...] = ()
                   ) -> Tree:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def decay_mask(params: Tree) -> Tree:
    """True where weight decay applies: every leaf except ``*_b`` and
    ``rel_bias``."""
    return _map_with_path(
        lambda path, _: not (path[-1].endswith("_b") or path[-1] == "rel_bias"),
        params)


def freeze_mask(params: Tree) -> Tree:
    """True = trainable: only leaves under ``shared``."""
    return _map_with_path(lambda path, _: "shared" in path, params)


def dynamic_lr(step: torch.Tensor, sched: torch.Tensor, lr: float,
               kind: str = "constant_warmup") -> torch.Tensor:
    """HF warmup schedule with (warmup_iters, t_total) = ``sched`` held
    as state: the k-th step (0-based) uses factor k/warmup while
    k < warmup (so the first update is zero), then 1 (constant) or the
    linear decay to t_total. f32, on ``step``'s device."""
    warmup = sched[0]
    t_total = sched[1].clamp_min(1.0)
    wu = step / warmup.clamp_min(1.0)
    if kind == "constant_warmup":
        return lr * torch.where(step < warmup, wu, torch.ones_like(wu))
    if kind == "linear_warmup":
        decay = ((t_total - step) / (t_total - warmup).clamp_min(1.0)
                 ).clamp(0.0, 1.0)
        return lr * torch.where(step < warmup, wu, decay)
    raise ValueError(kind)


def make_schedule(lr: float, t_total: int, warmup_ratio: float,
                  kind: str = "constant_warmup") -> Callable:
    """step → lr for a fixed horizon; warmup = int(warmup_ratio·t_total)."""
    warmup = int(warmup_ratio * t_total)
    sched = torch.tensor([float(warmup), float(t_total)])
    return lambda step: dynamic_lr(torch.tensor(float(step)), sched, lr, kind)


class AdamState(NamedTuple):
    count: torch.Tensor     # int32 scalar: completed Adam steps
    mu: Tree                # first moments, in the moment dtype
    nu: Tree                # second moments, in the moment dtype


def global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ leaves Σ x²) in f32."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        g_norm: Optional[torch.Tensor] = None) -> Tree:
    """optax's rule: unchanged when ‖g‖ < max_norm, else (g/‖g‖)·max_norm;
    decided on the device (no host read). ``g_norm``: the norm of the
    whole gradient when ``grads`` holds only this rank's FSDP slices."""
    if g_norm is None:
        g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return tree_map(lambda t: torch.where(
        trigger, t, (t / g_norm.to(t.dtype)) * max_norm), grads)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, count)


def _pow(base: float, c: torch.Tensor) -> torch.Tensor:
    """base ** c in f32, as JAX raises a weakly typed float to an f32."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=c.device), c)


def scale_by_hf_adamw(grads: Tree, state: AdamState, b1: float, b2: float,
                      eps: float) -> Tuple[Tree, AdamState]:
    """HF 4.2.1 AdamW's direction: √(1−β₂ᵗ)/(1−β₁ᵗ) · m/(√v+ε), ε added
    to the UNCORRECTED √v. Moments keep their stored dtype; the
    arithmetic is f32."""
    count = _safe_increment(state.count)
    c = count.float()
    corr = torch.sqrt(1.0 - _pow(b2, c)) / (1.0 - _pow(b1, c))

    def one(g, m, v):
        gf = g.float()
        m2 = b1 * m.float() + (1.0 - b1) * gf
        v2 = b2 * v.float() + (1.0 - b2) * gf * gf
        return corr * m2 / (torch.sqrt(v2) + eps), m2.to(m.dtype), \
            v2.to(v.dtype)

    return _split3(tree_map(one, grads, state.mu, state.nu), count)


def scale_by_adam(grads: Tree, state: AdamState, b1: float, b2: float,
                  eps: float) -> Tuple[Tree, AdamState]:
    """optax / torch.optim.AdamW's direction m̂/(√v̂+ε). With f32
    moments it is ``optax.scale_by_adam`` term for term; with bf16
    moments, ``scale_by_adam_lowmem``."""
    count = _safe_increment(state.count)
    c = count.float()
    b1c = 1.0 - _pow(b1, c)
    b2c = 1.0 - _pow(b2, c)

    def one(g, m, v):
        gf = g.float()
        if m.dtype == torch.float32:
            m2 = (1.0 - b1) * gf + b1 * m
            v2 = (1.0 - b2) * (gf * gf) + b2 * v
            return (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps), m2, v2
        m2 = b1 * m.float() + (1.0 - b1) * gf
        v2 = b2 * v.float() + (1.0 - b2) * gf * gf
        return (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps), m2.to(m.dtype), \
            v2.to(v.dtype)

    return _split3(tree_map(one, grads, state.mu, state.nu), count)


def _split3(triples: Tree, count: torch.Tensor) -> Tuple[Tree, AdamState]:
    pick = lambda i: tree_map(lambda t: t[i], triples)
    return pick(0), AdamState(count=count, mu=pick(1), nu=pick(2))


def add_decayed_weights(updates: Tree, params: Tree, weight_decay: float,
                        mask: Tree) -> Tree:
    """u + wd·p on the leaves ``mask`` marks."""
    return tree_map(lambda u, p, m: u + weight_decay * p if m else u,
                    updates, params, mask)


class Transform(NamedTuple):
    """LR-less AdamW direction: ``init(params) → state`` and
    ``update(grads, state, params, g_norm=None) → (direction, state)``.
    Every rule but the clip is elementwise, so under FSDP the transform
    runs on this rank's slices of grads, moments and parameters, given
    the whole gradient's norm (``g_norm``)."""
    init: Callable
    update: Callable


def make_transform(cfg_train, with_clip: bool = True) -> Transform:
    """clip → Adam moments → masked decoupled decay [→ freeze mask], as
    ``vqacl_tpu.train.optim.make_transform`` chains them."""
    moment_dtype = (torch.bfloat16
                    if cfg_train.adam_dtype in ("bfloat16", "bf16")
                    else torch.float32)
    impl = cfg_train.adam_impl
    if impl not in ("hf", "torch"):
        raise ValueError(f"adam_impl {impl!r}")
    scale = scale_by_hf_adamw if impl == "hf" else scale_by_adam
    b1, b2, eps = (cfg_train.adam_beta1, cfg_train.adam_beta2,
                   cfg_train.adam_eps)

    def init(params: Tree) -> AdamState:
        dev = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads: Tree, state: AdamState, params: Tree,
               g_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, AdamState]:
        if with_clip:
            grads = clip_by_global_norm(grads, cfg_train.clip_grad_norm,
                                        g_norm)
        updates, state = scale(grads, state, b1, b2, eps)
        updates = add_decayed_weights(updates, params,
                                      cfg_train.weight_decay,
                                      decay_mask(params))
        if cfg_train.freeze:
            updates = tree_map(lambda u, m: u if m else torch.zeros_like(u),
                               updates, freeze_mask(params))
        return updates, state

    return Transform(init, update)
