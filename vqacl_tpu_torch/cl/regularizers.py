"""Parameter-importance CL regularizers: EWC and MAS (counterpart of
``vqacl_tpu/cl/regularizers.py``).

The paper's Table 1 compares VQACL against EWC (Kirkpatrick et al.,
2017) and MAS (Aljundi et al., 2018); the reference repo implements
neither, the JAX package supplies both and the port follows it:

- **EWC**: importance = diagonal empirical Fisher, the squared gradient
  of the task NLL at the task's end, accumulated online across tasks
  with the latest parameters as anchor ("online EWC"); penalty
  ``λ/2 Σ_i F_i (θ_i − θ*_i)²``.
- **MAS**: importance = ``E |∂/∂θ ‖f(x;θ)‖₂²|``, the gradient magnitude
  of the squared L2 norm of the model's output logits (label-free),
  with the same online accumulation and penalty form.

``RegState`` holds f32 trees shaped like the parameters, on their
device. The importance pass differentiates the retrieval-only forward
at dropout 0, so the encoder attention runs through the training
kernels (K1′ at rate 0, then K2); the accumulator adds in place. The
penalty is differentiated inside the train step
(``train/step.py::make_train_step(reg_lambda=…)``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten
from vqacl_tpu_torch.utils.device import resolve_device

KINDS = ("ewc", "mas")


class RegState(NamedTuple):
    """Importance weights + anchor parameters (both parameter-shaped f32
    trees). ``omega`` starts at zeros, so the penalty is exactly 0 until
    the first consolidation: task 0 trains unregularized."""

    omega: Any
    anchor: Any


def _anchor_copy(params) -> Any:
    """An f32 COPY of the parameters, never an alias: the train step
    replaces ``state.params`` each step, and an anchor must keep the
    values it was taken at."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def init_reg_state(params) -> RegState:
    """Zero importance, the current parameters as the (inert) anchor."""
    f32 = _anchor_copy(params)
    return RegState(omega=tree_map(torch.zeros_like, f32), anchor=f32)


def penalty(params, reg: RegState, sliced=None) -> torch.Tensor:
    """``Σ_i ω_i (θ_i − θ*_i)²`` in f32 over every leaf (the λ/2 scaling
    lives in the caller); differentiable in ``params``. Under tensor
    parallelism (``params`` and ``reg`` the rank's tp slices; ``sliced``
    the leaves' tp dimensions, None where whole) the sum over the sliced
    leaves is summed over the tp group (``reduce_from_tp``: each rank's
    gradient stays its slice's), the whole leaves' added once."""
    from vqacl_tpu_torch.parallel.mesh import reduce_from_tp

    dev = tree_leaves(params)[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    cut = torch.zeros((), dtype=torch.float32, device=dev)
    leaves = tree_leaves(params)
    sliced = [None] * len(leaves) if sliced is None else sliced
    for p, w, a, d in zip(leaves, tree_leaves(reg.omega),
                          tree_leaves(reg.anchor), sliced):
        term = torch.sum(w * (p.float() - a) ** 2)
        if d is None:
            total = total + term
        else:
            cut = cut + term
    return total if all(d is None for d in sliced) else \
        total + reduce_from_tp(cut)


def make_importance_step(cfg, kind: str, dtype=torch.bfloat16,
                         device="cuda", mesh_ctx=None) -> Callable:
    """Returns ``(acc, params, proto, batch) -> acc`` adding one batch's
    importance estimate into ``acc`` (an f32 parameter-shaped tree on the
    device) in place.

    The forward is the retrieval-only eval graph (the prototype banks
    are NOT updated: importance estimation must not change the training
    state), deterministic. EWC differentiates the task's weighted NLL
    (empirical Fisher); MAS differentiates the squared L2 norm of the
    valid-token logits. ``batch`` holds input_ids, vis_feats, boxes,
    target_ids and scores as numpy arrays or tensors.

    With ``mesh_ctx`` (data parallelism, ``batch`` this rank's rows) the
    importance is that of the global batch, as JAX's global-batch
    ``jax.grad`` gives it: each rank differentiates its share of the
    objective (EWC's row mean over the global batch, MAS's masked mean
    over the count all-reduced over dp, both divided by pp), the
    gradients are summed over dp × pp (train/step.py's rule), and only
    then squared (EWC) or taken in magnitude (MAS). ``params`` is the full
    tree: the forward runs as on one device (under pp, through the
    pipelined stacks of ``cfg.model.pp_mesh``)."""
    if kind not in KINDS:
        raise ValueError(f"unknown regularizer {kind!r}; pick from {KINDS}")
    from vqacl_tpu_torch.train.step import (_TRAIN_KEYS, _dp, _to_device,
                                            reduce_grads)

    dev = resolve_device(device)
    mcfg = cfg.model
    ctx = _dp(mesh_ctx)
    dp = ctx.dp if ctx is not None else 1
    pp = ctx.pp if ctx is not None else 1

    def objective(params, proto: ProtoState, b: Dict) -> torch.Tensor:
        hidden, enc_mask = vlt5.encode(params, mcfg, b["input_ids"],
                                       b["vis_feats"], b["boxes"],
                                       dtype=dtype)
        if mcfg.use_prototype:
            hidden, enc_mask, _, _ = vlt5.augment(mcfg, hidden, enc_mask,
                                                  proto)
        logits = vlt5.decode_train(params, mcfg, hidden, enc_mask,
                                   b["target_ids"], dtype=dtype)
        if kind == "ewc":
            loss = vlt5.weighted_lm_loss(logits, b["target_ids"],
                                         b["scores"])
            return loss / (dp * pp) if dp * pp > 1 else loss
        mask = (b["target_ids"] != -100).float()
        sq = torch.sum(logits.float() ** 2, dim=-1)               # [B,T]
        count = mask.sum()
        if ctx is not None:
            count = ctx.all_reduce(count.clone(), "dp")
        obj = torch.sum(sq * mask) / count.clamp_min(1.0)
        return obj / pp if pp > 1 else obj

    def step(acc, params, proto: ProtoState, batch: Dict):
        b = _to_device(batch, _TRAIN_KEYS, dev)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(objective(live, proto, b), leaves,
                                    allow_unused=True)
        if ctx is not None:     # over dp x pp
            grads = tree_leaves(reduce_grads(ctx, tree_unflatten(params, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)])))
        with torch.no_grad():
            for a, g in zip(tree_leaves(acc), grads):
                if g is None:
                    continue
                g = g.float()
                a.add_(g * g if kind == "ewc" else g.abs())
        return acc

    return step


def consolidate(reg: RegState, params, acc, n_batches: int) -> RegState:
    """End-of-task update: ``ω += mean_batch(importance)``, anchor = the
    just-trained parameters (online EWC/MAS: one ω/θ* pair covers all
    past tasks, constant memory in the task count)."""
    inv = 1.0 / max(int(n_batches), 1)
    omega = tree_map(lambda w, a: w + a * inv, reg.omega, acc)
    return RegState(omega=omega, anchor=_anchor_copy(params))
