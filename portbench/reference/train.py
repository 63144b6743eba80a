"""The reference's first training steps, from the seed.

``first_steps`` follows the steps the program ran first, given by their
rows (question ids and the padded batch size): the weights made from the
seed, the prototype banks the benchmark made, dropout from the trainer's
stream (the configuration's seed + 1), the configuration's clip, HF AdamW
(ε on the uncorrected √v, bias correction in the step size, moments
stored in the stated type), decoupled weight decay off the ``*_b`` and
``rel_bias`` leaves, and the warmup schedule, whose first step moves
nothing. It returns each step's loss, each leaf's norm of the first
(clipped) gradient and of its change over the steps, in the weights'
sorted path order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench import weights as W
from portbench.reference import inputs, model
from portbench.reference.precision import Precision

MOMENT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lr_at(k: int, base: float, warmup: float, t_total: float,
          kind: str) -> float:
    """The HF warmup schedule at the k-th step (0-based)."""
    if k < warmup:
        return base * k / max(warmup, 1.0)
    if kind == "constant_warmup":
        return base
    return base * min(max((t_total - k) / max(t_total - warmup, 1.0), 0.0),
                      1.0)


def schedule(cfg: Dict, n_group: int, replay: bool) -> Tuple[float, float]:
    """(warmup, t_total) of a group's fresh optimizer: the reference's
    t_total over ``epochs`` of the group's train items, doubled when
    replay steps alternate with them, and the warmup share of it."""
    tr = cfg["train"]
    total = 2 * n_group if replay else n_group
    t_total = max(int(total / tr["batch_size"]), 1) * tr["epochs"]
    return float(int(t_total * tr["warmup_ratio"])), float(t_total)


def first_steps(traffic, cfg: Dict, seed: int, steps: Sequence[Tuple[list,
                                                                     int]],
                banks0: Dict[str, torch.Tensor], task: int,
                sched: Tuple[float, float], device, P: Precision
                ) -> Dict[str, List[float]]:
    tr = cfg["train"]
    pairs = W.flatten(W.make_weights(cfg, seed, device))
    paths = [p for p, _ in pairs]
    leaves = [t.clone().requires_grad_(True) for _, t in pairs]
    p0 = [t for _, t in pairs]
    w = W.unflatten(zip(paths, leaves))
    mdt = MOMENT[cfg["precision"]["adam_moments"]]
    mu = [torch.zeros_like(t, dtype=mdt) for t in leaves]
    nu = [torch.zeros_like(t, dtype=mdt) for t in leaves]
    decay = [not (p[-1].endswith("_b") or p[-1] == "rel_bias")
             for p in paths]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    drop = model.Drop(gen, cfg["dropout_rate"])
    banks = {"q": banks0["q_proto"], "v": banks0["v_proto"],
             "q_mem": banks0["q_mem_proto"],
             "nq": torch.zeros(cfg["n_ques_types"], device=device),
             "nv": torch.zeros(cfg["n_categories"], device=device),
             "task": task, "step": 0}
    b1, b2, eps = tr["adam_beta1"], tr["adam_beta2"], tr["adam_eps"]
    out: Dict[str, List[float]] = {"loss": [], "grad1": [], "grad_norm": []}
    for k, (qids, Bp) in enumerate(steps):
        batch = inputs.batch(traffic, qids, Bp, cfg,
                             cfg["precision"]["feature_table"]
                             if cfg["feature_path"] == "device_cache"
                             else "float32", device)
        loss, banks = model.train_loss(P, w, cfg, batch, banks, drop,
                                       tr["proto_alpha"], tr["proto_beta"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        if gnorm >= tr["clip_grad_norm"]:
            grads = [g / gnorm * tr["clip_grad_norm"] for g in grads]
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(float(gnorm))
        if k == 0:
            out["grad1"] = [float(g.norm()) for g in grads]
        c = k + 1
        corr = (1.0 - b2 ** c) ** 0.5 / (1.0 - b1 ** c)
        lr = lr_at(k, tr["lr"], sched[0], sched[1], tr["schedule"])
        with torch.no_grad():
            for i, (t, g) in enumerate(zip(leaves, grads)):
                m2 = b1 * mu[i].float() + (1.0 - b1) * g
                v2 = b2 * nu[i].float() + (1.0 - b2) * g * g
                u = corr * m2 / (torch.sqrt(v2) + eps)
                if decay[i]:
                    u = u + tr["weight_decay"] * t
                mu[i], nu[i] = m2.to(mdt), v2.to(mdt)
                t -= lr * u
    out["change"] = [float((t.detach() - a).norm())
                     for t, a in zip(leaves, p0)]
    out["paths"] = [".".join(p) for p in paths]
    return out
