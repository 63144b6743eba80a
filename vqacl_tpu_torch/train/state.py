"""Train state (counterpart of ``vqacl_tpu/train/state.py``): one tuple
holding everything the train step reads and replaces — the step count,
f32 master parameters, the Adam state, the prototype state, the dropout
generator and the schedule horizon.

The JAX state carries a PRNG key that the step splits; here an explicit
``torch.Generator`` on the parameters' device takes its place. The step
returns a new tuple but draws from the same generator object, which
advances in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.train.optim import AdamState, Transform, tree_leaves


class TrainState(NamedTuple):
    step: torch.Tensor           # int32: optimizer steps in the current group
    params: Any                  # f32 master parameters (nested dict)
    opt_state: AdamState
    proto: ProtoState
    generator: torch.Generator   # dropout draws, on the parameters' device
    sched: torch.Tensor          # f32 [warmup_iters, t_total]
    # f32 [MoE layers, router experts]: VL-Moonlight's selection bias
    # (models/moonlight.py), moved by the step after the optimizer and
    # not a parameter of it; None for VL-T5
    router_bias: Any = None

    @staticmethod
    def create(params: Any, tx: Transform, proto: ProtoState, seed: int = 0,
               warmup_iters: float = 100.0, t_total: float = 1000.0
               ) -> "TrainState":
        dev = tree_leaves(params)[0].device
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params,
            opt_state=tx.init(params),
            proto=proto,
            generator=torch.Generator(device=dev).manual_seed(seed),
            sched=torch.tensor([warmup_iters, t_total], dtype=torch.float32,
                               device=dev))

    def reset_optimizer(self, tx: Transform, warmup_iters: float,
                        t_total: float) -> "TrainState":
        """A fresh AdamW per (task × group): zeroed moments, the step
        counter restarted, a new schedule horizon."""
        dev = self.step.device
        return self._replace(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            opt_state=tx.init(self.params),
            sched=torch.tensor([warmup_iters, t_total], dtype=torch.float32,
                               device=dev))
