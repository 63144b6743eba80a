"""Prototype banks and retrieval (counterpart of
``vqacl_tpu/models/prototype.py``), retrieval only.

``ProtoState`` carries the per-question-type (Q) and per-category (V)
banks and their bookkeeping as explicit state; the serving path reads
the banks and never updates them. The EMA update comes with the
training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ProtoState(NamedTuple):
    """Prototype banks + bookkeeping. Shapes for VQA v2: Q [10, d], V [80, d]."""

    q_proto: torch.Tensor        # [NQ, D] retrieval bank
    v_proto: torch.Tensor        # [NV, D] retrieval bank
    q_mem_proto: torch.Tensor    # [NQ, D] current task's memory bank
    q_num: torch.Tensor          # [NQ] accumulated per-class counts
    v_num: torch.Tensor          # [NV]
    task_id: torch.Tensor        # scalar int32 — current task index
    steps_in_task: torch.Tensor  # scalar int32 — batches seen this task

    @staticmethod
    def create(n_ques_types: int, n_categories: int, d_model: int,
               dtype=torch.float32, device="cuda") -> "ProtoState":
        z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
        return ProtoState(
            q_proto=z(n_ques_types, d_model),
            v_proto=z(n_categories, d_model),
            q_mem_proto=z(n_ques_types, d_model),
            q_num=z(n_ques_types),
            v_num=z(n_categories),
            task_id=z(dt=torch.int32),
            steps_in_task=z(dt=torch.int32),
        )

    def to(self, device) -> "ProtoState":
        return ProtoState(*(t.to(device) for t in self))


def cosine_retrieve(bank: torch.Tensor, pooled: torch.Tensor,
                    labels: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tanh → L2-normalize → cosine argmax retrieval.

    Returns (selected [B,D] raw bank rows, argmax idx [B], retrieval
    accuracy scalar — -1.0 when labels are None)."""
    def norm(x):
        t = torch.tanh(x.float())
        return t / torch.linalg.vector_norm(t, dim=-1,
                                            keepdim=True).clamp_min(1e-12)

    sim = norm(pooled) @ norm(bank).t()         # [B, C]
    idx = torch.argmax(sim, dim=-1)             # [B]
    selected = bank[idx]
    if labels is not None:
        true_idx = torch.argmax(labels, dim=-1)
        acc = (idx == true_idx).float().mean()
    else:
        acc = torch.tensor(-1.0, device=bank.device)
    return selected, idx, acc
