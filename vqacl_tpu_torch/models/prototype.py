"""Prototype banks, their EMA update and retrieval (counterpart of
``vqacl_tpu/models/prototype.py``).

``ProtoState`` carries the per-question-type (Q) and per-category (V)
banks and their bookkeeping as explicit state: the train step passes a
state in and gets a new one back (nothing is mutated in place), the
serving path reads the banks and never updates them. Every branch of the
reference's update (first batch of a task or later, task 0 or later,
the memory-bank bootstrap on the second batch) is a ``torch.where`` on
the counters in the state, so no branch reads a value back to the host.
Everything that enters a bank is detached.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vqacl_tpu_torch.parallel.mesh import active


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

    def start_task(self, task_id: int) -> "ProtoState":
        """Task boundary: a new task id and fresh 'seen' counters; the
        banks persist."""
        dev = self.task_id.device
        return self._replace(
            task_id=torch.tensor(task_id, dtype=torch.int32, device=dev),
            steps_in_task=torch.zeros((), dtype=torch.int32, device=dev))


def batch_class_means(hidden_pooled: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class mean of pooled hiddens [B,D] under one-hot labels [B,C]
    → ([C,D] means, zero rows for absent classes; [C] counts). Under an
    active data-parallel mesh the class sums and counts are summed over
    the dp group first (one ``all_reduce``), so every rank's EMA update sees
    the global batch, as JAX's does (the bank update detaches its input,
    so the summed means carry no gradient)."""
    counts = labels.sum(dim=0)
    sums = labels.float().t() @ hidden_pooled.float()
    ctx = active()
    if ctx is not None:
        both = ctx.all_reduce(torch.cat([sums.detach(),
                                         counts.float()[:, None]], 1), "dp")
        sums, counts = both[:, :-1], both[:, -1].to(counts.dtype)
    denom = torch.where(counts <= 0, torch.ones_like(counts), counts)
    return sums / denom[:, None], counts


def proto_update(state: ProtoState, cur_q: torch.Tensor, cur_v: torch.Tensor,
                 num_q: torch.Tensor, num_v: torch.Tensor,
                 proto_alpha: float, proto_beta: float) -> ProtoState:
    """The reference's ``update_prototype`` (tid = current task id):
      step 0 of a task: nums ← batch counts; V ← cur_V;
                        tid == 0: Q ← cur_Q, else Q[tid] ← cur_Q[tid]
      step ≥ 1: tid == 0: Q ← cur_Q
                tid > 0:  mem = cur_Q with row tid zeroed
                          step 1: Q_mem ← mem (bootstrap)
                          step > 1: Q_mem ← α·Q_mem + (1−α)·mem
                          Q ← Q_mem with row tid ← cur_Q[tid]
                V ← β·V + (1−β)·cur_V; nums ← nums + batch counts."""
    cur_q = cur_q.detach().to(state.q_proto.dtype)
    cur_v = cur_v.detach().to(state.v_proto.dtype)
    num_q = num_q.detach().to(state.q_num.dtype)
    num_v = num_v.detach().to(state.v_num.dtype)

    tid = state.task_id
    step = state.steps_in_task
    first = step == 0
    second = step == 1
    task0 = tid == 0

    nq = state.q_proto.shape[0]
    row_is_tid = (torch.arange(nq, device=tid.device) == tid)[:, None]
    mem_candidate = torch.where(row_is_tid, 0.0, cur_q)

    q_mem_new = torch.where(
        second, mem_candidate,
        proto_alpha * state.q_mem_proto + (1.0 - proto_alpha) * mem_candidate)
    q_mem = torch.where(first, state.q_mem_proto, q_mem_new)

    q_first = torch.where(task0, cur_q,
                          torch.where(row_is_tid, cur_q, state.q_proto))
    q_later = torch.where(task0, cur_q,
                          torch.where(row_is_tid, cur_q, q_mem))
    q_proto = torch.where(first, q_first, q_later)

    v_proto = torch.where(first, cur_v,
                          proto_beta * state.v_proto
                          + (1.0 - proto_beta) * cur_v)

    q_num = torch.where(first, num_q, state.q_num + num_q)
    v_num = torch.where(first, num_v, state.v_num + num_v)
    return state._replace(q_proto=q_proto, v_proto=v_proto,
                          q_mem_proto=q_mem, q_num=q_num, v_num=v_num,
                          steps_in_task=step + 1)


def memory_loss(pooled_q: torch.Tensor, pooled_v: torch.Tensor,
                ques_labels: torch.Tensor, cate_labels: torch.Tensor,
                state: ProtoState) -> Tuple[torch.Tensor, torch.Tensor]:
    """SI regulariser: squared L2 pull of the pooled hiddens toward their
    label's (detached) prototype; the gradient reaches the hiddens."""
    q_tgt = (ques_labels @ state.q_proto).detach()
    v_tgt = (cate_labels @ state.v_proto).detach()
    loss_q = ((pooled_q - q_tgt) ** 2).sum(dim=-1).mean()
    loss_v = ((pooled_v - v_tgt) ** 2).sum(dim=-1).mean()
    return loss_q, loss_v


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
