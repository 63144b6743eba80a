"""CUDA-graph replay of the VL-T5 train step.

Eagerly, a t5-base train step at batch 80 is ~4,550 kernel launches
that the host issues one by one (forward, autograd backward, the fused
optimizer), and the card waits on them. ``GraphedStep`` captures the
whole step once per batch signature as ``torch.cuda.CUDAGraph``s and
then replays it: one graph launch a step, after the batch is copied
into the graph's static buffers. The kernels are the eager step's
(K1′/K2, the fused AdamW, the rest); only their launch changes.

State. The graphs read and write two fixed state slots, each a
``TrainState`` whose parameters are views of one flat f32 buffer and
whose moments are views of one buffer in the moments' dtype (first
moments, then second), in sorted-leaf order: the layout the fused
optimizer writes (``ops/adamw.py``, ``out``). Graph ``p`` reads slot
``p`` and writes slot ``1 − p``, so nothing is copied back: the
optimizer's kernel writes the new parameters and moments into the other
slot, and only the small leaves (step, Adam count, schedule, prototype
banks) are copied there inside the graph. The returned state is a slot,
and the next call passes it back.

Aliasing contract: the state a replayed step returns is overwritten two
steps later, and a state passed in that is not one of the slots (the
first call, after ``reset_optimizer``, a checkpoint load or any
``_replace``) is copied into slot 0 first and left as it was. Whoever
keeps a state across steps keeps a copy (``cl/regularizers.py``'s
anchors, the checkpointers' host copies).

The metrics a replay returns are views of one fresh tensor (a clone of
the graph's output), so a step's ``loss`` kept for later is not changed
by the next replay.

Randomness: the state's generator is registered with every graph
(``register_generator_state``), so each replay draws what the eager
step would have drawn from it (dropout's ``torch.rand`` masks and K1′'s
seeds), and advances it as the eager step does.

The step runs eagerly (``graph.eager_steps``) where a graph cannot stand
for it, as decided from what it is given: off the card; with a mesh,
FSDP or tp layouts, ``grad_accum`` > 1 or ``remat`` (``eligible`` False
at construction); with a regularizer (EWC/MAS); for a state of another
layout or generator than the slots'; past ``MAX_SIGNATURES`` batch
signatures. A signature's first call runs the step eagerly on a side
stream as warm-up (also an eager step) and then captures both graphs
(``graph.captures``); later calls replay (``graph.replays``).

Counters. A capture launches nothing, so the kernel wrappers' host-side
launch counters (``ops/launches.py``) are put back after it and, with
the recorder's ``count``s made inside it (``profiling.diverted``), added
again at each replay: the counts read as if the step had run eagerly.
With the recorder on, a replay is the span ``step.train`` around
``step.graph_replay``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.train.optim import AdamState, tree_leaves, tree_unflatten
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.utils import profiling as P

MAX_SIGNATURES = 4
METRICS = ("loss", "grad_norm", "lr", "loss_memory_Q", "loss_memory_V",
           "retrieval_acc_Q", "retrieval_acc_V")
# a step's core: (state, batch, reg, out) -> (state, metrics)
Core = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def capturable(state: TrainState) -> bool:
    """Whether the state lives on a CUDA device."""
    return state.step.is_cuda


class CudaGraphs:
    """Warm-up and capture on one side stream, every graph into one
    memory pool: the wrapper's graphs replay one at a time on one stream,
    and what outlives a replay (the slots, the batch buffers, each graph's
    metrics output) is never handed back to the pool."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def run(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``fn()`` eagerly on the side stream, ordered after and before
        the current stream's work."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        out.record_stream(cur)
        return out

    def capture(self, fn: Callable[[], torch.Tensor],
                generator: torch.Generator
                ) -> Tuple[Callable[[], None], torch.Tensor]:
        """``fn`` captured (nothing runs) → (replay, its output)."""
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(generator)
        # thread_local: the loaders' threads may touch CUDA meanwhile
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return g.replay, out


def state_leaves(s: TrainState) -> List[torch.Tensor]:
    """Every tensor of a VL-T5 state, in a fixed order."""
    o = s.opt_state
    return [s.step, s.sched, o.count, *tree_leaves(s.params),
            *tree_leaves(o.mu), *tree_leaves(o.nu), *s.proto]


def signature(batch: Dict, keys) -> tuple:
    """The batch's arrays among ``keys``: (key, shape, dtype), by key."""
    out = []
    for k in sorted(keys):
        x = batch.get(k)
        if isinstance(x, np.ndarray):
            out.append((k, x.shape, torch.from_numpy(x).dtype))
        elif isinstance(x, torch.Tensor):
            out.append((k, tuple(x.shape), x.dtype))
    return tuple(out)


class Slot:
    """A state in the flat layout: ``state``, and the flat buffers of its
    parameters (f32 [T]) and moments ([2·T])."""

    def __init__(self, like: TrainState):
        p_l = tree_leaves(like.params)
        mdt = tree_leaves(like.opt_state.mu)[0].dtype
        T = sum(p.numel() for p in p_l)
        dev = p_l[0].device
        self.P = torch.empty(T, dtype=torch.float32, device=dev)
        self.M = torch.empty(2 * T, dtype=mdt, device=dev)
        from torch._utils import _unflatten_dense_tensors as views
        e = torch.empty_like
        o = like.opt_state
        self.state = TrainState(
            step=e(like.step), params=tree_unflatten(like.params,
                                                     views(self.P, p_l)),
            opt_state=AdamState(
                count=e(o.count),
                mu=tree_unflatten(o.mu, views(self.M[:T], p_l)),
                nu=tree_unflatten(o.nu, views(self.M[T:], p_l))),
            proto=ProtoState(*(e(t) for t in like.proto)),
            generator=like.generator, sched=e(like.sched))
        self.layout = [(t.shape, t.dtype) for t in state_leaves(self.state)]

    def fits(self, state: TrainState) -> bool:
        """Whether ``state`` has this slot's leaves and generator."""
        return state.generator is self.state.generator \
            and state.router_bias is None \
            and [(t.shape, t.dtype) for t in state_leaves(state)] \
            == self.layout

    def store(self, state: TrainState) -> None:
        """``state``'s values into the slot (leaves already in place are
        skipped)."""
        for d, s in zip(state_leaves(self.state), state_leaves(state)):
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)


class _Entry:
    """One batch signature's static batch, graphs and their outputs."""

    def __init__(self, batch: Dict[str, torch.Tensor]):
        self.batch = batch
        self.replay: List[Callable[[], None]] = [None, None]
        self.out: List[torch.Tensor] = [None, None]
        self.launches: List[Dict[tuple, int]] = [{}, {}]
        self.counts: List[Dict[str, int]] = [{}, {}]


class GraphedStep:
    """``(state, batch, reg=None) -> (state, metrics)`` over ``core``
    (the eager step, which takes ``out``: where the optimizer writes);
    ``keys`` the batch entries the step reads; ``eligible`` False keeps
    every call eager. ``captures``, ``replays``, ``eager_steps``: how
    its calls ran (also the recorder's ``graph.*`` counters)."""

    def __init__(self, core: Core, keys, eligible: bool):
        self.core, self.keys, self.eligible = core, tuple(keys), eligible
        self.slots: Optional[List[Slot]] = None
        self.entries: Dict[tuple, _Entry] = {}
        self.backend: Optional[CudaGraphs] = None
        self.captures = self.replays = self.eager_steps = 0

    def __call__(self, state: TrainState, batch: Dict, reg=None):
        if not self.eligible or reg is not None or not capturable(state):
            return self._eager(state, batch, reg)
        key = signature(batch, self.keys)
        entry = self.entries.get(key)
        if entry is None and len(self.entries) >= MAX_SIGNATURES:
            return self._eager(state, batch, reg)
        p = self._enter(state)
        if p is None:
            return self._eager(state, batch, reg)
        if entry is None:
            return self._first(key, p, batch)
        return self._replay(entry, p, batch)

    def _eager(self, state, batch, reg):
        self.eager_steps += 1
        P.count("graph.eager_steps")
        with P.span("step.train"):
            return self.core(state, batch, reg)

    def _enter(self, state: TrainState) -> Optional[int]:
        """The slot the step reads: the one ``state`` is, else slot 0
        with ``state`` copied in; None when it does not fit the slots."""
        if self.slots is None:
            self.slots = [Slot(state), Slot(state)]
            self.backend = self._backend(state.step.device)
        for p, slot in enumerate(self.slots):
            if state is slot.state:
                return p
        if not self.slots[0].fits(state):
            return None
        self.slots[0].store(state)
        return 0

    def _backend(self, device) -> CudaGraphs:
        return CudaGraphs(device)

    def _body(self, p: int, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Slot ``p`` → slot ``1 − p``; the metrics as one f32 vector."""
        dst = self.slots[1 - p]
        new, m = self.core(self.slots[p].state, batch, None, (dst.P, dst.M))
        dst.store(new)
        return torch.stack([m[k].float() for k in METRICS])

    def _first(self, key: tuple, p: int, batch: Dict):
        """Warm-up (the step, eagerly, on the side stream), then both
        graphs of the signature captured."""
        dev = self.slots[0].P.device
        static = {}
        for k, shape, dtype in key:
            static[k] = torch.empty(shape, dtype=dtype, device=dev)
        entry = _Entry(static)
        self._fill(entry, batch)
        with P.span("step.train"):
            vals = self.backend.run(lambda: self._body(p, static))
        self.eager_steps += 1
        P.count("graph.eager_steps")
        for q in (0, 1):
            before = launches.read()
            with P.diverted() as counts:
                entry.replay[q], entry.out[q] = self.backend.capture(
                    lambda q=q: self._body(q, static),
                    self.slots[0].state.generator)
            entry.launches[q] = launches.since(before)
            launches.add(entry.launches[q], -1)   # nothing was launched
            entry.counts[q] = counts
        self.entries[key] = entry
        self.captures += 1
        P.count("graph.captures")
        return self.slots[1 - p].state, dict(zip(METRICS, vals.unbind()))

    def _fill(self, entry: _Entry, batch: Dict) -> None:
        """The batch into the static buffers."""
        for k, buf in entry.batch.items():
            x = batch[k]
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if x.device.type == "cpu" and buf.device.type != "cpu":
                P.count("h2d_bytes", x.numel() * x.element_size())
            buf.copy_(x, non_blocking=True)

    def _replay(self, entry: _Entry, p: int, batch: Dict):
        with P.span("step.train"), P.span("step.graph_replay"):
            self._fill(entry, batch)
            entry.replay[p]()
            vals = entry.out[p].clone()
        launches.add(entry.launches[p])
        for name, n in entry.counts[p].items():
            P.count(name, n)
        self.replays += 1
        P.count("graph.replays")
        return self.slots[1 - p].state, dict(zip(METRICS, vals.unbind()))
