"""The process group, data-parallel placement and the port's collectives
(counterpart of ``vqacl_tpu/parallel/mesh.py``).

The reference's strategy is DDP with one process per GPU
(``VL-T5/src/vqacl.py:127,643-645``, ``dist_utils.py``); the port runs
exactly that over ``torch.distributed``. Where JAX has one process and a
``Mesh`` of devices, each rank here is one process on one device, and a
``MeshContext`` names the rank, its device and the mesh's axis sizes:

  ``dp``   data parallel: every rank builds the same global host batch
           from the same seed and runs its own rows (``shard_batch``);
           the train steps sum the gradients of the ranks' shares of the
           global loss in one ``all_reduce`` (train/step.py).
  ``tp``   tensor parallel (Megatron): a rank keeps its slice of the
           heads and of the MLP hidden (parallel/sharding.py) and runs
           the tp blocks (models/t5.py), whose partial outputs are summed
           over the tp group (``reduce_from_tp``) before each residual.
  ``pp``   pipeline parallel: a rank runs its stage's blocks of each
           stack in a GPipe schedule over microbatches
           (parallel/pipeline.py).

The ranks are laid out as JAX reshapes its devices, ``(dp, tp, pp)``:
rank ``r = (d·tp + t)·pp + s`` has dp index d, tp index t and pp stage
s. Every collective names its group: "dp" (the ranks that share t and
s: rows and their statistics), "tp" (share d and s), "pp" (share d and
t), "dpp" (share t: the gradient bucket, dp × pp) or "world". At tp =
pp = 1 each of them is the world, as before.

Every collective of the port goes through ``all_reduce`` and
``broadcast`` only: a gather is an ``all_reduce`` of a zeroed buffer in
which each rank writes its own slot (``combine``: summed as int32 words,
so the result is each slot's bytes exactly). Those two are what gloo
takes on CUDA tensors, so every path runs on NCCL, on gloo on the CPU
and on gloo with several ranks on one card.

``data_parallel(ctx)`` makes a context the active one for the code that
runs inside it (a train step): dropout then draws its masks at the
global batch's shape (and, under tp, width) and keeps this rank's rows
(and columns), the fused attention kernels take this rank's Philox row
offset (``bh0``) and heads (``Hc``, ``h0``), the blocks run tensor
parallel when tp > 1, and the prototype update sums its class
statistics over the dp group (models/t5.py, models/prototype.py).
Outside it the models run as on one device. ``copy_to_tp`` and
``reduce_from_tp`` are the Megatron pair of differentiable collectives:
identity forward with an all_reduce over tp backward, and the reverse.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vqacl_tpu_torch.utils.device import resolve_device


def mesh_shape(n: int, dp: int = -1, tp: int = 1, pp: int = 1
               ) -> Tuple[int, int, int]:
    """JAX's mesh arithmetic over ``n`` ranks (``make_mesh``,
    vqacl_tpu/parallel/mesh.py:58-82): ``dp=-1`` takes every rank left by
    tp·pp; the product must be ``n``. Raises ValueError with JAX's
    assertion messages."""
    if dp == -1:
        if n % (tp * pp):
            raise ValueError(f"{n} devices not divisible by tp*pp={tp * pp}")
        dp = n // (tp * pp)
    if dp * tp * pp != n:
        raise ValueError(f"dp*tp*pp={dp * tp * pp} != n_devices={n}")
    return dp, tp, pp


GROUPS = ("dp", "tp", "pp", "dpp")


def group_members(name: str, rank: int, dp: int, tp: int, pp: int) -> list:
    """The ranks of the group ``name`` that holds ``rank``, in the
    group's order, for the layout r = (d·tp + t)·pp + s."""
    s, t, d = rank % pp, (rank // pp) % tp, rank // (tp * pp)
    at = lambda d_, t_, s_: (d_ * tp + t_) * pp + s_  # noqa: E731
    if name == "dp":
        return [at(i, t, s) for i in range(dp)]
    if name == "tp":
        return [at(d, i, s) for i in range(tp)]
    if name == "pp":
        return [at(d, t, i) for i in range(pp)]
    if name == "dpp":
        return [at(i, t, j) for i in range(dp) for j in range(pp)]
    if name == "world":
        return list(range(dp * tp * pp))
    raise ValueError(f"unknown group {name!r}; pick from "
                     f"{GROUPS + ('world',)}")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """One rank's view of the mesh: the axis sizes, this rank and its
    device, and the process group's backend (None: no group).
    ``distributed`` is True when a group is up (even of one rank): the
    steps then run their collectives. ``groups`` holds the
    ``torch.distributed`` group of each name in ``GROUPS`` that holds
    this rank (absent: the world, as at tp = pp = 1). ``stats`` counts
    collective calls and bytes, in all and per group
    (``all_reduce_tp_bytes``)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    stats: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def dp_index(self) -> int:
        return self.rank // (self.tp * self.pp)

    @property
    def tp_index(self) -> int:
        return (self.rank // self.pp) % self.tp

    @property
    def pp_stage(self) -> int:
        return self.rank % self.pp

    def members(self, group: str) -> list:
        """The global ranks of this rank's ``group``."""
        return group_members(group, self.rank, self.dp, self.tp, self.pp)

    def group_size(self, group: str) -> int:
        return len(self.members(group))

    def group_index(self, group: str) -> int:
        """This rank's place in its ``group``."""
        return self.members(group).index(self.rank)

    def _runs(self, group: str) -> bool:
        """Whether a collective over ``group`` runs: with a process group,
        unless the group is this rank alone in a larger world."""
        return self.distributed and (self.group_size(group) > 1
                                     or self.world_size == 1)

    def _count(self, kind: str, t: torch.Tensor, group: str) -> None:
        n = t.numel() * t.element_size()
        for key in (kind, f"{kind}_{group}"):
            self.stats[f"{key}_calls"] += 1
            self.stats[f"{key}_bytes"] += n

    def all_reduce(self, t: torch.Tensor, group: str = "dp") -> torch.Tensor:
        """Sum ``t`` over the ranks of ``group``, in place; returns
        ``t``."""
        if self._runs(group):
            self._count("all_reduce", t, group)
            dist.all_reduce(t, group=self.groups.get(group))
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  group: str = "world") -> torch.Tensor:
        """The ``t`` of the ``src``-th rank of ``group`` on each of its
        ranks, in place; returns ``t``."""
        if self._runs(group):
            self._count("broadcast", t, group)
            dist.broadcast(t, self.members(group)[src],
                           group=self.groups.get(group))
        return t

    def combine_all(self, ts, group: str = "dp") -> list:
        """Each tensor of ``ts`` (one device) with every element taken
        from the one rank of ``group`` that wrote it (the others hold
        zeros there), bit for bit: their bytes, each tensor's on 16 bytes
        of one buffer, are summed as int32 words by one ``all_reduce``.
        New tensors."""
        if not self._runs(group):
            return list(ts)
        sizes = [t.numel() * t.element_size() for t in ts]
        offs = [sum(-(-s // 16) * 16 for s in sizes[:i])
                for i in range(len(ts) + 1)]
        words = torch.zeros(offs[-1] // 4, dtype=torch.int32,
                            device=ts[0].device)
        raw = words.view(torch.uint8)
        for t, o, s in zip(ts, offs, sizes):
            raw[o:o + s].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        self.all_reduce(words, group)
        return [raw[o:o + s].view(t.dtype).view(t.shape)
                for t, o, s in zip(ts, offs, sizes)]

    def combine(self, t: torch.Tensor, group: str = "dp") -> torch.Tensor:
        """``combine_all`` of one tensor."""
        return self.combine_all([t], group)[0]

    def gather_rows(self, t: torch.Tensor, group: str = "dp"
                    ) -> torch.Tensor:
        """Every rank's rows of ``t`` [B, ...] in ``group`` order → [n·B,
        ...] on every rank of the group (``combine`` of each rank's
        slot); over dp, the global batch's rows."""
        if not self._runs(group):
            return t
        B, i = t.shape[0], self.group_index(group)
        out = torch.zeros((self.group_size(group) * B,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        out[i * B:(i + 1) * B] = t
        return self.combine(out, group)


def make_mesh(dp: int = -1, tp: int = 1, pp: int = 1, device=None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: Optional[float] = None) -> MeshContext:
    """This rank's ``MeshContext``, starting the process group when one
    is asked for and none is up.

    The group starts when ``init_method`` is given (``rank`` and
    ``world_size`` then say who this process is) or when ``torchrun``'s
    environment is set (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``; ``env://``); otherwise there is one
    process and no group. ``device`` defaults to the card of
    ``LOCAL_RANK`` (raising without one); ``backend`` to NCCL on a CUDA
    device and gloo on the CPU (``"gloo"`` on CUDA is taken as asked:
    several ranks on one card). The axis sizes follow JAX's arithmetic
    over the world size (``mesh_shape``), so ``dp=N`` raises unless
    exactly N ranks are up. With tp or pp above 1 every rank creates the
    process group of each name in ``GROUPS`` (``dist.new_group`` over
    every group, in one order on every rank) and keeps its own."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(device if device is not None else f"cuda:{local}")
    if not (dist.is_available() and dist.is_initialized()) and (
            init_method is not None or "WORLD_SIZE" in os.environ):
        be = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if be == "nccl":
            torch.cuda.set_device(dev)
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            be, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]) if rank is None else rank,
            world_size=int(os.environ["WORLD_SIZE"]) if world_size is None
            else world_size, **kw)
    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else 1
    dp, tp, pp = mesh_shape(n, dp, tp, pp)
    if up and dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL group needs a CUDA device, "
                         f"got {dev}")
    rank = dist.get_rank() if up else 0
    groups = {}
    if up and tp * pp > 1:
        for name in GROUPS:
            seen = set()
            for r in range(n):
                ranks = tuple(group_members(name, r, dp, tp, pp))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    groups[name] = g
    return MeshContext(dp=dp, tp=tp, pp=pp, rank=rank, device=dev,
                       backend=dist.get_backend() if up else None,
                       groups=groups)


def batch_rows(B: int, dp: int, rank: int, accum: int = 1) -> np.ndarray:
    """The global batch rows rank ``rank`` runs: with ``accum``
    microbatches, its slice of each (the train step splits a batch into
    ``accum`` microbatches in order, and JAX shards each one over dp)."""
    if B % (dp * accum):
        raise ValueError(f"batch of {B} rows not divisible by dp={dp} x "
                         f"grad_accum={accum}")
    mb = B // accum
    per = mb // dp
    return np.concatenate([np.arange(i * mb + rank * per,
                                     i * mb + (rank + 1) * per)
                           for i in range(accum)])


def shard_batch(ctx: MeshContext, batch: Dict, accum: int = 1) -> Dict:
    """This rank's rows of a global host batch (a dict of numpy arrays or
    tensors; other values pass through), on ``ctx.device``: the rows of
    its dp index, so the tp and pp ranks of one dp index hold the same
    rows. Every rank builds the same global batch from the same seed."""
    rows = None
    out = {}
    for k, x in batch.items():
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            out[k] = x
            continue
        if ctx.dp > 1:
            if rows is None:
                rows = batch_rows(x.shape[0], ctx.dp, ctx.dp_index, accum)
            x = x[rows[0]:rows[-1] + 1] if accum == 1 else \
                x[torch.from_numpy(rows)]
        out[k] = x.to(ctx.device, non_blocking=True)
    return out


def replicate(ctx: MeshContext, tree: Any) -> Any:
    """``tree`` (dicts, lists, tuples and NamedTuples of tensors;
    ``torch.Generator``s; other leaves pass through) on ``ctx.device``,
    every tensor and generator state broadcast from rank 0."""
    if isinstance(tree, dict):
        return {k: replicate(ctx, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(ctx, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(ctx, v) for v in tree)
    if isinstance(tree, torch.Generator):
        state = tree.get_state()
        if ctx.distributed:
            buf = ctx.broadcast(state.to(_collective(ctx)))
            tree.set_state(buf.cpu())
        return tree
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(ctx.device)
        return ctx.broadcast(t.clone()) if ctx.distributed else t
    return tree


def _collective(ctx: MeshContext) -> torch.device:
    """Where a host-side buffer goes for a collective: the rank's card
    under NCCL, the CPU otherwise."""
    return ctx.device if ctx.backend == "nccl" else torch.device("cpu")


_ACTIVE = threading.local()


@contextlib.contextmanager
def data_parallel(ctx: Optional[MeshContext]):
    """Make ``ctx`` the active mesh for the code inside (a train step's
    forward and backward); None or a context without a process group
    leaves the one-device behaviour."""
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = ctx if ctx is not None and ctx.distributed else None
    try:
        yield
    finally:
        _ACTIVE.ctx = prev


def active() -> Optional[MeshContext]:
    """The mesh made active by ``data_parallel``, or None."""
    return getattr(_ACTIVE, "ctx", None)


@contextlib.contextmanager
def microbatch_rows(first: int):
    """Inside: ``row_offset`` is ``first``, the global row of a pipeline
    microbatch's first row (parallel/pipeline.py)."""
    prev = getattr(_ACTIVE, "row0", None)
    _ACTIVE.row0 = int(first)
    try:
        yield
    finally:
        _ACTIVE.row0 = prev


def row_offset(B: int) -> int:
    """The first global row of this rank's ``B`` rows under the active
    mesh (0 without one; a pipeline microbatch's, ``microbatch_rows``)."""
    row0 = getattr(_ACTIVE, "row0", None)
    if row0 is not None:
        return row0
    ctx = active()
    return 0 if ctx is None else ctx.dp_index * B


def tp_active() -> Optional[MeshContext]:
    """The active mesh when it runs tensor parallel (tp > 1), else
    None."""
    ctx = active()
    return ctx if ctx is not None and ctx.tp > 1 else None


class _CopyToTp(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group."""

    @staticmethod
    def forward(fctx, x, mesh):
        fctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.all_reduce(g.contiguous().clone(), "tp"), None


class _ReduceFromTp(torch.autograd.Function):
    """``x`` summed over the tp group forward; the identity backward."""

    @staticmethod
    def forward(fctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), "tp")

    @staticmethod
    def backward(fctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient all-reduced over the tp
    group of the active mesh (the input of a column-parallel product, or
    a replicated tensor whose use is cut per head). The identity without
    tensor parallelism."""
    ctx = tp_active()
    return x if ctx is None else _CopyToTp.apply(x, ctx)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the tp ranks' partial outputs summed (all_reduce over
    tp), its gradient passed through. The identity without tensor
    parallelism."""
    ctx = tp_active()
    return x if ctx is None else _ReduceFromTp.apply(x, ctx)
