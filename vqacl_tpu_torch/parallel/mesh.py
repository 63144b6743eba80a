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
  ``tp``, ``pp``  tensor and pipeline parallelism: not ported yet
           (``make_mesh`` raises for either above 1).

Every collective of the port goes through ``all_reduce`` and
``broadcast`` only: a gather is an ``all_reduce`` of a zeroed buffer in
which each rank writes its own slot (``combine``: summed as int32 words,
so the result is each slot's bytes exactly). Those two are what gloo
takes on CUDA tensors, so every path runs on NCCL, on gloo on the CPU
and on gloo with several ranks on one card.

``data_parallel(ctx)`` makes a context the active one for the code that
runs inside it (a train step): dropout then draws its masks at the
global batch's shape and keeps this rank's rows, the fused attention
kernels take this rank's Philox row offset (``bh0``), and the prototype
update sums its class statistics over the ranks (models/t5.py,
models/prototype.py). Outside it the models run as on one device.
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


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """One rank's view of the mesh: the axis sizes, this rank and its
    device, and the process group's backend (the collectives run on the
    default group; None: no group). ``distributed`` is True when a group
    is up (even of one rank): the steps then run their collectives.
    ``stats`` counts collective calls and bytes."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    stats: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.pp

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.stats[f"{kind}_calls"] += 1
        self.stats[f"{kind}_bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.distributed:
            self._count("all_reduce", t)
            dist.all_reduce(t)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        if self.distributed:
            self._count("broadcast", t)
            dist.broadcast(t, src)
        return t

    def combine_all(self, ts) -> list:
        """Each tensor of ``ts`` (one device) with every element taken
        from the one rank that wrote it (the others hold zeros there), bit
        for bit: their bytes, each tensor's on 16 bytes of one buffer, are
        summed as int32 words by one ``all_reduce``. New tensors."""
        if not self.distributed:
            return list(ts)
        sizes = [t.numel() * t.element_size() for t in ts]
        offs = [sum(-(-s // 16) * 16 for s in sizes[:i])
                for i in range(len(ts) + 1)]
        words = torch.zeros(offs[-1] // 4, dtype=torch.int32,
                            device=ts[0].device)
        raw = words.view(torch.uint8)
        for t, o, s in zip(ts, offs, sizes):
            raw[o:o + s].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        self.all_reduce(words)
        return [raw[o:o + s].view(t.dtype).view(t.shape)
                for t, o, s in zip(ts, offs, sizes)]

    def combine(self, t: torch.Tensor) -> torch.Tensor:
        """``combine_all`` of one tensor."""
        return self.combine_all([t])[0]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` [B, ...] in rank order → [dp·B, ...]
        on every rank (``combine`` of each rank's slot)."""
        if not self.distributed:
            return t
        B = t.shape[0]
        out = torch.zeros((self.dp * B,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        out[self.rank * B:(self.rank + 1) * B] = t
        return self.combine(out)


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
    exactly N ranks are up; tp and pp above 1 raise (not ported yet)."""
    if tp > 1 or pp > 1:
        raise ValueError(f"make_mesh: tp={tp}, pp={pp}: tensor and pipeline "
                         f"parallelism are not ported yet")
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
    return MeshContext(dp=dp, tp=tp, pp=pp,
                       rank=dist.get_rank() if up else 0, device=dev,
                       backend=dist.get_backend() if up else None)


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
    tensors; other values pass through), on ``ctx.device``. Every rank
    builds the same global batch from the same seed."""
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
                rows = batch_rows(x.shape[0], ctx.dp, ctx.rank, accum)
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


def row_offset(B: int) -> int:
    """The first global row of this rank's ``B`` rows under the active
    mesh (0 without one)."""
    ctx = active()
    return 0 if ctx is None else ctx.rank * B
