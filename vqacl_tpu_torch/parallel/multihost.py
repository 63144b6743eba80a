"""Multi-process utilities (counterpart of
``vqacl_tpu/parallel/multihost.py``).

The reference's cross-process machinery (Gloo pickled-object
``all_gather`` of prediction dicts, ``dist.barrier()`` at task
boundaries; dist_utils.py:84-221, vqacl.py:310-613) over
``torch.distributed``. With no process group initialized there is one
process, and every function here is the identity (world size 1, as
JAX's single-process case), so callers use them unconditionally.

Every collective goes through ``all_reduce`` or ``broadcast`` only (the
two that gloo takes on CUDA tensors as well as CPU ones): a barrier is
an ``all_reduce`` of one element, and ``all_gather_object`` an
``all_reduce`` of a zeroed buffer in which each process writes its own
slot. Collective buffers lie on the CPU under gloo and on the process's
current CUDA device under NCCL.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    return dist.get_rank() if _group_up() else 0


def is_main_process() -> bool:
    return process_index() == 0


def collective_device() -> torch.device:
    """Where this module's collective buffers live: the current CUDA
    device under NCCL (which takes nothing else), the CPU otherwise."""
    if _group_up() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """``dist.barrier()`` at task boundaries: an ``all_reduce`` of one
    element that every process must reach (``name`` labels the call
    site, as JAX's ``sync_global_devices`` takes one)."""
    if process_count() == 1:
        return
    dist.all_reduce(torch.zeros(1, dtype=torch.int32,
                                device=collective_device()))


def all_gather_object(obj: Any) -> List[Any]:
    """Gather a picklable object from every process, in rank order
    (dist_utils.all_gather, used for quesid2ans at vqacl.py:613). The
    pickles travel as bytes through a CPU tensor: their sizes, then the
    bytes padded to the largest, each in its own slot of a zeroed
    buffer summed by ``all_reduce``."""
    n = process_count()
    if n == 1:
        return [obj]
    dev = collective_device()
    rank = process_index()
    payload = torch.from_numpy(
        np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy())
    sizes = torch.zeros(n, dtype=torch.int64, device=dev)
    sizes[rank] = payload.numel()
    dist.all_reduce(sizes)
    sizes = sizes.cpu().tolist()
    slots = torch.zeros((n, max(sizes)), dtype=torch.uint8, device=dev)
    slots[rank, :payload.numel()] = payload.to(dev)
    dist.all_reduce(slots)
    slots = slots.cpu().numpy()
    return [pickle.loads(slots[i, :sizes[i]].tobytes()) for i in range(n)]


def merge_quesid2ans(quesid2ans: Dict) -> Dict:
    """Union the per-process prediction dicts (vqacl.py:613-618)."""
    merged: Dict = {}
    for part in all_gather_object(quesid2ans):
        merged.update(part)
    return merged
