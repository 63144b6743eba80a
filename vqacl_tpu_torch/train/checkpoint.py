"""Checkpoint save/load on ``vqacl_tpu``'s ``.npz`` format.

One archive holds the parameters (flattened pytree paths joined with
``::`` under ``params::``), the prototype state (``proto::<field>``), the
step (``meta::step``) and any ``extra::<name>`` arrays, so the port
serves a checkpoint the JAX package wrote and the JAX package loads one
the port wrote. ``AsyncCheckpointer`` writes in a background thread;
``load_reference_prototypes`` reads the reference run's loose prototype
banks. ``save_checkpoint_dcp``/``load_checkpoint_dcp`` keep the same tree
as a ``torch.distributed.checkpoint`` directory, the counterpart of JAX's
orbax pair.

Under data, tensor or pipeline parallelism every rank calls the savers:
with a ``layout`` (parallel/sharding.py: ``FsdpLayout``, ``TpLayout`` or
the trainer's ``StoredLayout`` of both) the sharded leaves are gathered
first (over tp, then dp), and only the main process writes, so the archive keeps
the flat keys and full shapes of a one-process run. The loaders read the
file, then broadcast rank 0's values (``mesh_ctx``) and keep this rank's
slices (``layout``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models.convert import from_jax_params, to_jax_params
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.parallel.mesh import replicate
from vqacl_tpu_torch.parallel.multihost import is_main_process

SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _build_flat(params: Any, proto: ProtoState, step: int,
                extra: Optional[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
    """The archive's arrays, all on the host (device tensors are copied
    here, on the calling thread)."""
    flat = _flatten({"params": to_jax_params(params)})
    for value, name in zip(proto, proto._fields):
        flat[f"proto{SEP}{name}"] = value.detach().cpu().numpy()
    flat[f"meta{SEP}step"] = np.asarray(step)
    for k, v in (extra or {}).items():
        flat[f"extra{SEP}{k}"] = np.asarray(v)
    return flat


def _atomic_savez(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write ``<path>.npz`` through a temp file and ``os.replace``, so a
    crash mid-write never leaves a truncated archive."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _whole(params: Any, layout) -> Any:
    """The full parameter tree (tp and FSDP slices gathered over the
    ranks)."""
    return params if layout is None else layout.gather(params)


def save_checkpoint(path: str, params: Any, proto: ProtoState,
                    step: int = 0,
                    extra: Optional[Dict[str, np.ndarray]] = None,
                    layout=None) -> None:
    params = _whole(params, layout)
    if is_main_process():
        _atomic_savez(path, _build_flat(params, proto, step, extra))


class AsyncCheckpointer:
    """Background checkpoint writer: the serialization and disk write
    overlap whatever the trainer does next (the per-task test matrix).

    ``save()`` copies every tensor to host numpy arrays on the calling
    thread, then hands them to a writer thread that makes the same atomic
    write as :func:`save_checkpoint`; the writer never touches a device
    tensor, and a later train step cannot change what it writes. One
    write is in flight at a time; ``wait()`` joins it and re-raises the
    writer's exception. ``write_s`` sums the writer threads' seconds."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.write_s = 0.0

    def save(self, path: str, params: Any, proto: ProtoState,
             step: int = 0,
             extra: Optional[Dict[str, np.ndarray]] = None,
             layout=None) -> None:
        self.wait()
        params = _whole(params, layout)
        if not is_main_process():
            return
        flat = _build_flat(params, proto, step, extra)

        def _write() -> None:
            t0 = time.perf_counter()
            try:
                _atomic_savez(path, flat)
            except BaseException as e:     # surfaced by the next wait()
                self._err = e
            self.write_s += time.perf_counter() - t0

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _placed(params, proto, mesh_ctx, layout):
    """Rank 0's loaded values on every rank, params in ``layout``."""
    if mesh_ctx is not None:
        params, proto = replicate(mesh_ctx, (params, proto))
    return (params if layout is None else layout.shard(params)), proto


def load_checkpoint(path: str, device="cpu", mesh_ctx=None, layout=None
                    ) -> Tuple[Dict[str, Any], ProtoState, int]:
    """→ (params as f32 tensors, ProtoState, step), on ``device``; with
    ``mesh_ctx``/``layout``, rank 0's values in this rank's layout."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    pre, ppre = "params" + SEP, "proto" + SEP
    params = _unflatten({k[len(pre):]: v for k, v in flat.items()
                         if k.startswith(pre)})
    fields = {k[len(ppre):]: v for k, v in flat.items()
              if k.startswith(ppre)}
    proto = ProtoState(**{name: torch.from_numpy(np.array(fields[name]))
                          .to(device) for name in ProtoState._fields})
    step = int(flat.get(f"meta{SEP}step", np.asarray(0)))
    params, proto = _placed(from_jax_params(params, device=device), proto,
                            mesh_ctx, layout)
    return params, proto, step


def load_extra(path: str) -> Dict[str, np.ndarray]:
    """The ``extra::<name>`` arrays of an archive, by name."""
    pre = "extra" + SEP
    with np.load(_npz_path(path), allow_pickle=False) as z:
        return {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}


# ---------------------------------------------------------------------------
# the directory format: torch.distributed.checkpoint (counterpart of JAX's
# orbax pair). The tree is the same, {"params", "proto" as a dict, "step"};
# the two directory formats are not interchangeable.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _one_process():
    """DCP in one process without a process group: it warns that it
    assumes a single process, which is what the port runs, and, on a
    save over an earlier one, that it overwrites, which the save means
    to do (as orbax's ``force=True``); those two warnings alone are
    silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        warnings.filterwarnings("ignore", message="Detected an existing "
                                "checkpoint in")
        yield


def _flat_tensors(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{SEP}{k}" if prefix
                                     else str(k)))
        return out
    return {prefix: tree.detach()}


def save_checkpoint_dcp(directory: str, params: Any, proto: ProtoState,
                        step: int = 0, layout=None) -> None:
    """Write {"params", "proto", "step"} as a ``torch.distributed.checkpoint``
    directory (created, or overwritten), the tree's paths joined with
    ``::`` as its keys. Tensors may lie on any device. Every rank calls
    it; the main process writes the whole tree, alone (``no_dist``)."""
    import torch.distributed.checkpoint as dcp

    params = _whole(params, layout)
    if not is_main_process():
        return
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    tree = {"params": params, "proto": dict(proto._asdict()),
            "step": torch.tensor(step, dtype=torch.int64)}
    with _one_process():
        dcp.save(_flat_tensors(tree), no_dist=True,
                 storage_writer=dcp.FileSystemWriter(directory,
                                                     overwrite=True))


def load_checkpoint_dcp(directory: str, mesh_ctx=None, layout=None
                        ) -> Tuple[Dict[str, Any], ProtoState, int]:
    """→ (params, ProtoState, step) from a ``save_checkpoint_dcp``
    directory, on the CPU in the saved dtypes (with ``mesh_ctx``, rank 0's
    values on its device; with ``layout``, this rank's slices). No
    template is needed: the targets are built from the directory's own
    metadata."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    directory = os.path.abspath(directory)
    meta = FileSystemReader(directory).read_metadata().state_dict_metadata
    targets = {}
    for key, m in meta.items():
        if not isinstance(m, TensorStorageMetadata):
            raise ValueError(f"load_checkpoint_dcp: {key!r} in {directory} "
                             f"is not a tensor")
        targets[key] = torch.empty(m.size, dtype=m.properties.dtype)
    with _one_process():
        dcp.load(targets, checkpoint_id=directory, no_dist=True)
    tree = _unflatten(targets)
    proto = ProtoState(**{k: tree["proto"][k] for k in ProtoState._fields})
    params, proto = _placed(tree["params"], proto, mesh_ctx, layout)
    return params, proto, int(tree["step"])


def load_reference_prototypes(proto: ProtoState, q_path: str,
                              v_path: str) -> ProtoState:
    """Reference-trained prototype banks (``Q_prototype.pt`` /
    ``V_prototype.pt``, plain ``torch.save``-d tensors, vqacl.py:420-426)
    in place of ``proto``'s, on its device and dtype: the eval-only load
    of vqacl.py:540-542. The EMA bookkeeping fields are untouched (the
    reference does not save them; they matter only in training)."""
    def bank(path, like, name):
        t = torch.load(path, map_location="cpu").detach()
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name} bank shape {tuple(t.shape)} != "
                             f"expected {tuple(like.shape)} ({path})")
        return t.to(device=like.device, dtype=like.dtype)

    return proto._replace(q_proto=bank(q_path, proto.q_proto, "Q_prototype"),
                          v_proto=bank(v_path, proto.v_proto, "V_prototype"))
