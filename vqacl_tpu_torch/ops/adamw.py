"""The train step's optimizer as one multi-tensor kernel pair.

What ``train/step.py::_apply_update`` runs after the gradients are in the
state's layout: optax's global-norm clip, the AdamW direction
(``adam_impl`` "hf" or "torch", moments stored in their dtype with f32
arithmetic), the masked decoupled decay, the ``freeze`` mask, the warmup
schedule's lr and ``p − lr·u`` — the chain ``train/optim.py`` writes as
plain functions over the parameter tree.

``adamw_step`` is the wrapper. On CPU tensors it takes the plain version
``adamw_reference`` (those functions, leaf by leaf: ~25 eager launches
per leaf on a card). On CUDA tensors it launches the kernels of
``csrc/fused_adamw.cu`` through ``fused_adamw``: one pass for ‖g‖ (none
when the caller gives it: the FSDP and tp layouts reduce it over their
ranks) and one apply pass, which reads the step count, the Adam count
and the schedule on the card, so nothing waits for the host. Given the
same ‖g‖ both give the same bits on the card; the kernel's ‖g‖ sums in
f64 and may differ from ``global_norm``'s f32 sums in the last bits.
Which kernel instance runs follows from what the tensors are: the
moments' dtype (f32 or bf16) and ``adam_impl``. CUDA tensors of another
dtype raise ``ValueError``.

The chunk plan (``adamw_plan``): every leaf cut into chunks of
``CHUNK`` elements in sorted-leaf order, each with its leaf's decay and
trainable flags (``decay_mask``, ``freeze_mask``) and its place in the
flat output buffers, where the leaves follow each other in that order.
It is computed here, once per tuple of the leaves' sizes and flags, and
passed to the kernel, so the plan the CPU tests check is the one the
card runs. A step then only gathers the leaves' addresses, which travel
in the kernel's parameters: a tree of at most ``MAX_LEAVES`` leaves
(t5-base's has 264), larger ones are refused.

A gradient may be a column slice of a wider matrix (the merged q/k/v
projections' gradients): the kernel reads its rows in place
(``grad_rows``), so the step copies no gradient.

The new parameters and moments are views of fresh flat buffers (one
f32 buffer; the bf16 moments in a second), never the old state's
tensors, rebuilt into trees by ``tree_unflatten``; a leaf whose place
there is not 16-byte aligned (after a leaf of a size that is not a
multiple of 4) takes the kernel's scalar loop. ``out`` names the two
buffers instead (``train/graph.py``: the next state's place, which a
replayed step must write); they may not overlap the inputs. Counters of
``utils/profiling.py``: ``optim.fused_leaves`` and
``optim.eager_leaves``, the leaves each route updated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.train.optim import (AdamState, decay_mask,
                                         dynamic_lr, freeze_mask,
                                         global_norm, make_transform,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from vqacl_tpu_torch.utils.profiling import count

CHUNK = 16384          # elements of one chunk of the plan
MAX_LEAVES = 512       # leaves of a tree (csrc/fused_adamw.cu kMaxLeaves)
NORM_BLOCKS = 528      # partial sums of the norm pass (kNormBlocks)
DECAY, TRAINABLE = 1, 2          # flag bits of a chunk
_MOMENT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPL_CODE = {"hf": 0, "torch": 1}
_SCHEDULE_CODE = {"constant_warmup": 0, "linear_warmup": 1}
_INT_MAX = 2 ** 31 - 1

Result = Tuple[dict, AdamState, torch.Tensor, torch.Tensor]
# (f32 [T], moments' dtype [2·T]): where the new parameters and moments go
Out = Optional[Tuple[torch.Tensor, torch.Tensor]]


def adamw_reference(tcfg, grads, opt_state: AdamState, params, step,
                    sched, g_norm: Optional[torch.Tensor] = None,
                    out: Out = None) -> Result:
    """Plain version: ``make_transform(tcfg).update`` (clip with ‖g‖,
    ``global_norm`` unless given), ``dynamic_lr`` at ``step``, then
    ``p − lr·u`` → (params, opt_state, lr, ‖g‖); with ``out``, the new
    parameters and moments copied into its buffers (``_views``)."""
    count("optim.eager_leaves", len(tree_leaves(params)))
    if g_norm is None:
        g_norm = global_norm(grads)
    updates, opt_state = make_transform(tcfg).update(grads, opt_state,
                                                     params, g_norm)
    lr = dynamic_lr(step.float(), sched, tcfg.lr, tcfg.schedule)
    params = tree_map(lambda p, u: p - lr * u, params, updates)
    if out is not None:
        new = (params, opt_state.mu, opt_state.nu)
        params, mu, nu = _views(params, out, opt_state.mu, opt_state.nu)
        for tree, got in zip((params, mu, nu), new):
            for a, b in zip(tree_leaves(tree), tree_leaves(got)):
                a.copy_(b)
        opt_state = opt_state._replace(mu=mu, nu=nu)
    return params, opt_state, lr, g_norm


def _views(params, out, mu, nu) -> Tuple[dict, dict, dict]:
    """The trees of parameters and moments as views of ``out`` = (f32
    [T], moments [2·T]): the leaves in sorted-leaf order, back to back;
    the first moments in the first half. ValueError for buffers of
    another size, dtype or device, or not contiguous."""
    p_l, m_l = tree_leaves(params), tree_leaves(mu)
    T = sum(p.numel() for p in p_l)
    P, M = out
    if not (P.dtype == torch.float32 and M.dtype == m_l[0].dtype
            and P.numel() == T and M.numel() == 2 * T
            and P.is_contiguous() and M.is_contiguous()
            and P.device == M.device == p_l[0].device):
        raise ValueError(
            f"adamw out: f32 [{T}] and {m_l[0].dtype} [{2 * T}] on "
            f"{p_l[0].device}, got {P.dtype} {list(P.shape)} and {M.dtype} "
            f"{list(M.shape)} on {P.device}")
    from torch._utils import _unflatten_dense_tensors as views
    return (tree_unflatten(params, views(P, p_l)),
            tree_unflatten(mu, views(M[:T], p_l)),
            tree_unflatten(nu, views(M[T:], p_l)))


@dataclasses.dataclass(frozen=True)
class AdamwPlan:
    """Leaf i has ``numels[i]`` elements at ``offsets[i]`` of the flat
    outputs (``total`` elements, the leaves in order) and the flag bits
    ``flags[i]``; ``chunks`` are (leaf, start, length) in order."""
    numels: Tuple[int, ...]
    flags: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    chunks: Tuple[Tuple[int, int, int], ...]

    def table(self) -> np.ndarray:
        """The kernel's plan: int64 [chunks, 3] = (leaf | flags << 32,
        start | length << 32, output offset)."""
        t = np.zeros((len(self.chunks), 3), dtype=np.int64)
        for c, (i, start, n) in enumerate(self.chunks):
            t[c] = (i | self.flags[i] << 32, start | n << 32,
                    self.offsets[i] + start)
        return t


@functools.lru_cache(maxsize=None)
def adamw_plan(numels: Tuple[int, ...], flags: Tuple[int, ...]
               ) -> AdamwPlan:
    """The plan for leaves of ``numels`` elements with ``flags`` (bits
    ``DECAY``, ``TRAINABLE``), in sorted-leaf order; computed once per
    pair of tuples (the leaves' sizes and masks never change between
    steps)."""
    if len(numels) != len(flags) or not numels:
        raise ValueError("adamw_plan: one flag per leaf, at least one leaf")
    if len(numels) > MAX_LEAVES:
        raise ValueError(f"adamw_plan: {len(numels)} leaves; the kernel "
                         f"takes at most {MAX_LEAVES}")
    if max(numels) > _INT_MAX:
        raise ValueError(f"adamw_plan: a leaf of {max(numels)} elements; "
                         f"each must fit an int32")
    offsets, chunks, off = [], [], 0
    for i, n in enumerate(numels):
        offsets.append(off)
        off += n
        chunks += [(i, s, min(CHUNK, n - s)) for s in range(0, n, CHUNK)]
    return AdamwPlan(tuple(numels), tuple(flags), tuple(offsets), off,
                     tuple(chunks))


def leaf_flags(params, freeze: bool) -> Tuple[int, ...]:
    """Each leaf's flag bits in sorted-leaf order: ``DECAY`` where
    ``decay_mask``, ``TRAINABLE`` where ``freeze_mask`` (every leaf
    without ``freeze``)."""
    decay = tree_leaves(decay_mask(params))
    if not freeze:
        return tuple(DECAY * bool(d) + TRAINABLE for d in decay)
    return tuple(DECAY * bool(d) + TRAINABLE * bool(t) for d, t in
                 zip(decay, tree_leaves(freeze_mask(params))))


def grad_rows(g: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """How the kernel reads a gradient leaf → (tensor, row length, row
    stride) in elements: (``g``, 0, 0) when it is contiguous; the rows
    of a 2-D leaf whose columns are contiguous and whose rows lie further
    apart (a column slice of a merged q/k/v projection's gradient,
    ``models/t5.py::_merged_weight``), read in place; else a contiguous
    copy."""
    if g.is_contiguous():
        return g, 0, 0
    if g.dim() == 2 and g.stride(1) == 1 \
            and g.shape[1] <= g.stride(0) <= _INT_MAX:
        return g, g.shape[1], g.stride(0)
    return g.contiguous(), 0, 0


# per (plan, device, stream): the plan's table on the card, with the
# pinned host copy it came from
_tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _table(plan: AdamwPlan, dev: torch.device, stream: int) -> torch.Tensor:
    """The plan on the card, copied once from pinned memory (no wait)."""
    key = (id(plan), dev.index, stream)   # plans live in adamw_plan's cache
    got = _tables.get(key)
    if got is None:
        host = torch.from_numpy(plan.table()).pin_memory()
        got = _tables[key] = (host.to(dev, non_blocking=True), host)
    return got[0]


def _inputs(tcfg, grads, opt_state: AdamState, params, step, sched,
            g_norm) -> list:
    """What the kernel reads, checked: → [grads, params, mu, nu] leaves
    in sorted-leaf order (the trees paired leaf by leaf in that order).
    Everything but the device's type: one device, f32 grads and
    parameters, both moments f32 or both bf16, the same number of leaves
    and shapes, int32 ``step`` and count, f32 ``sched`` and ``g_norm``, a
    known ``adam_impl`` and schedule; else ValueError."""
    if tcfg.adam_impl not in _IMPL_CODE:
        raise ValueError(f"adam_impl {tcfg.adam_impl!r}")
    if tcfg.schedule not in _SCHEDULE_CODE:
        raise ValueError(tcfg.schedule)
    g_l, p_l, m_l, v_l = leaves = [tree_leaves(t) for t in (
        grads, params, opt_state.mu, opt_state.nu)]
    if not len(g_l) == len(p_l) == len(m_l) == len(v_l):
        raise ValueError(f"fused_adamw: {len(p_l)} parameters, {len(g_l)} "
                         f"grads, {len(m_l)}/{len(v_l)} moments")
    mdt = m_l[0].dtype
    if mdt not in _MOMENT_CODE:
        raise ValueError(f"fused_adamw: moments of {mdt}; the kernel takes "
                         f"{sorted(map(str, _MOMENT_CODE))}")
    di = p_l[0].get_device()
    f32 = torch.float32
    for i, (g, p, m, v) in enumerate(zip(g_l, p_l, m_l, v_l)):
        if g.dtype != f32 or p.dtype != f32 or m.dtype != mdt \
                or v.dtype != mdt:
            raise ValueError(
                f"fused_adamw: leaf {i}: grad {g.dtype}, param {p.dtype}, "
                f"moments {m.dtype}/{v.dtype}; the kernel takes f32 grads "
                f"and params and moments of one dtype")
        if not (g.get_device() == p.get_device() == m.get_device()
                == v.get_device() == di):
            raise ValueError(f"fused_adamw: leaf {i}: not all on "
                             f"{p_l[0].device}")
        if not g.shape == p.shape == m.shape == v.shape:
            raise ValueError(f"fused_adamw: leaf {i}: shapes "
                             f"{tuple(g.shape)}, {tuple(p.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)} differ")
    scalars = (("step", step, torch.int32), ("count", opt_state.count,
                                            torch.int32),
               ("sched", sched, torch.float32)) + (
        (("g_norm", g_norm, torch.float32),) if g_norm is not None else ())
    for name, t, want in scalars:
        if t.dtype != want or t.get_device() != di:
            raise ValueError(f"fused_adamw: {name} is {t.dtype} on "
                             f"{t.device}, not {want} on {p_l[0].device}")
    if sched.numel() < 2:
        raise ValueError("fused_adamw: sched must hold [warmup, t_total]")
    return leaves


def fused_adamw(tcfg, grads, opt_state: AdamState, params, step, sched,
                g_norm: Optional[torch.Tensor] = None,
                out: Out = None) -> Result:
    """The kernels of ``csrc/fused_adamw.cu`` on CUDA tensors: f32 grads
    and parameters, moments both f32 or both bf16, ``step`` and
    ``opt_state.count`` int32, ``sched`` f32 [warmup, t_total]; ``g_norm``
    (f32, 0-dim) skips the norm pass; ``out`` the buffers the new
    parameters and moments are written to → (params, opt_state, lr, ‖g‖)
    as ``adamw_reference`` returns them. Raises ValueError for anything
    else (``_inputs``, ``adamw_plan``, ``_views``)."""
    dev = opt_state.count.device
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: CUDA tensors only, got {dev}")
    leaves = _inputs(tcfg, grads, opt_state, params, step, sched, g_norm)
    p_l, mdt = leaves[1], leaves[2][0].dtype
    plan = adamw_plan(tuple(p.numel() for p in p_l),
                      leaf_flags(params, tcfg.freeze))
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = _table(plan, dev, stream)
    # kept until the launch: a copy made here must outlive the enqueue
    rows = [grad_rows(g) for g in leaves[0]]
    leaves = [[g for g, _, _ in rows]] + [[t.contiguous() for t in ls]
                                         for ls in leaves[1:]]
    ptrs = np.array([t.data_ptr() for ls in leaves for t in ls],
                    dtype=np.uint64)
    gshape = np.array([[c for _, c, _ in rows], [s for _, _, s in rows]],
                      dtype=np.int32)
    T = plan.total
    if out is not None:
        _views(params, out, opt_state.mu, opt_state.nu)   # checks only
        flat, mom = out
    elif mdt == torch.float32:
        flat = torch.empty(3 * T, dtype=torch.float32, device=dev)
        mom = flat[T:]
    else:
        flat = torch.empty(T, dtype=torch.float32, device=dev)
        mom = torch.empty(2 * T, dtype=mdt, device=dev)
    scal = torch.empty(2, dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    partials = None if g_norm is not None else torch.empty(
        NORM_BLOCKS, dtype=torch.float64, device=dev)
    b1, b2 = float(tcfg.adam_beta1), float(tcfg.adam_beta2)
    from vqacl_tpu_torch.ops import _build

    lib = _build.load("fused_adamw")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.fused_adamw(
        ptrs.ctypes.data, gshape.ctypes.data, len(p_l), table.data_ptr(),
        len(plan.chunks),
        ptr(partials), ptr(g_norm), opt_state.count.data_ptr(),
        step.data_ptr(), sched.data_ptr(), flat.data_ptr(), mom.data_ptr(),
        mom.data_ptr() + T * mom.element_size(), scal.data_ptr(),
        cnt.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, float(tcfg.adam_eps),
        float(tcfg.weight_decay), float(tcfg.lr),
        float(tcfg.clip_grad_norm), _SCHEDULE_CODE[tcfg.schedule],
        _IMPL_CODE[tcfg.adam_impl], _MOMENT_CODE[mdt], stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw launch failed: "
                           f"{lib.fused_adamw_error_string(err).decode()}")
    fused_adamw.launches += 1 + (g_norm is None)
    count("optim.fused_leaves", len(p_l))

    from torch._utils import _unflatten_dense_tensors as views
    state = AdamState(count=cnt,
                      mu=tree_unflatten(params, views(mom[:T], p_l)),
                      nu=tree_unflatten(params, views(mom[T:2 * T], p_l)))
    return tree_unflatten(params, views(flat[:T], p_l)), state, scal[0], \
        scal[1] if g_norm is None else g_norm


fused_adamw.launches = 0


def adamw_step(tcfg, grads, opt_state: AdamState, params, step, sched,
               g_norm: Optional[torch.Tensor] = None,
               out: Out = None) -> Result:
    """One optimizer update → (params, opt_state, lr, ‖g‖): the kernels on
    CUDA tensors (``fused_adamw``), the plain version on CPU tensors
    (the state's Adam count tells which); ``out`` as ``fused_adamw``
    takes it."""
    kind = opt_state.count.device.type
    if kind == "cuda":
        return fused_adamw(tcfg, grads, opt_state, params, step, sched,
                           g_norm, out)
    if kind == "cpu":
        return adamw_reference(tcfg, grads, opt_state, params, step, sched,
                               g_norm, out)
    raise ValueError(f"adamw_step: unsupported device {kind}")
