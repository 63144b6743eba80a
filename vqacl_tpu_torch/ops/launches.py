"""The kernel wrappers that count their launches on the host, and one way
to read, add back and reset those counts.

Each wrapper keeps its counts as attributes whose names end in
``launches``: an int (``launches``, ``strided_launches``,
``offset_launches``, ``head_offset_launches``) or a dict of ints by
route (``route_launches``). A snapshot (``read``) maps (wrapper,
attribute, route or None) to a count; the difference of two snapshots
is a delta that ``add`` puts back (a CUDA graph's capture launches
nothing, its replay everything captured) and that ``chip_smoke.py``
sums into its kernels line.

The wrappers are looked up at each call, so a wrapper replaced on its
module (as the CPU tests do) is the one counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

Key = Tuple[object, str, object]


def wrappers() -> tuple:
    """The kernel wrappers that count their launches: K1, K1′, K2, the
    fused AdamW, K5, the grouped expert GEMMs, N1 and the head loss's H1
    and H2."""
    from vqacl_tpu_torch.ops import adamw, dw, head_loss, moe, nms
    from vqacl_tpu_torch.ops import fused_attention as fa

    return (fa.fused_attention, fa.fused_attention_fwd_train,
            fa.fused_attention_bwd, adamw.fused_adamw, dw.dw_splitk,
            moe.grouped_swiglu, nms.greedy_nms, head_loss.head_lse,
            head_loss.head_dlogits)


def read() -> Dict[Key, int]:
    """Every launch counter of the wrappers: (wrapper, attribute, route
    or None) → count."""
    out = {}
    for fn in wrappers():
        for attr, v in vars(fn).items():
            if not attr.endswith("launches"):
                continue
            if isinstance(v, dict):
                out.update({(fn, attr, k): n for k, n in v.items()})
            else:
                out[(fn, attr, None)] = v
    return out


def since(before: Dict[Key, int]) -> Dict[Key, int]:
    """The counts that changed since the snapshot ``before``, as a
    delta."""
    return {k: n - before.get(k, 0) for k, n in read().items()
            if n != before.get(k, 0)}


def add(delta: Dict[Key, int], sign: int = 1) -> None:
    """``sign`` × ``delta`` added to the wrappers' counters."""
    for (fn, attr, k), n in delta.items():
        if k is None:
            setattr(fn, attr, getattr(fn, attr) + sign * n)
        else:
            getattr(fn, attr)[k] += sign * n


def reset() -> None:
    """Every counter of every wrapper to zero."""
    add(read(), -1)
