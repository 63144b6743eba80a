"""The weight gradient xᵀ·g of a linear layer, as one kernel (K5).

Counterpart of ``pallas_dw``/``dw_kernel`` in ``scripts/mm_bench.py``,
the probe's split-K weight gradient: x [K,D] (the layer's input rows)
and g [K,F] (the gradient of its output), bf16 or f32, → out [D,F] f32,
the sum over K taken in f32 (the TPU kernel adds its K chunks in order
into a VMEM-resident tile). At the probe's shape (K = 4480, D = 768,
F = 3072) it is bound by its 21.1 GFLOP on the bf16 tensor cores, not by
its 43.8 MB. The CUDA kernel is ``csrc/dw_splitk.cu``; the note at its
top says how each route is built.

``dw_route`` picks one of three routes before anything is built:

- ``"wgmma"``: bf16 where TMA can describe both operands (D and F
  multiples of 8, 16-byte-aligned bases). One block per SM, two to a
  cluster, runs wgmma on TMA-fed shared memory over a stream-K plan;
- ``"mma"``: the other bf16 shapes, one 128 × 128 tile per block with
  ``mma.sync``;
- ``"f32"``: scalar f32 FMAs, one 128 × 128 tile per block.

The stream-K plan (``dw_plan``): the tiles (256 × 256, 128 rows to each
block of a cluster) × 64-row k-blocks iterations are cut
into one contiguous range per cluster, the ranges within one iteration
of each other. A cluster whose range starts inside a tile writes that
piece's partial sums to a workspace; the cluster holding the tile's
first k-block adds them to its own in the order of their k ranges. The
order is fixed by the plan and no float atomics are used, so a launch
gives the same bits every time on one card. The plan is computed here
and passed to the kernel, so the function the CPU tests check is the
one the card runs.

``dw_splitk`` is the wrapper: it takes the plain version
``dw_splitk_reference`` for CPU tensors, and on CUDA tensors launches
the kernel of its route or raises, counting each launch in
``dw_splitk.launches`` and per route in ``dw_splitk.route_launches``.
The head loss's backward (``models/vlt5.py``) runs its two gradient
products on it; ``vqacl_tpu_torch.mm_bench`` times it beside the
library's matrix products.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "mma", "f32")
CLUSTER = 2                  # blocks per cluster, one unit of the plan
BLOCK_D = 128                # d rows of a block (two warpgroups x 64)
TILE_D = CLUSTER * BLOCK_D   # d rows of a unit's tile
K_BLOCK = 64                 # k rows of one iteration (one TMA box deep)
TILE_N = 256                 # f columns of a tile (chosen on the card)
_INT_MAX = 2 ** 31 - 1


def dw_splitk_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [K,D], g [K,F] → xᵀ·g [D,F] f32."""
    return x.float().t() @ g.float()


def dw_route(K: int, D: int, F: int, dtype: torch.dtype,
             x: torch.Tensor = None, g: torch.Tensor = None) -> str:
    """The route that takes x [K,D]ᵀ·g [K,F]: "wgmma", "mma" or "f32"
    (see the module's docstring); x and g, when given, for their base
    alignment. Raises ValueError for what no route takes. Pure Python:
    nothing is built or launched."""
    if min(K, D, F) < 1:
        raise ValueError(f"dw_splitk: empty operand K={K} D={D} F={F}")
    if max(K, D, F) > _INT_MAX:
        raise ValueError(f"dw_splitk: K={K} D={D} F={F}: each must fit an "
                         f"int32")
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"dw_splitk: dtype {dtype} not supported (float32 "
                         f"or bfloat16)")
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, g))
    if D % 8 == 0 and F % 8 == 0 and aligned:
        if _iterations(K, D, F) > _INT_MAX:
            raise ValueError(f"dw_splitk: K={K} D={D} F={F} has more "
                             f"iterations than an int32 counts")
        return "wgmma"
    return "mma"


def _iterations(K: int, D: int, F: int) -> int:
    return -(-D // TILE_D) * -(-F // TILE_N) * -(-K // K_BLOCK)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The stream-K plan of the wgmma route. A unit is one cluster of
    ``CLUSTER`` blocks, each block 128 of its tile's 256 d rows. Iteration
    i is tile i // k_blocks (256-row d tile tile // tiles_f, f tile
    tile % tiles_f) at k-block i % k_blocks; unit u runs starts[u] ..
    starts[u+1] − 1."""
    K: int
    D: int
    F: int
    k_blocks: int            # 64-row k-blocks per tile
    tiles_f: int             # f tiles per d tile
    tiles: int
    starts: Tuple[int, ...]  # first iteration of each unit, then the total

    @property
    def units(self) -> int:
        return len(self.starts) - 1

    @property
    def blocks(self) -> int:
        return CLUSTER * self.units

    def pieces(self) -> List[Tuple[int, int, int, int]]:
        """(unit, tile, first k-block, end k-block) of every piece, in
        the order each unit runs them, as the kernel cuts its range."""
        out = []
        for b in range(self.units):
            it, end = self.starts[b], self.starts[b + 1]
            while it < end:
                tile = it // self.k_blocks
                stop = min(end, (tile + 1) * self.k_blocks)
                out.append((b, tile, it - tile * self.k_blocks,
                            stop - tile * self.k_blocks))
                it = stop
        return out

    def splits(self) -> Dict[int, List[int]]:
        """{tile: its units in the order of their k ranges} for each tile
        that more than one unit covers. The first unit sums: it holds the
        tile's first k-block and adds the others' partials in this order
        (each block those of the blocks of its rank), as the kernel
        does."""
        cover: Dict[int, List[int]] = {}
        for b, tile, _, _ in self.pieces():
            cover.setdefault(tile, []).append(b)
        return {t: bs for t, bs in cover.items() if len(bs) > 1}


@functools.lru_cache(maxsize=64)
def dw_plan(K: int, D: int, F: int, n_sm: int) -> DwPlan:
    """The wgmma route's plan for x [K,D]ᵀ·g [K,F] with tiles of
    256 × 256 on ``n_sm`` SMs (one block each): min(n_sm // 2,
    iterations) units of two blocks, unit u from iteration
    ⌊u·total / units⌋, so the ranges differ by at most one."""
    if n_sm < CLUSTER:
        raise ValueError(f"dw_plan: n_sm {n_sm} < {CLUSTER}")
    k_blocks = -(-K // K_BLOCK)
    tiles_f = -(-F // TILE_N)
    tiles = -(-D // TILE_D) * tiles_f
    total = tiles * k_blocks
    units = min(n_sm // CLUSTER, total)
    return DwPlan(K, D, F, k_blocks, tiles_f, tiles,
                  tuple(u * total // units for u in range(units + 1)))


def _validate(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 2 or g.dim() != 2:
        raise ValueError(f"dw_splitk: x and g must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"dw_splitk: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in K")
    if min(x.shape[0], x.shape[1], g.shape[1]) < 1:
        raise ValueError(f"dw_splitk: empty operand {tuple(x.shape)} x "
                         f"{tuple(g.shape)}")
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise ValueError(f"dw_splitk: x and g must share one dtype of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {x.dtype} "
                         f"and {g.dtype}")
    if x.device != g.device:
        raise ValueError("dw_splitk: x and g on different devices")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("dw_splitk: x and g must be contiguous")


# per device: the SMs the wgmma route can hold at once; per (device,
# plan): the plan on the card; per (device, stream, blocks): the
# workspace, its flags zeroed once
_sms: Dict[int, int] = {}
_plans: Dict[Tuple[int, DwPlan], torch.Tensor] = {}
_workspaces: Dict[Tuple[int, int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, plan: DwPlan
               ) -> torch.Tensor:
    """blocks × 128 × 256 f32 partials, then blocks int32 flags."""
    key = (device.index, stream, plan.blocks)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.zeros(plan.blocks * (BLOCK_D * TILE_N + 1),
                         dtype=torch.int32, device=device)
        _workspaces[key] = ws
    return ws


def _resident_blocks(lib, device: torch.device) -> int:
    """The SM count, or fewer: as many blocks of the wgmma route as the
    card holds at once, in whole clusters."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dw_splitk_wgmma_blocks(ctypes.byref(n))
    if err != 0 or n.value < CLUSTER:
        raise RuntimeError(f"dw_splitk: the wgmma route fits {n.value} "
                           f"blocks on {device}: "
                           f"{lib.dw_splitk_error_string(err).decode()}")
    return min(n.value, torch.cuda.get_device_properties(
        device).multi_processor_count)


def dw_splitk(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [K,D], g [K,F] (contiguous, one dtype, f32 or bf16) → xᵀ·g
    [D,F] f32: the CUDA kernel of ``dw_route``'s route on CUDA tensors,
    the plain version on CPU tensors."""
    _validate(x, g)
    if x.device.type == "cpu":
        return dw_splitk_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"dw_splitk: unsupported device {x.device}")
    K, D = x.shape
    F = g.shape[1]
    route = dw_route(K, D, F, x.dtype, x, g)
    from vqacl_tpu_torch.ops import _build

    lib = _build.load("dw_splitk")
    dev = x.device
    out = torch.empty((D, F), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan_ptr = ws_ptr = None
    n_blocks = 0
    if route == "wgmma":
        sms = _sms.get(dev.index)
        if sms is None:
            sms = _sms[dev.index] = _resident_blocks(lib, dev)
        plan = dw_plan(K, D, F, sms)
        starts = _plans.get((dev.index, plan))
        if starts is None:
            starts = _plans[(dev.index, plan)] = torch.tensor(
                plan.starts, dtype=torch.int32, device=dev)
        plan_ptr = starts.data_ptr()
        ws_ptr = _workspace(dev, stream, plan).data_ptr()
        n_blocks = plan.blocks
    err = lib.dw_splitk(x.data_ptr(), g.data_ptr(), out.data_ptr(), K, D, F,
                        _DTYPE_CODE[x.dtype], ctypes.c_void_p(stream),
                        plan_ptr, ws_ptr, n_blocks)
    if err != 0:
        raise RuntimeError(f"dw_splitk ({route} route) launch failed: "
                           f"{lib.dw_splitk_error_string(err).decode()}")
    dw_splitk.launches += 1
    dw_splitk.route_launches[route] += 1
    return out


dw_splitk.launches = 0
dw_splitk.route_launches = dict.fromkeys(ROUTES, 0)
