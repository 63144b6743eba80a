"""The routed experts of an MoE layer as grouped matrix products.

An expert layer that is told which experts it holds: the router scores
all of the model's experts and picks ``k`` per token, and this module
computes the part of the result that the held experts (ids
``0 .. E-1``) give. Each expert is a SwiGLU, ``(silu(x·Wg) ⊙ x·Wu)·Wd``
with ``Wg``, ``Wu`` [E, D, F] and ``Wd`` [E, F, D] stacked over the held
experts.

``route_plan`` sorts the token choices by expert on the device (a stable
sort, a scatter-add count and a cumulative sum: nothing is read back to
the host). The plan's rows are the choices in expert order; held
expert e owns rows ``offsets[e] .. offsets[e+1]`` of the sorted buffers,
and the choices of experts not held follow at the end. Every buffer is
sized for the worst case, every choice held (``T·k`` rows), since the
host never learns the counts; any count from 0 to all the tokens per
expert is taken, and no token is dropped.

``grouped_swiglu(x, plan, wg, wu, wd)`` → the sorted rows' expert
outputs [T·k, D] (rows past ``offsets[E]`` are not written). On CPU
tensors it takes the plain version ``grouped_swiglu_reference``, a loop
of products over the experts. On CUDA tensors it runs the kernels of
``csrc/moe_grouped_gemm.cu`` as one ``autograd.Function``: two launches
forward (gate|up with SiLU·mul, then down) and four backward (the
activation's gradient with the SwiGLU's backward, the input's gradient,
and the two f32 weight gradients), each counted in
``grouped_swiglu.launches`` and the recorder's counter
``moe.grouped_gemm``. The kernels read the offsets on the card; the
weights are bf16 copies of the f32 master weights made at each call,
gate and up interleaved in blocks of 64 columns (``interleave``) so
that one 128-column tile holds a gate block and its up block. CUDA
tensors of another kind raise ``ValueError``; nothing falls back.

``combine`` gathers each token's held choices from the sorted outputs,
weights them and sums them (choices of experts not held add nothing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vqacl_tpu_torch.utils.profiling import count

BLOCK = 128          # rows and columns of a kernel tile
GROUP = 64           # columns of a gate or up block in the interleaved W
_INT_MAX = 2 ** 31 - 1


class Plan(NamedTuple):
    """The token choices sorted by held expert, made on the device."""
    rows: torch.Tensor      # int32 [T·k]: the token of each sorted row
    pos: torch.Tensor       # int64 [T, k]: each choice's sorted row
    held: torch.Tensor      # bool [T, k]: the choice is a held expert
    offsets: torch.Tensor   # int32 [E + 1]: expert e's rows start
    experts: int            # E, the held experts
    max_rows: int           # the most rows one expert can get: T


def route_plan(idx: torch.Tensor, experts: int) -> Plan:
    """``idx`` [T, k] int64 (the router's choices, any expert id) →
    the plan for the held experts ``0 .. experts-1``."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    held = flat < experts
    key = torch.where(held, flat, torch.full_like(flat, experts))
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(experts + 1, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts[:experts], 0)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=idx.device)
    return Plan((order // k).to(torch.int32), pos.view(T, k),
                held.view(T, k), offsets, experts, T)


def combine(out: torch.Tensor, plan: Plan, weights: torch.Tensor
            ) -> torch.Tensor:
    """Σ over a token's held choices of weight × expert output → [T, D]
    f32. Rows of choices not held are never read as numbers (``where``
    before the product: the sorted buffer is not written there)."""
    T, k = plan.pos.shape
    got = out[plan.pos.reshape(-1)].view(T, k, -1)
    got = torch.where(plan.held[..., None], got, torch.zeros_like(got))
    return (got.float() * weights[..., None]).sum(1)


def grouped_swiglu_reference(x: torch.Tensor, plan: Plan, wg: torch.Tensor,
                             wu: torch.Tensor, wd: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version: per held expert, its rows of ``x`` [T, D] (in the
    plan's order) through its SwiGLU in ``x``'s dtype (f32 activation) →
    [T·k, D], zeros past the held rows; differentiable by autograd."""
    dt = x.dtype
    xs = x[plan.rows.long()]
    out = torch.zeros_like(xs)
    off = plan.offsets.tolist()
    for e in range(plan.experts):
        s, t = off[e], off[e + 1]
        if s == t:
            continue
        h = xs[s:t]
        a = torch.nn.functional.silu((h @ wg[e].to(dt)).float()) \
            * (h @ wu[e].to(dt)).float()
        out = out.index_copy(0, torch.arange(s, t, device=x.device),
                             a.to(dt) @ wd[e].to(dt))
    return out


def interleave(wg: torch.Tensor, wu: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """[E, D, F] gate and up → [E, D, 2F] in ``dtype``: columns
    128b .. 128b+63 are gate columns 64b .. 64b+63, the next 64 the same
    up columns."""
    E, D, F = wg.shape
    out = torch.empty((E, D, F // GROUP, 2, GROUP), dtype=dtype,
                      device=wg.device)
    out[:, :, :, 0].copy_(wg.view(E, D, F // GROUP, GROUP))
    out[:, :, :, 1].copy_(wu.view(E, D, F // GROUP, GROUP))
    return out.view(E, D, 2 * F)


def check_shapes(x: torch.Tensor, wg: torch.Tensor, wd: torch.Tensor
                 ) -> None:
    """ValueError unless the kernels take these: bf16 ``x`` on the card,
    D and F multiples of the tile, sizes that fit an int32."""
    E, D, F = wg.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"grouped_swiglu: x is {x.dtype}; the kernels take "
                         f"bfloat16")
    if D % BLOCK or F % GROUP or (2 * F) % BLOCK or F % BLOCK:
        raise ValueError(f"grouped_swiglu: D={D}, F={F}; the kernels take "
                         f"multiples of {BLOCK}")
    if tuple(wd.shape) != (E, F, D) or x.shape[-1] != D:
        raise ValueError(f"grouped_swiglu: x {tuple(x.shape)}, gate "
                         f"{tuple(wg.shape)}, down {tuple(wd.shape)}")
    if x.shape[0] * 2 * F > _INT_MAX:
        raise ValueError("grouped_swiglu: too many rows for the kernels")


def _launch(fn, *args) -> None:
    from vqacl_tpu_torch.ops import _build

    lib = _build.load("moe_grouped_gemm")
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.moe_error_string(err).decode()}")
    grouped_swiglu.launches += 1
    count("moe.grouped_gemm")


def _ptr(t):
    return None if t is None else t.data_ptr()


def rows_gemm(a, a_rows, b, b_kmajor: bool, plan: Plan, c, c2, g, n: int,
              k: int, epi: int) -> None:
    """C rows of each held expert = A rows (gathered through ``a_rows``
    when given) · B[e] (csrc: ``moe_rows_gemm``)."""
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch("moe_rows_gemm", _ptr(a), _ptr(a_rows), a.shape[-1], _ptr(b),
            b.stride(0), b.shape[-1], int(b_kmajor), _ptr(plan.offsets),
            plan.experts, plan.max_rows, _ptr(c), _ptr(c2), _ptr(g), n, k,
            epi, stream)


def dw_gemm(a, a_rows, b, plan: Plan, c, c2, m: int, n: int, epi: int
            ) -> None:
    """f32 C[e] = Σ over expert e's rows of A rowᵀ ⊗ B row (csrc:
    ``moe_dw_gemm``)."""
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _launch("moe_dw_gemm", _ptr(a), _ptr(a_rows), a.shape[-1], _ptr(b),
            b.shape[-1], _ptr(plan.offsets), plan.experts, _ptr(c), _ptr(c2),
            m, n, epi, stream)


EPI_STORE, EPI_SWIGLU, EPI_SWIGLU_BWD = 0, 1, 2
EPI_DW, EPI_DW_SPLIT = 0, 1


class _GroupedSwiglu(torch.autograd.Function):
    """``x`` [T, D] → the sorted rows' outputs [T·k, D] through the
    kernels; the backward returns f32 weight gradients (cast to the
    weights' dtype) and sums each token's held rows of the input
    gradient."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, rows, pos, held, offsets, experts,
                max_rows):
        plan = Plan(rows, pos, held, offsets, experts, max_rows)
        E, D, F = wg.shape
        R = rows.shape[0]
        wgu = interleave(wg, wu)
        wdb = wd.to(torch.bfloat16).contiguous()
        x = x.contiguous()
        gu = torch.empty((R, 2 * F), dtype=torch.bfloat16, device=x.device)
        act = torch.empty((R, F), dtype=torch.bfloat16, device=x.device)
        out = torch.empty((R, D), dtype=torch.bfloat16, device=x.device)
        rows_gemm(x, rows, wgu, True, plan, gu, act, None, 2 * F, D,
                  EPI_SWIGLU)
        rows_gemm(act, None, wdb, True, plan, out, None, None, D, F,
                  EPI_STORE)
        ctx.save_for_backward(x, rows, pos, held, offsets, wgu, wdb, gu,
                              act)
        ctx.meta = (experts, max_rows, wg.dtype, wd.dtype)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, rows, pos, held, offsets, wgu, wdb, gu, act = ctx.saved_tensors
        experts, max_rows, wg_dtype, wd_dtype = ctx.meta
        plan = Plan(rows, pos, held, offsets, experts, max_rows)
        E, D, F2 = wgu.shape
        F = F2 // 2
        R = rows.shape[0]
        dev = x.device
        d_out = d_out.to(torch.bfloat16).contiguous()
        dgu = torch.empty((R, F2), dtype=torch.bfloat16, device=dev)
        rows_gemm(d_out, None, wdb, False, plan, dgu, None, gu, F, D,
                  EPI_SWIGLU_BWD)
        dxs = torch.empty((R, D), dtype=torch.bfloat16, device=dev)
        rows_gemm(dgu, None, wgu, False, plan, dxs, None, None, D, F2,
                  EPI_STORE)
        dwg = torch.empty((E, D, F), dtype=torch.float32, device=dev)
        dwu = torch.empty_like(dwg)
        dw_gemm(x, rows, dgu, plan, dwg, dwu, D, F2, EPI_DW_SPLIT)
        dwd = torch.empty((E, F, D), dtype=torch.float32, device=dev)
        dw_gemm(act, None, d_out, plan, dwd, None, F, D, EPI_DW)
        dx = combine(dxs, plan, torch.ones_like(held, dtype=torch.float32))
        return (dx.to(x.dtype), dwg.to(wg_dtype), dwu.to(wg_dtype),
                dwd.to(wd_dtype)) + (None,) * 6


def grouped_swiglu(x: torch.Tensor, plan: Plan, wg: torch.Tensor,
                   wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The held experts' SwiGLU outputs for the plan's sorted rows →
    [T·k, D] in ``x``'s dtype (see the module's note)."""
    if x.device.type == "cpu":
        return grouped_swiglu_reference(x, plan, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu: unsupported device {x.device}")
    check_shapes(x, wg, wd)
    return _GroupedSwiglu.apply(x, wg, wu, wd, plan.rows, plan.pos,
                                plan.held, plan.offsets, plan.experts,
                                plan.max_rows)


grouped_swiglu.launches = 0
