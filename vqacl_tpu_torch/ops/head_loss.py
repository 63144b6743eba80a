"""The LM head's cross-entropy over the vocabulary as two kernels (H1, H2).

``models/vlt5.py::fused_head_loss`` computes the weighted cross-entropy of
the head's logits ``h·Wᵀ`` (h [rows, D] the rescaled hidden, W [V, D] the
head in the hidden's dtype) without keeping the logits. On CUDA bf16
tensors it runs the kernels of ``csrc/head_loss.cu`` (the note at its top
says how they are built):

- ``head_lse`` (H1): the logits tile by tile with bf16 ``wgmma`` products
  summed in f32, an online log-sum-exp per row over each 256-column chunk
  of the vocabulary, and the logit at each row's label; a second launch
  merges the chunks' (max, sum) pairs in chunk order into ``lse`` [rows];
- ``head_dlogits`` (H2): the same logits again, then
  ``(exp(l − lse) − onehot(label)) · w`` rounded to bf16, written as
  d(logits) [rows, V] and as its transpose [V, rows_pad] (``rows_pad``
  the rows rounded up to 8, zeros past the rows), the operands of the two
  gradient products, which are K5 (``ops/dw.py::dw_splitk``):
  dshared = d(logits)ᵀ·h and dh = d(logits)·W.

Neither writes f32 [rows, V] logits, probabilities or d(logits).

``head_loss_route`` picks the route before anything is built: "wgmma"
for bf16 on CUDA, where D is a multiple of 64, V of 8 and both bases are
16-byte aligned (anything else there raises ``ValueError``), "plain" for
CPU tensors and for f32 (the plain version in ``models/vlt5.py``).
``head_plan`` is the grid and the chunks the kernels are given, and
``lse_reference`` / ``dlogits_reference`` are H1's and H2's plain
versions: the wrappers take them for CPU tensors, and the CPU tests check
them. On CUDA tensors each wrapper launches its kernels or raises,
counting them in ``.launches`` and by route in ``.route_launches``.
``head_loss_forward`` / ``head_loss_backward`` are the op on this route,
H1 in the forward, H2 and the two K5 products in the backward, for
``models/vlt5.py::_FusedHeadLoss``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from vqacl_tpu_torch.ops import dw

ROUTES = ("wgmma",)
BLOCK_M = 128        # hidden rows of a kernel tile
BLOCK_N = 256        # vocabulary columns of a kernel tile: one chunk
BLOCK_K = 64         # d of one stage (a 128-byte TMA box row)
_INT_MAX = 2 ** 31 - 1


def head_loss_route(device: str, dtype: torch.dtype, rows: int, D: int,
                    V: int, *tensors: torch.Tensor) -> str:
    """"wgmma" or "plain" for the hidden's ``device`` type and ``dtype``,
    ``rows`` × ``D`` against a head of ``V`` rows; ``tensors`` (the head's
    bf16 copy, the rescaled hidden), when given, for their layout. Raises
    ValueError for what the kernels cannot take on the card. Pure Python:
    nothing is built or launched."""
    if device == "cpu" or dtype == torch.float32:
        return "plain"
    if device != "cuda":
        raise ValueError(f"head_loss: unsupported device {device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"head_loss: dtype {dtype} not supported on the "
                         f"card (bfloat16, or float32 for the plain version)")
    if min(rows, D, V) < 1:
        raise ValueError(f"head_loss: empty operand rows={rows} D={D} V={V}")
    if D % BLOCK_K or V % 8:
        raise ValueError(f"head_loss: D={D} must be a multiple of {BLOCK_K} "
                         f"and V={V} of 8")
    if head_plan(rows, D, V).blocks > _INT_MAX:
        raise ValueError(f"head_loss: rows={rows} x V={V}: more blocks "
                         f"than an int32 counts")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("head_loss: operands must be contiguous with "
                             "16-byte-aligned bases")
    return "wgmma"


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The kernels' grid for rows × D against V: block b takes the rows'
    tile b % m_tiles (``BLOCK_M`` rows) and the vocabulary chunk
    b // m_tiles (``BLOCK_N`` columns), over ``k_steps`` stages of
    ``BLOCK_K``; the last chunk holds ``ragged`` columns."""
    rows: int
    D: int
    V: int

    @property
    def m_tiles(self) -> int:
        return -(-self.rows // BLOCK_M)

    @property
    def chunks(self) -> int:
        return -(-self.V // BLOCK_N)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.chunks

    @property
    def k_steps(self) -> int:
        return -(-self.D // BLOCK_K)

    @property
    def ragged(self) -> int:
        return self.V - (self.chunks - 1) * BLOCK_N

    @property
    def rows_pad(self) -> int:
        """The rows of the transposed d(logits): a multiple of 8, as K5's
        wgmma route takes."""
        return -(-self.rows // 8) * 8


@functools.lru_cache(maxsize=64)
def head_plan(rows: int, D: int, V: int) -> HeadPlan:
    return HeadPlan(rows, D, V)


# ---- the plain versions of H1 and H2 ---------------------------------------

def _logits(hs: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """f32 logits [rows, V]: f32 products of the rounded operands."""
    return hs.float() @ wb.float().t()


def lse_reference(hs: torch.Tensor, wb: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1's result: hs [rows, D], wb [V, D], labels [rows] in [0, V) →
    (lse f32 [rows], the label's logit f32 [rows]). The kernel merges
    its chunks' (max, sum) pairs in a fixed order of its own: another f32
    summation order than ``torch.logsumexp``'s."""
    lg = _logits(hs, wb)
    ll = lg.gather(1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(lg, dim=1), ll


def dlogits_reference(hs: torch.Tensor, wb: torch.Tensor,
                      labels: torch.Tensor, lse: torch.Tensor,
                      w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """H2's arithmetic: (exp(l − lse) − onehot(label)) · w per element,
    rounded to hs's dtype → (d(logits) [rows, V], its transpose [V,
    rows_pad] with zero columns past the rows)."""
    rows, V = hs.shape[0], wb.shape[0]
    p = torch.exp(_logits(hs, wb) - lse[:, None])
    p.scatter_add_(1, labels.long()[:, None],
                   -torch.ones((rows, 1), device=hs.device))
    out = (p * w[:, None]).to(hs.dtype)
    out_t = torch.zeros((V, head_plan(rows, hs.shape[1], V).rows_pad),
                        dtype=hs.dtype, device=hs.device)
    out_t[:, :rows] = out.t()
    return out, out_t


# ---- the wrappers -----------------------------------------------------------

def _validate(hs: torch.Tensor, wb: torch.Tensor, labels: torch.Tensor,
              *rowwise: torch.Tensor) -> None:
    if hs.dim() != 2 or wb.dim() != 2 or hs.shape[1] != wb.shape[1]:
        raise ValueError(f"head_loss: hs {tuple(hs.shape)} and wb "
                         f"{tuple(wb.shape)} must be [rows, D] and [V, D]")
    if hs.dtype != wb.dtype:
        raise ValueError(f"head_loss: hs {hs.dtype} and wb {wb.dtype} differ")
    rows = hs.shape[0]
    if labels.shape != (rows,) or labels.dtype != torch.int32:
        raise ValueError("head_loss: labels must be int32 [rows]")
    for t in rowwise:
        if t.shape != (rows,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("head_loss: lse and w must be contiguous f32 "
                             "[rows]")
    if any(t.device != hs.device for t in (wb, labels) + rowwise):
        raise ValueError("head_loss: operands on different devices")


def _check_route(name: str, hs: torch.Tensor, wb: torch.Tensor) -> None:
    route = head_loss_route(hs.device.type, hs.dtype, hs.shape[0],
                            hs.shape[1], wb.shape[0], hs, wb)
    if route != "wgmma":
        raise ValueError(f"{name}: {hs.dtype} on {hs.device} takes the plain "
                         f"version, not the kernels")


def _launch(fn, name, hs, wb, *ptrs):
    from vqacl_tpu_torch.ops import _build

    lib = _build.load("head_loss")
    stream = torch.cuda.current_stream(hs.device).cuda_stream
    err = getattr(lib, name)(hs.data_ptr(), wb.data_ptr(), *ptrs,
                             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.head_loss_error_string(err).decode()}")
    fn.route_launches["wgmma"] += fn.per_call
    fn.launches += fn.per_call


def head_lse(hs: torch.Tensor, wb: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1: hs [rows, D] and wb [V, D] (one dtype), labels int32 [rows] in
    [0, V) → (lse f32 [rows], the label's logit f32 [rows]): the kernels
    on CUDA tensors (2 launches), ``lse_reference`` on CPU tensors."""
    _validate(hs, wb, labels)
    if hs.device.type == "cpu":
        return lse_reference(hs, wb, labels)
    rows, D = hs.shape
    V = wb.shape[0]
    _check_route("head_lse", hs, wb)
    plan = head_plan(rows, D, V)
    part = torch.empty((plan.chunks, rows, 2), dtype=torch.float32,
                       device=hs.device)
    lse = torch.empty(rows, dtype=torch.float32, device=hs.device)
    ll = torch.empty(rows, dtype=torch.float32, device=hs.device)
    _launch(head_lse, "head_lse", hs, wb, labels.data_ptr(), part.data_ptr(),
            lse.data_ptr(), ll.data_ptr(), rows, D, V)
    return lse, ll


def head_dlogits(hs: torch.Tensor, wb: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H2: hs, wb and labels as ``head_lse``'s, lse (its output) and w
    (each row's loss weight times the incoming gradient) f32 [rows] →
    (d(logits) [rows, V], its transpose [V, rows_pad]) in hs's dtype: the
    kernel on CUDA tensors (1 launch), ``dlogits_reference`` on CPU
    tensors."""
    _validate(hs, wb, labels, lse, w)
    if hs.device.type == "cpu":
        return dlogits_reference(hs, wb, labels, lse, w)
    rows, D = hs.shape
    V = wb.shape[0]
    _check_route("head_dlogits", hs, wb)
    plan = head_plan(rows, D, V)
    out = torch.empty((rows, V), dtype=hs.dtype, device=hs.device)
    out_t = torch.empty((V, plan.rows_pad), dtype=hs.dtype, device=hs.device)
    _launch(head_dlogits, "head_dlogits", hs, wb, labels.data_ptr(),
            lse.data_ptr(), w.data_ptr(), out.data_ptr(), out_t.data_ptr(),
            rows, plan.rows_pad, D, V)
    return out, out_t


for _fn, _n in ((head_lse, 2), (head_dlogits, 1)):
    _fn.per_call = _n
    _fn.launches = 0
    _fn.route_launches = dict.fromkeys(ROUTES, 0)


# ---- the op on the kernels' route -------------------------------------------

def head_loss_forward(hidden: torch.Tensor, shared: torch.Tensor,
                      safe: torch.Tensor, rs: float):
    """hidden [..., D] times ``rs`` (the rescale, rounded to the hidden's
    dtype), the head ``shared`` [V, D] cast to the hidden's dtype once
    here, labels ``safe`` [...] in [0, V) → (lse, the label's logit, f32
    shaped as ``safe``; the residuals of ``head_loss_backward``: the
    rescaled hidden's rows, the head's copy, the int32 labels)."""
    h = hidden if rs == 1.0 else hidden * rs
    hs = h.reshape(-1, h.shape[-1]).contiguous()
    wb = shared.to(hidden.dtype)
    labels = safe.to(torch.int32).reshape(-1)
    lse, ll = head_lse(hs, wb, labels)
    return lse.view(safe.shape), ll.view(safe.shape), (hs, wb, labels)


def head_loss_backward(res, lse: torch.Tensor, w: torch.Tensor, rs: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``head_loss_forward``'s residuals and lse, and w f32 (each row's
    loss weight times the incoming gradient) shaped as lse → (dh
    [..., D] in the hidden's dtype, then times ``rs``; dshared [V, D]
    f32): d(logits) from H2, dh = d(logits)·W from its transpose and
    dshared = d(logits)ᵀ·h on K5."""
    hs, wb, labels = res
    d, d_t = head_dlogits(hs, wb, labels, lse.reshape(-1), w.reshape(-1))
    dh = dw.dw_splitk(d_t, wb)[:hs.shape[0]].to(hs.dtype)
    if rs != 1.0:
        dh = dh * rs
    return dh.view(*lse.shape, -1), dw.dw_splitk(d, hs)
