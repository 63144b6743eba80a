"""Fused multi-head attention for the VL-T5 joint encoder.

Counterpart of ``vqacl_tpu/ops/fused_attention.py``. The kernel,
``csrc/fused_attention_fwd.cu``, replaces the Pallas forward
``_fwd_kernel_batched`` (see the note at the top of that file for what
it computes, what bounds it and how). It consumes q/k/v in the
projection GEMMs' ``[B, S, H·dk]`` layout, adds the relative bias on the
top-left ``L×L`` block only and the −1e9 key mask, runs an f32 softmax,
casts the probabilities to v's dtype and accumulates ``p·v`` in f32.

``fused_attention`` dispatches on the tensors' device: CPU tensors take
``fused_attention_reference`` (the plain PyTorch version with the same
cast points, used by the CPU tests); CUDA tensors launch the kernel or
raise. ``fused_attention.launches`` counts the kernel launches.

Only the inference forward is ported: ``dropout_rate > 0`` raises until
the training slice brings the Philox-seeded dropout, the saved-
probability forward, the backward kernel and the autograd wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e9

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              mask: torch.Tensor, num_heads: int
                              ) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's semantics.

    q [B,Tq,H·dk], k/v [B,Sk,H·dk]; bias [H,L,L] f32 for the first L
    query/key positions, or None (L = 0); mask [B,Sk], 1 = attend.
    → [B,Tq,H·dk] in q's dtype."""
    B, Tq, HD = q.shape
    Sk = k.shape[1]
    H = num_heads
    dk = HD // H
    qh = q.reshape(B, Tq, H, dk).permute(0, 2, 1, 3).float()
    kh = k.reshape(B, Sk, H, dk).permute(0, 2, 1, 3).float()
    vh = v.reshape(B, Sk, H, dk).permute(0, 2, 1, 3)
    s = qh @ kh.transpose(-1, -2)                             # [B,H,Tq,Sk]
    if bias is not None and bias.shape[-1] > 0:
        L = bias.shape[-1]
        blk = torch.zeros((H, Tq, Sk), dtype=torch.float32, device=q.device)
        blk[:, :L, :L] = bias.float()
        s = s + blk
    s = s + ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype).float() @ vh.float()                    # [B,H,Tq,dk]
    return o.permute(0, 2, 1, 3).reshape(B, Tq, HD).to(q.dtype)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"fused_attention: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], mask: torch.Tensor,
                    num_heads: int, dropout_rate: float = 0.0
                    ) -> torch.Tensor:
    """q [B,Tq,H·dk], k/v [B,Sk,H·dk] (f32 or bf16, one dtype); bias
    [H,L,L] f32 covering the first L positions, or None; mask [B,Sk]
    (1 = attend) → [B,Tq,H·dk] in q's dtype."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_attention: dropout is not ported yet (inference only)")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    B, Tq, HD = q.shape
    Sk = k.shape[1]
    H = num_heads
    if HD % H:
        raise ValueError(f"fused_attention: width {HD} not divisible by "
                         f"{H} heads")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_attention: dtype {q.dtype} not supported")
    _check("q", q, q.dtype, (B, Tq, HD))
    _check("k", k, q.dtype, (B, Sk, HD))
    _check("v", v, q.dtype, (B, Sk, HD))
    mask = mask.to(torch.float32).contiguous()
    _check("mask", mask, torch.float32, (B, Sk))
    L = 0 if bias is None else bias.shape[-1]
    if L > min(Tq, Sk):
        raise ValueError(f"fused_attention: bias block {L} exceeds "
                         f"(Tq, Sk) = ({Tq}, {Sk})")
    if L:
        _check("bias", bias, torch.float32, (H, L, L))
    for t in (k, v, mask) + ((bias,) if L else ()):
        if t.device != q.device:
            raise ValueError("fused_attention: tensors on different devices")
    from vqacl_tpu_torch.ops import _build

    lib = _build.load("fused_attention_fwd")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if L else None, mask.data_ptr(), o.data_ptr(),
        B, Tq, Sk, H, HD // H, L, _DTYPE_CODE[q.dtype],
        ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fused_attention_error_string(err).decode()
        raise RuntimeError(f"fused_attention_fwd launch failed: {msg}")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0


def _fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos_bias: Optional[torch.Tensor], mask: torch.Tensor,
               dropout_rate: float = 0.0) -> torch.Tensor:
    """q [B,Tq,H,dk], k/v [B,Sk,H,dk] (the projection outputs, reshaped
    flat without a copy); pos_bias [H,L,L] or None; mask [B,Sk]
    → [B,Tq,H·dk]. The JAX wrapper pads to a multiple of 8 for the TPU's
    tiling; the CUDA kernel handles ragged lengths itself, so nothing is
    padded here (padded keys are masked, so the result is the same)."""
    B, Tq, H, dk = q.shape
    Sk = k.shape[1]
    bias = None
    if pos_bias is not None:
        L = pos_bias.shape[-1]
        if L > min(Tq, Sk):
            raise ValueError(f"bias block {L} exceeds (Tq, Sk) = ({Tq}, {Sk})")
        bias = pos_bias.to(torch.float32).contiguous()
    return fused_attention(q.reshape(B, Tq, H * dk), k.reshape(B, Sk, H * dk),
                           v.reshape(B, Sk, H * dk), bias, mask, H,
                           dropout_rate=dropout_rate)


def fused_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos_bias: torch.Tensor, mask: torch.Tensor,
                            dropout_rate: float = 0.0) -> torch.Tensor:
    """Self-attention: q/k/v [B,S,H,dk], pos_bias [H,L,L] f32 covering the
    first L positions, mask [B,S] → [B,S,H·dk]."""
    return _fused_mha(q, k, v, pos_bias, mask, dropout_rate=dropout_rate)


def fused_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor,
                          dropout_rate: float = 0.0) -> torch.Tensor:
    """Bias-free rectangular attention: q [B,Tq,H,dk], k/v [B,Sk,H,dk],
    mask [B,Sk] → [B,Tq,H·dk]."""
    return _fused_mha(q, k, v, None, mask, dropout_rate=dropout_rate)
