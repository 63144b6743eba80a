"""Fused multi-head attention for the VL-T5 joint encoder and, with
``fused_decoder``, the decoder's causal self- and cross-attention.

Counterpart of ``vqacl_tpu/ops/fused_attention.py``. Three hand-written
CUDA kernels replace its Pallas kernels (the note at the top of each
source says what it computes, what bounds it and how):

  K1   ``fused_attention``            inference forward
       (``csrc/fused_attention_fwd.cu``, entry ``fused_attention_fwd``)
  K1′  ``fused_attention_fwd_train``  training forward: also saves the
       pre-dropout probabilities p [B,H·Tq,Sk] f32 and applies dropout
       (same source, entry ``fused_attention_fwd_train``)
  K2   ``fused_attention_bwd``        backward from the saved p
       (``csrc/fused_attention_bwd.cu``)

Every kernel takes bf16 on the tensor cores (``mma.sync``; dk a multiple
of 16 up to 128) and f32 as scalar FMAs; ``fwd_route`` picks the
forward's route and raises ValueError, before anything is built, for a
call neither takes. ``bwd_route`` does the same for K2, whose block holds
the whole [Tq, Sk] score tile, and ``_FusedAttention`` checks it before
K1′ runs, so a training call K2 cannot take fails before its forward.

They consume q/k/v in the projection GEMMs' ``[B, S, H·dk]`` layout, add
the relative bias on the top-left ``L×L`` block only and the −1e9 key
mask, run an f32 softmax, cast the (dropped) probabilities to v's dtype
and accumulate ``p·v`` in f32. Dropout keeps an element when its
Philox4x32-10 bits (``csrc/philox.cuh``; ``philox_keep_mask`` here is
the same stream in PyTorch) fall below ``uint32((1−rate)·(2³²−1))``, the
Pallas kernel's rule, and scales kept p by 1/(1−rate). The TPU's own
random bits cannot be reproduced, so parity with JAX holds at rate 0.

``_FusedAttention`` is the custom VJP (K3, single device): its forward
runs K1′ and saves p and the seed, its backward runs K2. Dispatch in
``fused_attention``: with grad enabled and q, k or v requiring grad the
call goes through ``_FusedAttention``; otherwise it runs K1, which is
inference-only (``dropout_rate > 0`` raises there). Each wrapper takes
its plain PyTorch version (``*_reference``) for CPU tensors, so the CPU
tests run the same autograd logic; on CUDA tensors it launches its
kernel or raises, and counts the launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e9

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Philox4x32-10 constants (csrc/philox.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """The Pallas kernel's keep threshold: keep when bits < this."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (products wrap
    modulo 2⁶⁴, so their low and high 32-bit halves are exact)."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
    return c0, c1, c2, c3


def philox_keep_mask(seed: torch.Tensor, B: int, H: int, Tq: int, Sk: int,
                     rate: float) -> torch.Tensor:
    """The keep mask [B,H,Tq,Sk] (bool) that K1′ and K2 apply: key
    (seed, 0), counter (j // 4, i, b·H + h, 0), word j % 4."""
    dev = seed.device
    J = (Sk + 3) // 4
    i64 = torch.int64
    c0 = torch.arange(J, dtype=i64, device=dev).view(1, 1, J)
    c1 = torch.arange(Tq, dtype=i64, device=dev).view(1, Tq, 1)
    c2 = torch.arange(B * H, dtype=i64, device=dev).view(B * H, 1, 1)
    shape = (B * H, Tq, J)
    c0, c1, c2 = (c.expand(shape) for c in (c0, c1, c2))
    c3 = torch.zeros(shape, dtype=i64, device=dev)
    k0 = seed.reshape(()).to(i64) & _U32
    words = philox4x32_10(c0, c1, c2, c3, k0, 0)
    bits = torch.stack(words, dim=-1).reshape(B * H, Tq, 4 * J)[..., :Sk]
    return (bits < dropout_threshold(rate)).view(B, H, Tq, Sk)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B,S,H·dk] → [B,H,S,dk]."""
    B, S, HD = x.shape
    return x.reshape(B, S, H, HD // H).permute(0, 2, 1, 3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B,H,S,dk] → [B,S,H·dk]."""
    B, H, S, dk = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, S, H * dk)


def _probs(q, k, bias, mask, H) -> torch.Tensor:
    """Softmax probabilities [B,H,Tq,Sk] f32 with the kernels' bias and
    mask terms."""
    Tq, Sk = q.shape[1], k.shape[1]
    s = _heads(q, H).float() @ _heads(k, H).float().transpose(-1, -2)
    if bias is not None and bias.shape[-1] > 0:
        L = bias.shape[-1]
        blk = torch.zeros((H, Tq, Sk), dtype=torch.float32, device=q.device)
        blk[:, :L, :L] = bias.float()
        s = s + blk
    s = s + ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    return torch.softmax(s, dim=-1)


def _keep_div(rate: float, device) -> torch.Tensor:
    """1 − rate as an f32 tensor: a true division, as in the kernels (a
    Python scalar divisor becomes a reciprocal multiply on CUDA; the bf16
    forward kernel's reciprocal multiply carries a correction step that
    gives the division's rounded quotient)."""
    return torch.tensor(1.0 - rate, dtype=torch.float32, device=device)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              mask: torch.Tensor, num_heads: int
                              ) -> torch.Tensor:
    """Plain PyTorch version of K1.

    q [B,Tq,H·dk], k/v [B,Sk,H·dk]; bias [H,L,L] f32 for the first L
    query/key positions, or None (L = 0); mask [B,Sk], 1 = attend.
    → [B,Tq,H·dk] in q's dtype."""
    p = _probs(q, k, bias, mask, num_heads)
    o = p.to(v.dtype).float() @ _heads(v, num_heads).float()
    return _merge(o).to(q.dtype)


def fused_attention_fwd_train_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor], mask: torch.Tensor,
        seed: torch.Tensor, num_heads: int, dropout_rate: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1′ → (o [B,Tq,H·dk] in q's dtype,
    pre-dropout p [B,H·Tq,Sk] f32)."""
    B, Tq, _ = q.shape
    Sk = k.shape[1]
    H = num_heads
    p = _probs(q, k, bias, mask, H)
    pd = p
    if dropout_rate > 0.0:
        keep = philox_keep_mask(seed, B, H, Tq, Sk, dropout_rate)
        pd = torch.where(keep, p / _keep_div(dropout_rate, p.device), 0.0)
    o = pd.to(v.dtype).float() @ _heads(v, H).float()
    return _merge(o).to(q.dtype), p.reshape(B, H * Tq, Sk)


def fused_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
        seed: torch.Tensor, do: torch.Tensor, num_heads: int, L: int,
        dropout_rate: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K2 → (dq, dk, dv in q's dtype, dbias
    [H,L,L] f32, or None when L = 0)."""
    B, Tq, _ = q.shape
    Sk = k.shape[1]
    H = num_heads
    qh, kh, vh, doh = (_heads(x, H).float() for x in (q, k, v, do))
    p = p.reshape(B, H, Tq, Sk)
    pd = p
    if dropout_rate > 0.0:
        keep = philox_keep_mask(seed, B, H, Tq, Sk, dropout_rate)
        kd = _keep_div(dropout_rate, p.device)
        pd = torch.where(keep, p / kd, 0.0)
    dv = pd.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if dropout_rate > 0.0:
        dp = torch.where(keep, dp / kd, 0.0)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dbias = ds[:, :, :L, :L].sum(dim=0) if L else None
    return (_merge(dq).to(q.dtype), _merge(dk).to(q.dtype),
            _merge(dv).to(q.dtype), dbias)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"fused_attention: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")


def _validate_qkv(q, k, v, num_heads, extra=()):
    """Check the kernels' q/k/v on a CUDA device, and that ``extra``
    tensors lie on the same device → (B, Tq, Sk, dk)."""
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
    for t in (k, v) + tuple(extra):
        if t.device != q.device:
            raise ValueError("fused_attention: tensors on different devices")
    return B, Tq, Sk, HD // H


def _validate_fwd(q, k, v, num_heads, extra=()):
    """``_validate_qkv`` plus the forward's route and limits; the bf16
    route stages 16-byte chunks, so q, k and v must be 16-byte aligned
    → (B, Tq, Sk, dk)."""
    B, Tq, Sk, dk = _validate_qkv(q, k, v, num_heads, extra)
    if fwd_route(q.dtype, dk, Tq, Sk) == "mma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"fused_attention: the bf16 kernel needs "
                                 f"{name} 16-byte aligned")
    return B, Tq, Sk, dk


def _validate_bias_mask(q, bias, mask, num_heads, Sk):
    """Check the forward kernels' bias [H,L,L] (or None) and mask [B,Sk]
    → (L, mask as contiguous f32)."""
    B, Tq, _ = q.shape
    mask = mask.to(torch.float32).contiguous()
    _check("mask", mask, torch.float32, (B, Sk))
    L = 0 if bias is None else bias.shape[-1]
    if L > min(Tq, Sk):
        raise ValueError(f"fused_attention: bias block {L} exceeds "
                         f"(Tq, Sk) = ({Tq}, {Sk})")
    if L:
        _check("bias", bias, torch.float32, (num_heads, L, L))
    for t in (mask,) + ((bias,) if L else ()):
        if t.device != q.device:
            raise ValueError("fused_attention: tensors on different devices")
    return L, mask


# The forward's two routes (csrc/fused_attention_fwd.cu): bf16 on the
# tensor cores for dk a multiple of 16 up to MMA_MAX_DK, f32 as scalar
# FMAs; both keep a head's K and V panels in one block's shared memory.
MMA_MAX_DK = 128
SMEM_PER_BLOCK = 232448
ROUTE_NAMES = {"mma": "mma.sync bf16", "scalar": "scalar f32"}


def _mma_smem(Tq: int, Sk: int, dk: int, heads: int = 1) -> int:
    """Shared memory of one stage of ``heads`` heads in the bf16 route, the
    bias left in device memory (the C side's ``mma_stage_bytes``): K and V
    [Skp][dk+8] and Q [Tqp][dk+8] bf16 per head and the mask [Skp] f32,
    with Skp and Tqp the lengths rounded up to 16, in all rounded up to 16
    bytes."""
    skp = -(-Sk // 16) * 16
    tqp = -(-Tq // 16) * 16
    return -(-(2 * heads * (2 * skp + tqp) * (dk + 8) + 4 * skp) // 16) * 16


def _scalar_smem(Sk: int, dk: int) -> int:
    """Shared memory of the f32 route's block (the C side's ``launch``)."""
    return 4 * (Sk * (dk + 1) + Sk * dk + Sk + 4 * dk + 4 * Sk)


def fwd_route(dtype: torch.dtype, dk: int, Tq: int, Sk: int) -> str:
    """The forward kernel (K1, K1′) that takes a call: "mma" for bf16,
    "scalar" for f32. Raises ValueError, naming the limit, for a call
    neither takes. Pure Python: nothing is built or launched."""
    if dtype == torch.bfloat16:
        if dk % 16 or not 16 <= dk <= MMA_MAX_DK:
            raise ValueError(
                f"fused_attention: the bf16 kernel takes a head width dk "
                f"that is a multiple of 16 up to {MMA_MAX_DK}, got {dk} "
                f"(f32 takes any dk)")
        route, smem = "mma", _mma_smem(Tq, Sk, dk)
    elif dtype == torch.float32:
        route, smem = "scalar", _scalar_smem(Sk, dk)
    else:
        raise ValueError(f"fused_attention: dtype {dtype} not supported")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_attention: {Sk} keys of width {dk} need {smem} bytes of "
            f"shared memory per block in the {ROUTE_NAMES[route]} kernel, "
            f"more than the {SMEM_PER_BLOCK} a block can use")
    return route


def _bwd_smem(Tq: int, Sk: int, dk: int, dropout: bool) -> int:
    """Shared memory of the f32 route's K2 block (the C side's ``launch``
    in ``csrc/fused_attention_bwd.cu``): q, do [Tq][dk+1], k, v [Sk][dk+1],
    p (then ds) and the dropped p [Tq][Sk] and a dp row for each of 8
    warps, f32, and with dropout the keep mask [Tq][Sk] as bytes."""
    return 4 * (2 * Tq * (dk + 1) + 2 * Sk * (dk + 1) + 2 * Tq * Sk
                + 8 * Sk) + (Tq * Sk if dropout else 0)


def _bwd_mma_smem(Tq: int, Sk: int, dk: int, heads: int = 1) -> int:
    """Shared memory of one unit of ``heads`` heads in K2's bf16 route (the
    C side's ``bwd_stage_bytes``): q and do [Tqp][dk+8], k and v
    [Skp][dk+8] and the hi and lo tiles of ds and pd [Tqp][Skp+8] per
    head, all bf16, with Tqp and Skp the lengths rounded up to 16."""
    skp = -(-Sk // 16) * 16
    tqp = -(-Tq // 16) * 16
    return 2 * heads * ((2 * tqp + 2 * skp) * (dk + 8) + 4 * tqp * (skp + 8))


def bwd_route(dtype: torch.dtype, dk: int, Tq: int, Sk: int,
              dropout_rate: float) -> str:
    """The backward kernel route (K2) that takes a call: "mma" for bf16,
    "scalar" for f32. Raises ValueError, naming the limit, for a call
    neither takes: each holds a head's panels and its whole [Tq, Sk] score
    tile in one block's shared memory. Pure Python: nothing is built or
    launched."""
    if dtype == torch.bfloat16:
        if dk % 16 or not 16 <= dk <= MMA_MAX_DK:
            raise ValueError(
                f"fused_attention: the bf16 backward kernel takes a head "
                f"width dk that is a multiple of 16 up to {MMA_MAX_DK}, got "
                f"{dk} (f32 takes any dk)")
        route, smem = "mma", _bwd_mma_smem(Tq, Sk, dk)
    elif dtype == torch.float32:
        route, smem = "scalar", _bwd_smem(Tq, Sk, dk, dropout_rate > 0.0)
    else:
        raise ValueError(f"fused_attention: dtype {dtype} not supported")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_attention: the backward kernel needs {smem} bytes of "
            f"shared memory per block for Tq {Tq} x Sk {Sk} keys of width "
            f"{dk} in its {ROUTE_NAMES[route]} route, more than the "
            f"{SMEM_PER_BLOCK} a block can use")
    return route


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, lib, what: str, error_string: str) -> None:
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _launch_k1(q, k, v, bias, mask, num_heads) -> torch.Tensor:
    from vqacl_tpu_torch.ops import _build

    B, Tq, Sk, dk = _validate_fwd(q, k, v, num_heads)
    L, mask = _validate_bias_mask(q, bias, mask, num_heads, Sk)
    lib = _build.load("fused_attention_fwd")
    o = torch.empty_like(q)
    err = lib.fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if L else None, mask.data_ptr(), o.data_ptr(),
        B, Tq, Sk, num_heads, dk, L, _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, lib, "fused_attention_fwd", "fused_attention_error_string")
    fused_attention.launches += 1
    return o


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], mask: torch.Tensor,
                    num_heads: int, dropout_rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Tq,H·dk], k/v [B,Sk,H·dk] (f32 or bf16, one dtype); bias
    [H,L,L] f32 covering the first L positions, or None; mask [B,Sk]
    (1 = attend); seed int32 [1] on q's device (the layer's dropout
    stream; zeros when None) → [B,Tq,H·dk] in q's dtype.

    Differentiable calls go through K1′/K2; others run K1 (counted in
    ``fused_attention.launches``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if seed is None:
            seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        return _FusedAttention.apply(q, k, v, bias, mask, seed, num_heads,
                                     float(dropout_rate))
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_attention: the inference kernel takes no dropout; "
            "dropout runs only on the differentiable (training) path")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, mask, num_heads)
    return _launch_k1(q, k, v, bias, mask, num_heads)


fused_attention.launches = 0


def fused_attention_fwd_train(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              mask: torch.Tensor, seed: torch.Tensor,
                              num_heads: int, dropout_rate: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1′ → (o in q's dtype, pre-dropout p [B,H·Tq,Sk] f32)."""
    if q.device.type == "cpu":
        return fused_attention_fwd_train_reference(
            q, k, v, bias, mask, seed, num_heads, dropout_rate)
    from vqacl_tpu_torch.ops import _build

    B, Tq, Sk, dk = _validate_fwd(q, k, v, num_heads, (seed,))
    L, mask = _validate_bias_mask(q, bias, mask, num_heads, Sk)
    _check("seed", seed, torch.int32, (1,))
    lib = _build.load("fused_attention_fwd")
    o = torch.empty_like(q)
    p = torch.empty((B, num_heads * Tq, Sk), dtype=torch.float32,
                    device=q.device)
    drop = dropout_rate > 0.0
    err = lib.fused_attention_fwd_train(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if L else None, mask.data_ptr(), seed.data_ptr(),
        o.data_ptr(), p.data_ptr(), B, Tq, Sk, num_heads, dk, L,
        _DTYPE_CODE[q.dtype], int(drop),
        dropout_threshold(dropout_rate) if drop else 0,
        1.0 - dropout_rate, _stream(q))
    _raise_on(err, lib, "fused_attention_fwd_train",
              "fused_attention_error_string")
    fused_attention_fwd_train.launches += 1
    return o, p


fused_attention_fwd_train.launches = 0


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        p: torch.Tensor, seed: torch.Tensor,
                        do: torch.Tensor, num_heads: int, L: int,
                        dropout_rate: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """K2 → (dq, dk, dv in q's dtype, dbias [H,L,L] f32 or None if L=0)."""
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, p, seed, do,
                                             num_heads, L, dropout_rate)
    from vqacl_tpu_torch.ops import _build

    H = num_heads
    B, Tq, Sk, dk = _validate_qkv(q, k, v, H, (p, seed, do))
    HD = H * dk
    _check("p", p, torch.float32, (B, H * Tq, Sk))
    _check("do", do, q.dtype, (B, Tq, HD))
    _check("seed", seed, torch.int32, (1,))
    if L > min(Tq, Sk):
        raise ValueError(f"fused_attention_bwd: bias block {L} exceeds "
                         f"(Tq, Sk) = ({Tq}, {Sk})")
    if bwd_route(q.dtype, dk, Tq, Sk, dropout_rate) == "mma":
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"fused_attention_bwd: the bf16 kernel "
                                 f"needs {name} 16-byte aligned")
    lib = _build.load("fused_attention_bwd")
    dq = torch.empty_like(q)
    dk_ = torch.empty_like(k)
    dv = torch.empty_like(v)
    dbias = part = None
    if L:
        part = torch.empty((B, H, L, L), dtype=torch.float32,
                           device=q.device)
        dbias = torch.empty((H, L, L), dtype=torch.float32, device=q.device)
    drop = dropout_rate > 0.0
    err = lib.fused_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        seed.data_ptr(), do.data_ptr(), dq.data_ptr(), dk_.data_ptr(),
        dv.data_ptr(), part.data_ptr() if L else None,
        dbias.data_ptr() if L else None, B, Tq, Sk, H, dk, L,
        _DTYPE_CODE[q.dtype], int(drop),
        dropout_threshold(dropout_rate) if drop else 0,
        1.0 - dropout_rate, _stream(q))
    _raise_on(err, lib, "fused_attention_bwd",
              "fused_attention_bwd_error_string")
    fused_attention_bwd.launches += 1
    return dq, dk_, dv, dbias


fused_attention_bwd.launches = 0


def fused_attention_keep_mask(seed: torch.Tensor, B: int, H: int, Tq: int,
                              Sk: int, rate: float) -> torch.Tensor:
    """The keep mask [B,H,Tq,Sk] (bool) as the CUDA kernels draw it, for
    holding ``philox_keep_mask`` against them on the card."""
    from vqacl_tpu_torch.ops import _build

    if seed.device.type != "cuda":
        raise ValueError("fused_attention_keep_mask: needs a CUDA seed")
    _check("seed", seed, torch.int32, (1,))
    lib = _build.load("fused_attention_bwd")
    out = torch.empty((B, H, Tq, Sk), dtype=torch.uint8, device=seed.device)
    err = lib.fused_attention_keep_mask(seed.data_ptr(), out.data_ptr(),
                                        B * H, Tq, Sk,
                                        dropout_threshold(rate),
                                        _stream(seed))
    _raise_on(err, lib, "fused_attention_keep_mask",
              "fused_attention_bwd_error_string")
    return out.bool()


class _FusedAttention(torch.autograd.Function):
    """The custom VJP (K3 on one device): forward through K1′, which
    saves p; backward through K2, which regenerates the keep mask from
    the saved seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, num_heads, dropout_rate):
        if q.device.type == "cuda":    # refuse before K1′ launches
            bwd_route(q.dtype, q.shape[-1] // num_heads, q.shape[1],
                      k.shape[1], dropout_rate)
        o, p = fused_attention_fwd_train(q, k, v, bias, mask, seed,
                                         num_heads, dropout_rate)
        ctx.save_for_backward(q, k, v, p, seed)
        ctx.num_heads = num_heads
        ctx.dropout_rate = dropout_rate
        ctx.L = 0 if bias is None else bias.shape[-1]
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, p, seed = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_bwd(
            q, k, v, p, seed, do.contiguous(), ctx.num_heads, ctx.L,
            ctx.dropout_rate)
        return dq, dk, dv, dbias, None, None, None, None


def _fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos_bias: Optional[torch.Tensor], mask: torch.Tensor,
               dropout_rate: float = 0.0,
               seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Tq,H,dk], k/v [B,Sk,H,dk] (the projection outputs, reshaped
    flat without a copy); pos_bias [H,L,L] or None; mask [B,Sk]; seed
    int32 [1] → [B,Tq,H·dk]. The JAX wrapper pads to a multiple of 8 for
    the TPU's tiling; the CUDA kernels handle ragged lengths themselves,
    so nothing is padded here (padded keys are masked, so the result is
    the same)."""
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
                           dropout_rate=dropout_rate, seed=seed)


def fused_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos_bias: torch.Tensor, mask: torch.Tensor,
                            dropout_rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Self-attention: q/k/v [B,S,H,dk], pos_bias [H,L,L] f32 covering the
    first L positions, mask [B,S], seed int32 [1] → [B,S,H·dk]."""
    return _fused_mha(q, k, v, pos_bias, mask, dropout_rate=dropout_rate,
                      seed=seed)


def fused_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, dropout_rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Bias-free rectangular attention: q [B,Tq,H,dk], k/v [B,Sk,H,dk],
    mask [B,Sk], seed int32 [1] → [B,Tq,H·dk]."""
    return _fused_mha(q, k, v, None, mask, dropout_rate=dropout_rate,
                      seed=seed)
