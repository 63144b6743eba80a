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

They consume q/k/v in the projection GEMMs' ``[B, S, H·dk]`` layout (or
as column slices of a merged q|k|v or k|v GEMM output: each operand has
its own row stride, ``_row_stride``, and K2 writes dq, dk and dv with
their inputs' strides), add
the relative bias on the top-left ``L×L`` block only and the −1e9 key
mask, run an f32 softmax, cast the (dropped) probabilities to v's dtype
and accumulate ``p·v`` in f32. Dropout keeps an element when its
Philox4x32-10 bits (``csrc/philox.cuh``; ``philox_keep_mask`` here is
the same stream in PyTorch) fall below ``uint32((1−rate)·(2³²−1))``, the
Pallas kernel's rule, and scales kept p by 1/(1−rate). The TPU's own
random bits cannot be reproduced, so parity with JAX holds at rate 0.

``_FusedAttention`` is the custom VJP (K3): its forward runs K1′ and
saves p, the seed and the Philox row offset ``bh0``, its backward runs
K2. K3's mesh path is that offset: a data-parallel rank r over B rows
passes bh0 = r·B·H, so its rows draw the dropout streams of rows
r·B … r·B + B − 1 of a one-process call (JAX's shard_map path shifts the
seed instead, ``vqacl_tpu/ops/fused_attention.py:490-495``);
``_FusedAttentionPacked`` is its variant over merged projection outputs
(``fused_attention_packed``), whose backward returns one gradient buffer
of the packed layout. Dispatch in
``fused_attention``: with grad enabled and q, k or v requiring grad the
call goes through ``_FusedAttention``; otherwise it runs K1, which is
inference-only (``dropout_rate > 0`` raises there). Each wrapper takes
its plain PyTorch version (``*_reference``) for CPU tensors, so the CPU
tests run the same autograd logic; on CUDA tensors it launches its
kernel or raises, and counts the launch in ``<wrapper>.launches`` (and,
when an operand is strided, in ``<wrapper>.strided_launches``; K1′ and
K2 launched with a row offset ``bh0`` ≠ 0 also in ``.offset_launches``,
and with a first head ``h0`` ≠ 0 in ``.head_offset_launches``; and by
route, "mma" or "scalar", in ``.route_launches``). A
tensor-parallel rank runs K1′/K2 over its heads h0 … h0 + H − 1 of rows
of ``Hc`` heads: the Philox counter of (b, h) is then bh0 + b·Hc + h0 +
h, so its heads draw the same heads' streams of a one-process call
(defaults Hc = H, h0 = 0: bh0 + b·H + h, as before). Every call goes
to the ``*_strided`` C entries, a dense operand at the stride H·dk.
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


def stream_rows(B: int, H: int, bh0: int = 0, Hc: Optional[int] = None,
                h0: int = 0, device=None) -> torch.Tensor:
    """The Philox counter word of each (b, h) of a launch over heads h0 …
    h0 + H − 1 of rows of ``Hc`` heads (default H), from row offset bh0:
    bh0 + b·Hc + h0 + h, int64 [B·H] (``csrc/philox.cuh::stream_row``).
    Raises ValueError unless 0 ≤ h0 and h0 + H ≤ Hc."""
    Hc = H if Hc is None else int(Hc)
    if h0 < 0 or h0 + H > Hc:
        raise ValueError(f"fused_attention: heads {h0}..{h0 + H - 1} do not "
                         f"lie in a row of {Hc} heads")
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    h = torch.arange(H, dtype=torch.int64, device=device)[None, :]
    return (bh0 + b * Hc + h0 + h).reshape(B * H)


def philox_keep_mask(seed: torch.Tensor, B: int, H: int, Tq: int, Sk: int,
                     rate: float, bh0: int = 0, Hc: Optional[int] = None,
                     h0: int = 0) -> torch.Tensor:
    """The keep mask [B,H,Tq,Sk] (bool) that K1′ and K2 apply: key
    (seed, 0), counter (j // 4, i, bh0 + b·Hc + h0 + h, 0), word j % 4
    (``stream_rows``). A data-parallel rank r of B rows passes bh0 =
    r·B·Hc and draws rows r·B … r·B + B − 1 of the one-process mask; a
    tensor-parallel rank over heads h0 … h0 + H − 1 of Hc passes Hc and
    h0 and draws those heads of it."""
    dev = seed.device
    J = (Sk + 3) // 4
    i64 = torch.int64
    c0 = torch.arange(J, dtype=i64, device=dev).view(1, 1, J)
    c1 = torch.arange(Tq, dtype=i64, device=dev).view(1, Tq, 1)
    c2 = stream_rows(B, H, bh0, Hc, h0, dev).view(B * H, 1, 1)
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
        seed: torch.Tensor, num_heads: int, dropout_rate: float,
        bh0: int = 0, Hc: Optional[int] = None, h0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1′ → (o [B,Tq,H·dk] in q's dtype,
    pre-dropout p [B,H·Tq,Sk] f32)."""
    B, Tq, _ = q.shape
    Sk = k.shape[1]
    H = num_heads
    p = _probs(q, k, bias, mask, H)
    pd = p
    if dropout_rate > 0.0:
        keep = philox_keep_mask(seed, B, H, Tq, Sk, dropout_rate, bh0, Hc,
                                h0)
        pd = torch.where(keep, p / _keep_div(dropout_rate, p.device), 0.0)
    o = pd.to(v.dtype).float() @ _heads(v, H).float()
    return _merge(o).to(q.dtype), p.reshape(B, H * Tq, Sk)


def fused_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
        seed: torch.Tensor, do: torch.Tensor, num_heads: int, L: int,
        dropout_rate: float, bh0: int = 0, Hc: Optional[int] = None,
        h0: int = 0
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
        keep = philox_keep_mask(seed, B, H, Tq, Sk, dropout_rate, bh0, Hc,
                                h0)
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


def _row_stride(name: str, t: torch.Tensor, dtype, shape) -> int:
    """The row stride, in elements, of a [B,S,W] operand that the kernels
    read or write as rows: its last dimension contiguous and its batch
    stride S rows, as a column slice of a wider projection output (merged
    q/k/v) is. Raises ValueError for any other layout or type."""
    B, S, W = shape
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_attention: {name} must be a {dtype} tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    ld = t.stride(1) if S > 1 else (t.stride(0) if B > 1 else W)
    if (W > 1 and t.stride(2) != 1) or ld < W \
            or (B > 1 and t.stride(0) != S * ld):
        raise ValueError(f"fused_attention: {name} must be rows of one "
                         f"stride with a contiguous last dimension, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")
    return ld


def _qkv_strides(q, k, v) -> Tuple[int, int, int]:
    """(ldq, ldk, ldv): the row strides of q [B,Tq,W] and k, v [B,Sk,W];
    W = H·dk for a dense operand, more for a slice of a merged one."""
    B, Tq, HD = q.shape
    Sk = k.shape[1]
    return (_row_stride("q", q, q.dtype, (B, Tq, HD)),
            _row_stride("k", k, q.dtype, (B, Sk, HD)),
            _row_stride("v", v, q.dtype, (B, Sk, HD)))


def _check_rows16(what: str, named) -> None:
    """The bf16 routes stage rows in 16-byte ``cp.async`` chunks: each
    (name, tensor, row stride) must start every row on 16 bytes, i.e.
    base address and stride multiples of 8 bf16 elements."""
    for name, t, ld in named:
        if t.data_ptr() % 16 or ld % 8:
            raise ValueError(
                f"{what}: the bf16 kernel needs every row of {name} on 16 "
                f"bytes (base offset and row stride multiples of 8 "
                f"elements), got stride {ld} at address {t.data_ptr()}")


def _validate_qkv(q, k, v, num_heads, extra=()):
    """Check the kernels' q/k/v on a CUDA device (dense, or rows of one
    stride each: ``_row_stride``), and that ``extra`` tensors lie on the
    same device → (B, Tq, Sk, dk)."""
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
    _qkv_strides(q, k, v)
    for t in (k, v) + tuple(extra):
        if t.device != q.device:
            raise ValueError("fused_attention: tensors on different devices")
    return B, Tq, Sk, HD // H


def _validate_fwd(q, k, v, num_heads, extra=()):
    """``_validate_qkv`` plus the forward's route and limits and, on the
    bf16 route, 16-byte rows → (B, Tq, Sk, dk)."""
    B, Tq, Sk, dk = _validate_qkv(q, k, v, num_heads, extra)
    if fwd_route(q.dtype, dk, Tq, Sk) == "mma":
        _check_rows16("fused_attention",
                      zip("qkv", (q, k, v), _qkv_strides(q, k, v)))
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
    lds = _qkv_strides(q, k, v)
    strided = lds != (num_heads * dk,) * 3
    lib = _build.load("fused_attention_fwd")
    o = torch.empty((B, Tq, num_heads * dk), dtype=q.dtype, device=q.device)
    err = lib.fused_attention_fwd_strided(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if L else None, mask.data_ptr(), o.data_ptr(), B, Tq,
        Sk, num_heads, dk, L, *lds, _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, lib, "fused_attention_fwd", "fused_attention_error_string")
    fused_attention.launches += 1
    fused_attention.strided_launches += strided
    fused_attention.route_launches[fwd_route(q.dtype, dk, Tq, Sk)] += 1
    return o


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], mask: torch.Tensor,
                    num_heads: int, dropout_rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None,
                    bh0: int = 0, Hc: Optional[int] = None,
                    h0: int = 0) -> torch.Tensor:
    """q [B,Tq,H·dk], k/v [B,Sk,H·dk] (f32 or bf16, one dtype; dense, or
    column slices of a wider projection output, whose row stride the
    kernels take: ``_row_stride``); bias [H,L,L] f32 covering the first L
    positions, or None; mask [B,Sk] (1 = attend); seed int32 [1] on q's
    device (the layer's dropout stream; zeros when None); bh0, Hc and h0
    place the Philox streams (``stream_rows``: a data-parallel rank's row
    offset, a tensor-parallel rank's heads h0 … of rows of Hc) →
    [B,Tq,H·dk] in q's dtype.

    Differentiable calls go through K1′/K2; others run K1 (counted in
    ``fused_attention.launches``, and those on strided operands also in
    ``fused_attention.strided_launches``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if seed is None:
            seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        return _FusedAttention.apply(q, k, v, bias, mask, seed, num_heads,
                                     float(dropout_rate), int(bh0),
                                     num_heads if Hc is None else int(Hc),
                                     int(h0))
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_attention: the inference kernel takes no dropout; "
            "dropout runs only on the differentiable (training) path")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, mask, num_heads)
    return _launch_k1(q, k, v, bias, mask, num_heads)


fused_attention.launches = 0
fused_attention.strided_launches = 0
fused_attention.route_launches = dict.fromkeys(ROUTE_NAMES, 0)


def fused_attention_fwd_train(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              mask: torch.Tensor, seed: torch.Tensor,
                              num_heads: int, dropout_rate: float,
                              bh0: int = 0, Hc: Optional[int] = None,
                              h0: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1′ → (o [B,Tq,H·dk] in q's dtype, pre-dropout p [B,H·Tq,Sk] f32).
    q, k, v, bh0, Hc and h0 as in ``fused_attention``; launches on
    strided operands are also counted in ``strided_launches``."""
    Hc = num_heads if Hc is None else int(Hc)
    stream_rows(1, num_heads, 0, Hc, h0)          # the heads lie in a row
    if q.device.type == "cpu":
        return fused_attention_fwd_train_reference(
            q, k, v, bias, mask, seed, num_heads, dropout_rate, bh0, Hc, h0)
    from vqacl_tpu_torch.ops import _build

    B, Tq, Sk, dk = _validate_fwd(q, k, v, num_heads, (seed,))
    L, mask = _validate_bias_mask(q, bias, mask, num_heads, Sk)
    _check("seed", seed, torch.int32, (1,))
    lds = _qkv_strides(q, k, v)
    strided = lds != (num_heads * dk,) * 3
    lib = _build.load("fused_attention_fwd")
    o = torch.empty((B, Tq, num_heads * dk), dtype=q.dtype, device=q.device)
    p = torch.empty((B, num_heads * Tq, Sk), dtype=torch.float32,
                    device=q.device)
    drop = dropout_rate > 0.0
    err = lib.fused_attention_fwd_train_strided(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if L else None, mask.data_ptr(), seed.data_ptr(),
        o.data_ptr(), p.data_ptr(), B, Tq, Sk, num_heads, dk, L, *lds,
        _DTYPE_CODE[q.dtype], int(drop),
        dropout_threshold(dropout_rate) if drop else 0, 1.0 - dropout_rate,
        _stream(q), int(bh0), Hc, int(h0))
    _raise_on(err, lib, "fused_attention_fwd_train",
              "fused_attention_error_string")
    fused_attention_fwd_train.launches += 1
    fused_attention_fwd_train.strided_launches += strided
    fused_attention_fwd_train.route_launches[
        fwd_route(q.dtype, dk, Tq, Sk)] += 1
    fused_attention_fwd_train.offset_launches += bh0 != 0
    fused_attention_fwd_train.head_offset_launches += h0 != 0
    return o, p


fused_attention_fwd_train.launches = 0
fused_attention_fwd_train.strided_launches = 0
fused_attention_fwd_train.route_launches = dict.fromkeys(ROUTE_NAMES, 0)
fused_attention_fwd_train.offset_launches = 0
fused_attention_fwd_train.head_offset_launches = 0


def _rows_like(t: torch.Tensor, ld: int) -> torch.Tensor:
    """An empty tensor of ``t``'s shape [B,S,W] laid out as rows of
    ``ld`` elements (a column slice of a [B,S,ld] buffer): where K2
    writes the gradient of an operand of that stride."""
    B, S, W = t.shape
    return torch.empty((B, S, ld), dtype=t.dtype, device=t.device)[..., :W]


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        p: torch.Tensor, seed: torch.Tensor,
                        do: torch.Tensor, num_heads: int, L: int,
                        dropout_rate: float,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]] = None,
                        bh0: int = 0, Hc: Optional[int] = None,
                        h0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """K2 → (dq, dk, dv in q's dtype, dbias [H,L,L] f32 or None if L=0).

    q, k, v, bh0, Hc and h0 as in ``fused_attention`` (do dense
    [B,Tq,H·dk]); dq, dk
    and dv are written as rows of their input's stride: into ``out``
    (three tensors of that layout, e.g. the slices of one merged gradient
    buffer) or, without it, into new buffers of that layout. Launches on
    strided operands are also counted in ``strided_launches``."""
    if out is not None:
        for name, t, g in zip(("dq", "dk", "dv"), (q, k, v), out):
            if g.device != t.device or _row_stride(name, g, t.dtype,
                                                   t.shape) != (
                    _row_stride(name[1:], t, t.dtype, t.shape)):
                raise ValueError(f"fused_attention_bwd: out {name} must "
                                 f"have {name[1:]}'s shape, dtype, device "
                                 f"and row stride")
    Hc = num_heads if Hc is None else int(Hc)
    stream_rows(1, num_heads, 0, Hc, h0)          # the heads lie in a row
    if q.device.type == "cpu":
        dq, dk_, dv, dbias = fused_attention_bwd_reference(
            q, k, v, p, seed, do, num_heads, L, dropout_rate, bh0, Hc, h0)
        if out is None:
            return dq, dk_, dv, dbias
        for g, r in zip(out, (dq, dk_, dv)):
            g.copy_(r)
        return (*out, dbias)
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
    lds = _qkv_strides(q, k, v)
    dq, dk_, dv = out if out is not None else (
        _rows_like(t, ld) for t, ld in zip((q, k, v), lds))
    route = bwd_route(q.dtype, dk, Tq, Sk, dropout_rate)
    if route == "mma":
        _check_rows16("fused_attention_bwd", zip(
            ("q", "k", "v", "do", "dq", "dk", "dv"), (q, k, v, do, dq, dk_, dv),
            lds + (HD,) + lds))
    strided = lds != (HD,) * 3
    lib = _build.load("fused_attention_bwd")
    dbias = part = None
    if L:
        part = torch.empty((B, H, L, L), dtype=torch.float32,
                           device=q.device)
        dbias = torch.empty((H, L, L), dtype=torch.float32, device=q.device)
    drop = dropout_rate > 0.0
    err = lib.fused_attention_bwd_strided(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        seed.data_ptr(), do.data_ptr(), dq.data_ptr(), dk_.data_ptr(),
        dv.data_ptr(), part.data_ptr() if L else None,
        dbias.data_ptr() if L else None, B, Tq, Sk, H, dk, L, *lds,
        _DTYPE_CODE[q.dtype], int(drop),
        dropout_threshold(dropout_rate) if drop else 0, 1.0 - dropout_rate,
        _stream(q), int(bh0), Hc, int(h0))
    _raise_on(err, lib, "fused_attention_bwd",
              "fused_attention_bwd_error_string")
    fused_attention_bwd.launches += 1
    fused_attention_bwd.strided_launches += strided
    fused_attention_bwd.route_launches[route] += 1
    fused_attention_bwd.offset_launches += bh0 != 0
    fused_attention_bwd.head_offset_launches += h0 != 0
    return dq, dk_, dv, dbias


fused_attention_bwd.launches = 0
fused_attention_bwd.strided_launches = 0
fused_attention_bwd.route_launches = dict.fromkeys(ROUTE_NAMES, 0)
fused_attention_bwd.offset_launches = 0
fused_attention_bwd.head_offset_launches = 0


def fused_attention_keep_mask(seed: torch.Tensor, B: int, H: int, Tq: int,
                              Sk: int, rate: float, bh0: int = 0,
                              Hc: Optional[int] = None, h0: int = 0
                              ) -> torch.Tensor:
    """The keep mask [B,H,Tq,Sk] (bool) as the CUDA kernels draw it, with
    the streams of ``stream_rows(B, H, bh0, Hc, h0)``, for holding
    ``philox_keep_mask`` against them on the card."""
    from vqacl_tpu_torch.ops import _build

    if seed.device.type != "cuda":
        raise ValueError("fused_attention_keep_mask: needs a CUDA seed")
    _check("seed", seed, torch.int32, (1,))
    Hc = H if Hc is None else int(Hc)
    stream_rows(1, H, 0, Hc, h0)                  # the heads lie in a row
    lib = _build.load("fused_attention_bwd")
    out = torch.empty((B, H, Tq, Sk), dtype=torch.uint8, device=seed.device)
    err = lib.fused_attention_keep_mask(seed.data_ptr(), out.data_ptr(),
                                        B * H, Tq, Sk,
                                        dropout_threshold(rate),
                                        _stream(seed), int(bh0), H, Hc,
                                        int(h0))
    _raise_on(err, lib, "fused_attention_keep_mask",
              "fused_attention_bwd_error_string")
    return out.bool()


class _FusedAttention(torch.autograd.Function):
    """The custom VJP (K3): forward through K1′, which saves p; backward
    through K2, which regenerates the keep mask from the saved seed and
    Philox streams ``(bh0, Hc, h0)`` (K3's mesh path: a data-parallel
    rank's row offset ``rank·B·Hc`` and a tensor-parallel rank's heads,
    so that they draw a one-process call's streams)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, num_heads, dropout_rate,
                bh0=0, Hc=None, h0=0):
        if q.device.type == "cuda":    # refuse before K1′ launches
            bwd_route(q.dtype, q.shape[-1] // num_heads, q.shape[1],
                      k.shape[1], dropout_rate)
        o, p = fused_attention_fwd_train(q, k, v, bias, mask, seed,
                                         num_heads, dropout_rate, bh0, Hc,
                                         h0)
        ctx.save_for_backward(q, k, v, p, seed)
        ctx.num_heads = num_heads
        ctx.dropout_rate = dropout_rate
        ctx.streams = (bh0, Hc, h0)
        ctx.L = 0 if bias is None else bias.shape[-1]
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, p, seed = ctx.saved_tensors
        bh0, Hc, h0 = ctx.streams
        dq, dk, dv, dbias = fused_attention_bwd(
            q, k, v, p, seed, do.contiguous(), ctx.num_heads, ctx.L,
            ctx.dropout_rate, bh0=bh0, Hc=Hc, h0=h0)
        return dq, dk, dv, dbias, None, None, None, None, None, None, None


def _unpack(x: torch.Tensor, kv: Optional[torch.Tensor]):
    """(q, k, v) views of packed projection outputs: x [B,S,3·W] holds
    q|k|v when ``kv`` is None; otherwise x is q [B,Tq,W] and kv
    [B,Sk,2·W] holds k|v. No copy: each view keeps its buffer's row
    stride."""
    if kv is None:
        W = x.shape[-1] // 3
        return x[..., :W], x[..., W:2 * W], x[..., 2 * W:]
    W = x.shape[-1]
    return x, kv[..., :W], kv[..., W:]


class _FusedAttentionPacked(torch.autograd.Function):
    """K3 over merged projection outputs (``merged_qkv``): the merged
    variant of ``_FusedAttention``.

    Design: the Function takes the packed GEMM outputs themselves, x =
    q|k|v [B,S,3·H·dk] (self-attention; ``kv`` None) or x = q with kv =
    k|v [B,Sk,2·H·dk] (cross-attention), and hands K1′ and K2 their column
    slices as strided views, with no copy. Its backward allocates ONE
    gradient buffer per packed input, laid out as that input, and K2
    writes dq, dk and dv straight into its slices, so autograd sees one
    gradient of the packed GEMM output and the merged projection's
    backward is one dX and one dW product. (Slicing first and calling
    ``_FusedAttention`` would leave autograd to build the packed
    gradient from three zero-filled slice gradients summed.)"""

    @staticmethod
    def forward(ctx, x, kv, bias, mask, seed, num_heads, dropout_rate,
                bh0=0, Hc=None, h0=0):
        q, k, v = _unpack(x, kv)
        if q.device.type == "cuda":    # refuse before K1′ launches
            bwd_route(q.dtype, q.shape[-1] // num_heads, q.shape[1],
                      k.shape[1], dropout_rate)
        o, p = fused_attention_fwd_train(q, k, v, bias, mask, seed,
                                         num_heads, dropout_rate, bh0, Hc,
                                         h0)
        ctx.save_for_backward(x, kv, p, seed)
        ctx.num_heads = num_heads
        ctx.dropout_rate = dropout_rate
        ctx.streams = (bh0, Hc, h0)
        ctx.L = 0 if bias is None else bias.shape[-1]
        return o

    @staticmethod
    def backward(ctx, do):
        x, kv, p, seed = ctx.saved_tensors
        bh0, Hc, h0 = ctx.streams
        dx = torch.empty_like(x)       # dense, as fused_attention_packed
        dkv = None if kv is None else torch.empty_like(kv)   # checks x, kv
        *_, dbias = fused_attention_bwd(
            *_unpack(x, kv), p, seed, do.contiguous(), ctx.num_heads, ctx.L,
            ctx.dropout_rate, out=_unpack(dx, dkv), bh0=bh0, Hc=Hc, h0=h0)
        return dx, dkv, dbias, None, None, None, None, None, None, None


def fused_attention_packed(x: torch.Tensor, kv: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], mask: torch.Tensor,
                           num_heads: int, dropout_rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None,
                           bh0: int = 0, Hc: Optional[int] = None,
                           h0: int = 0) -> torch.Tensor:
    """``fused_attention`` on packed projection outputs (``_unpack``: x =
    q|k|v [B,S,3·H·dk], or x = q [B,Tq,H·dk] with kv = k|v [B,Sk,2·H·dk];
    each dense) → [B,Tq,H·dk]. Differentiable calls go through
    ``_FusedAttentionPacked``; others run K1 on the strided views."""
    for name, t in (("x", x), ("kv", kv)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_attention_packed: {name} must be a "
                             f"dense projection output")
    if torch.is_grad_enabled() and (x.requires_grad or (
            kv is not None and kv.requires_grad)):
        if seed is None:
            seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
        return _FusedAttentionPacked.apply(x, kv, bias, mask, seed,
                                           num_heads, float(dropout_rate),
                                           int(bh0), num_heads if Hc is None
                                           else int(Hc), int(h0))
    return fused_attention(*_unpack(x, kv), bias, mask, num_heads,
                           dropout_rate=dropout_rate, seed=seed, bh0=bh0,
                           Hc=Hc, h0=h0)


def _bias_block(pos_bias: Optional[torch.Tensor], q: torch.Tensor,
                k: torch.Tensor) -> Optional[torch.Tensor]:
    """pos_bias [H,L,L] as the kernels' dense f32 bias block, checked to
    fit the first L of q's and k's positions (dim 1); None stays None."""
    if pos_bias is None:
        return None
    L, Tq, Sk = pos_bias.shape[-1], q.shape[1], k.shape[1]
    if L > min(Tq, Sk):
        raise ValueError(f"bias block {L} exceeds (Tq, Sk) = ({Tq}, {Sk})")
    return pos_bias.to(torch.float32).contiguous()


def _fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos_bias: Optional[torch.Tensor], mask: torch.Tensor,
               dropout_rate: float = 0.0,
               seed: Optional[torch.Tensor] = None,
               bh0: int = 0, Hc: Optional[int] = None,
               h0: int = 0) -> torch.Tensor:
    """q [B,Tq,H,dk], k/v [B,Sk,H,dk] (the projection outputs, reshaped
    flat without a copy); pos_bias [H,L,L] or None; mask [B,Sk]; seed
    int32 [1]; bh0, Hc, h0 the Philox streams → [B,Tq,H·dk]. The JAX wrapper pads to a multiple of 8 for
    the TPU's tiling; the CUDA kernels handle ragged lengths themselves,
    so nothing is padded here (padded keys are masked, so the result is
    the same)."""
    B, Tq, H, dk = q.shape
    Sk = k.shape[1]
    bias = _bias_block(pos_bias, q, k)
    return fused_attention(q.reshape(B, Tq, H * dk), k.reshape(B, Sk, H * dk),
                           v.reshape(B, Sk, H * dk), bias, mask, H,
                           dropout_rate=dropout_rate, seed=seed, bh0=bh0,
                           Hc=Hc, h0=h0)


def fused_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos_bias: torch.Tensor, mask: torch.Tensor,
                            dropout_rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None,
                            bh0: int = 0, Hc: Optional[int] = None,
                            h0: int = 0) -> torch.Tensor:
    """Self-attention: q/k/v [B,S,H,dk], pos_bias [H,L,L] f32 covering the
    first L positions, mask [B,S], seed int32 [1], bh0, Hc, h0 the Philox
    streams → [B,S,H·dk]."""
    return _fused_mha(q, k, v, pos_bias, mask, dropout_rate=dropout_rate,
                      seed=seed, bh0=bh0, Hc=Hc, h0=h0)


def fused_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, dropout_rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None,
                          bh0: int = 0, Hc: Optional[int] = None,
                          h0: int = 0) -> torch.Tensor:
    """Bias-free rectangular attention: q [B,Tq,H,dk], k/v [B,Sk,H,dk],
    mask [B,Sk], seed int32 [1], bh0, Hc, h0 the Philox streams →
    [B,Tq,H·dk]."""
    return _fused_mha(q, k, v, None, mask, dropout_rate=dropout_rate,
                      seed=seed, bh0=bh0, Hc=Hc, h0=h0)


def fused_encoder_attention_merged(qkv: torch.Tensor, pos_bias: torch.Tensor,
                                   mask: torch.Tensor, num_heads: int,
                                   dropout_rate: float = 0.0,
                                   seed: Optional[torch.Tensor] = None,
                                   bh0: int = 0, Hc: Optional[int] = None,
                                   h0: int = 0) -> torch.Tensor:
    """Self-attention on the merged projection output qkv [B,S,3·H·dk]
    (``t5.qkv_proj_merged``'s GEMM), q, k and v reaching the kernels as
    strided views; pos_bias [H,L,L] f32, mask [B,S], seed int32 [1], bh0,
    Hc, h0 the Philox streams → [B,S,H·dk]."""
    return fused_attention_packed(qkv, None, _bias_block(pos_bias, qkv, qkv),
                                  mask, num_heads, dropout_rate, seed, bh0,
                                  Hc, h0)


def fused_cross_attention_merged(q: torch.Tensor, kv: torch.Tensor,
                                 mask: torch.Tensor,
                                 dropout_rate: float = 0.0,
                                 seed: Optional[torch.Tensor] = None,
                                 bh0: int = 0, Hc: Optional[int] = None,
                                 h0: int = 0) -> torch.Tensor:
    """Bias-free rectangular attention: q [B,Tq,H,dk] and the merged k|v
    projection kv [B,Sk,2·H·dk] (``t5.kv_proj_merged``'s GEMM), mask
    [B,Sk], seed int32 [1], bh0, Hc, h0 the Philox streams →
    [B,Tq,H·dk]."""
    B, Tq, H, dk = q.shape
    return fused_attention_packed(q.reshape(B, Tq, H * dk), kv, None, mask,
                                  H, dropout_rate, seed, bh0, Hc, h0)
