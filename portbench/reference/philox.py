"""The attention-dropout keep mask, from its seed (a frozen copy).

Philox4x32-10 as the port's attention kernels draw it: key (seed, 0),
counter (j // 4, query i, stream b·H + h, 0), word j % 4; an element is
kept when its bits fall below ``uint32((1 − rate)·(2³² − 1))``. Words are
uint32 held in int64 tensors (products wrap modulo 2⁶⁴, so their low and
high halves are exact).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _rounds(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, B: int, H: int, Tq: int, Sk: int,
              rate: float) -> torch.Tensor:
    """bool [B, H, Tq, Sk]."""
    dev = seed.device
    i64 = torch.int64
    J = (Sk + 3) // 4
    shape = (B * H, Tq, J)
    c0 = torch.arange(J, dtype=i64, device=dev).view(1, 1, J).expand(shape)
    c1 = torch.arange(Tq, dtype=i64, device=dev).view(1, Tq, 1).expand(shape)
    c2 = torch.arange(B * H, dtype=i64, device=dev).view(B * H, 1, 1) \
        .expand(shape)
    c3 = torch.zeros(shape, dtype=i64, device=dev)
    k0 = seed.reshape(()).to(i64) & _U32
    words = _rounds(c0, c1, c2, c3, k0, 0)
    bits = torch.stack(words, dim=-1).reshape(B * H, Tq, 4 * J)[..., :Sk]
    return (bits < int((1.0 - rate) * (2 ** 32 - 1))).view(B, H, Tq, Sk)
