"""How the reference multiplies.

``F32``: float32 products with TF32 off (``f32_matmul`` turns it off for
the process while the reference runs). ``FP8``: the control, the
precision below the configuration's bf16: each operand of each product
rounded to fp8 e4m3 with one scale per tensor (``amax / 448``), as an
fp8 path would feed the tensor cores, then multiplied in f32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class Precision:
    name = "f32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


class _Fp8(Precision):
    name = "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        y = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        # straight-through: the backward sees the rounding as identity
        return x + (y - x).detach()


F32 = Precision()
FP8 = _Fp8()
BY_NAME = {"f32": F32, "fp8": FP8}


@contextlib.contextmanager
def f32_matmul():
    """TF32 off for cuBLAS and cuDNN while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
