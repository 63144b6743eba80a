"""The weight gradient xᵀ·g of a linear layer, as one kernel (K5).

Counterpart of ``pallas_dw``/``dw_kernel`` in ``scripts/mm_bench.py``,
the probe's split-K weight gradient: x [K,D] (the layer's input rows)
and g [K,F] (the gradient of its output), bf16 or f32, → out [D,F] f32,
the sum over K taken in f32. The CUDA kernel (``csrc/dw_splitk.cu``;
the note at its top says what bounds it and how it is built) gives each
block one output tile and walks K in order, with no atomics, so the
result is the same on every run.

``dw_splitk`` is the wrapper: it takes the plain version
``dw_splitk_reference`` for CPU tensors, and on CUDA tensors launches
the kernel or raises, counting each launch in ``dw_splitk.launches``.
Nothing of the training path calls it; ``vqacl_tpu_torch.mm_bench``
times it beside the library's matrix products.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dw_splitk_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [K,D], g [K,F] → xᵀ·g [D,F] f32."""
    return x.float().t() @ g.float()


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


def dw_splitk(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [K,D], g [K,F] (contiguous, one dtype, f32 or bf16) → xᵀ·g
    [D,F] f32: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _validate(x, g)
    if x.device.type == "cpu":
        return dw_splitk_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"dw_splitk: unsupported device {x.device}")
    from vqacl_tpu_torch.ops import _build

    K, D = x.shape
    F = g.shape[1]
    lib = _build.load("dw_splitk")
    out = torch.empty((D, F), dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    err = lib.dw_splitk(x.data_ptr(), g.data_ptr(), out.data_ptr(), K, D, F,
                        _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_splitk launch failed: "
                           f"{lib.dw_splitk_error_string(err).decode()}")
    dw_splitk.launches += 1
    return out


dw_splitk.launches = 0
