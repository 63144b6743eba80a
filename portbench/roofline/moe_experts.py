"""The least time of the grouped expert-GEMM kernels (``ops/moe.py``,
``csrc/moe_grouped_gemm.cu``) of one MoE layer's train step, from the
rows routed to the held experts.

``n`` rows (the token choices of held experts), D the hidden size, F the
expert width, E the held experts, bf16 operands, f32 weight gradients.
Each input byte is counted once and each output byte once; the weights
are the bf16 copies the kernels read. Operations: 2·m·k·n per product.

  fwd_gate_up  rows [n, D] · W_gu [E, D, 2F] → gate|up [n, 2F] and
               silu(gate)·up [n, F]
  fwd_down     act [n, F] · W_d [E, F, D] → out [n, D]
  bwd_act      d_out [n, D] · W_dᵀ → d(act), with gate|up read, d(gate|up)
               [n, 2F] written
  bwd_x        d(gate|up) [n, 2F] · W_guᵀ → dx rows [n, D]
  dw_gate_up   rowsᵀ · d(gate|up) → f32 [E, D, 2F]
  dw_down      actᵀ · d_out → f32 [E, F, D]

The bound of a launch is the larger of its bytes over the HBM rate and
its operations over the bf16 tensor cores' dense rate (NVIDIA H100 SXM
data sheet).
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
KINDS = ("fwd_gate_up", "fwd_down", "bwd_act", "bwd_x", "dw_gate_up",
         "dw_down")


def work(kind: str, n: int, D: int, F: int, E: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one launch of ``kind`` over ``n`` routed rows."""
    b = 2
    idx = 4 * n
    if kind == "fwd_gate_up":
        return (n * D * b + E * D * 2 * F * b + idx + n * 2 * F * b
                + n * F * b, 2 * n * D * 2 * F)
    if kind == "fwd_down":
        return n * F * b + E * F * D * b + n * D * b, 2 * n * F * D
    if kind == "bwd_act":
        return (n * D * b + E * F * D * b + n * 2 * F * b
                + n * 2 * F * b, 2 * n * D * F)
    if kind == "bwd_x":
        return n * 2 * F * b + E * D * 2 * F * b + n * D * b, \
            2 * n * 2 * F * D
    if kind == "dw_gate_up":
        return (n * D * b + idx + n * 2 * F * b + E * D * 2 * F * 4,
                2 * n * D * 2 * F)
    if kind == "dw_down":
        return n * F * b + n * D * b + E * F * D * 4, 2 * n * F * D
    raise ValueError(kind)


def bound_s(kind: str, n: int, D: int, F: int, E: int) -> float:
    nbytes, flops = work(kind, n, D, F, E)
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)


def layer_bound_s(n: int, m: Dict) -> float:
    """All six launches of one MoE layer's train step at ``n`` rows, for
    the sizes of a configuration file ``m``."""
    return sum(bound_s(k, n, m["hidden_size"], m["moe_intermediate_size"],
                       m["n_routed_experts"]) for k in KINDS)
