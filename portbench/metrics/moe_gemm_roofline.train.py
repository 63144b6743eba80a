"""The grouped expert-GEMM kernels' least time ÷ their device time in
the traced sub-window, in %. The least time is ``roofline/moe_experts.py``
's six launches a MoE layer a step at the rows routed to the held
experts, as the device-side tally of the sub-window counted them (each
layer's rows averaged over its steps); the device time is that of the
kernels ``kernel_names/port_moe.json`` names."""

from portbench.roofline import moe_experts
from portbench.trace import kernel_names


def read(rec, cell):
    trace, rows = rec.get("trace"), rec.get("moe_rows")
    pats = kernel_names().get("moe_experts.train")
    if trace is None or not rows or pats is None:
        return None
    n, spent = trace.op_time_s(pats["launch"])
    if n == 0 or spent <= 0:
        return None
    steps = rec["trace_steps"]
    bound = steps * sum(moe_experts.layer_bound_s(r / steps, cell.config)
                        for r in rows)
    return 100.0 * bound / spent
