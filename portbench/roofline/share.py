"""A kernel's share of its roofline over the traced sub-window.

Σ over the op's launches of its least time (``roofline/<op>.py`` from the
shapes) ÷ Σ device time of the kernels attributed to the op
(``kernel_names/*.json``), in %. None when the trace holds no launch of
the op.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

from portbench.trace import kernel_names


def share(rec: Dict, cell, ops: Dict[str, int]) -> Optional[float]:
    """``ops``: op name ("<module>.<kind>") → rows per launch."""
    trace = rec.get("trace")
    if trace is None:
        return None
    names = kernel_names()
    dtype = cell.config["precision"]["compute"]
    bound = spent = 0.0
    for op, batch in ops.items():
        module, kind = op.split(".")
        pats = names.get(op)
        if pats is None:
            continue
        n, t = trace.op_time_s(pats["launch"])
        _, t_also = trace.op_time_s(pats["also"]) if pats["also"] \
            else (0, 0.0)
        roof = importlib.import_module(f"portbench.roofline.{module}")
        bound += n * roof.bound_s(kind, cell.config, batch, dtype)
        spent += t + t_also
    return 100.0 * bound / spent if spent > 0 else None
