"""The numbers that decide ``correct``, each held to its own limit.

Training cells (``train_numbers``), from the program's first three steps
and the reference's:
  ``loss``    the largest |L_program − L_reference| / |L_reference| of the
              three steps' losses;
  ``grad1``   over the leaves, the largest gap between the program's and
              the reference's norm of the first clipped gradient, over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
  ``change3`` the same of each leaf's change over the three steps, leaving
              out leaves whose first reference gradient is under a
              thousandth of the median leaf's (they move by round-off
              alone under Adam).
With a control (the reference at a lower precision in the program's
place) each number also gets the control's reading.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np

QUIET = 1e-3


def rel(p: List[float], r: List[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p, r))


def leaf_gap(p: List[float], r: List[float],
             keep: Optional[List[bool]] = None) -> float:
    idx = [i for i in range(len(r)) if keep is None or keep[i]]
    med = statistics.median(r[i] for i in idx)
    return max(abs(p[i] - r[i]) / max(r[i], med, 1e-30) for i in idx)


def moving(grad1_ref: List[float]) -> List[bool]:
    med = statistics.median(grad1_ref)
    return [g >= QUIET * med for g in grad1_ref]


def train_numbers(prog: Dict, ref: Dict, ctl: Optional[Dict] = None
                  ) -> Dict[str, Dict[str, float]]:
    keep = moving(ref["grad1"])

    def numbers(side):
        return {"loss": rel(side["loss"], ref["loss"]),
                "grad1": leaf_gap(side["grad1"], ref["grad1"]),
                "change3": leaf_gap(side["change"], ref["change"], keep)}
    out = {k: {"value": v} for k, v in numbers(prog).items()}
    if ctl is not None:
        for k, v in numbers(ctl).items():
            out[k]["control"] = v
    out["_detail"] = {"ref_loss": ref["loss"], "prog_loss": prog["loss"],
                      "ref_grad_norm": ref["grad_norm"],
                      "quiet_leaves": [p for p, k in zip(ref["paths"], keep)
                                       if not k]}
    return out


def judge(numbers: Dict[str, Dict[str, float]],
          limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} for each number that has a limit."""
    return {k: {"value": v["value"], "limit": float(limits[k])}
            for k, v in numbers.items()
            if not k.startswith("_") and k in limits}
