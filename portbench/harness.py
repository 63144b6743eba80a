"""One run of one cell: set-up, the window, the traced sub-window, the
check, and the result line.

``main`` is what ``run.py`` calls. The run refuses (exit 2, no result)
without CUDA or with fewer cards than the cell asks for, and (exit 3)
when ``jax``, ``jaxlib``, ``flax`` or ``vqacl_tpu`` is loaded once the
window has closed; a run whose program raises exits 1. With ``--trace
0`` the metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, each read by ``metrics/<name>.py`` from the run's
record (``read(rec, cell)`` → a number, or None when there is nothing to
read, and the metric is then left out).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "vqacl_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics, rec: Dict, cell) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"])(rec, cell)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device, chips: int, peak: Optional[int]) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak or 0)}


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, precision: Optional[str] = None) -> Dict:
    """Runs the cell; → {rec, numbers, peak}. ``precision`` also runs the
    control (the reference at that precision) in the check."""
    import torch
    entry = importlib.import_module(f"portbench.entries.{cell.entry}")
    run = entry.Run(cell, seed, device)
    run.setup()
    rec = run.rec
    rec["setup_s"] = time.perf_counter() - t_start
    run.window(seconds)
    if trace:
        run.trace()
    rec["forbidden"] = forbidden_modules()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    run.release()
    t0 = time.perf_counter()
    numbers = run.check(precision)
    rec["check_s"] = time.perf_counter() - t0
    return {"rec": rec, "numbers": numbers, "peak": peak}


def verdict(numbers: Dict, limits: Dict, rec: Dict):
    """(correct, {name: {value, limit}}): every compared number within
    its limit, at least one compared, and no attempt failed."""
    from portbench import check
    judged = check.judge(numbers, limits)
    ok = bool(judged) and all(v["value"] <= v["limit"]
                              for v in judged.values()) \
        and rec.get("failed", 0) == 0
    return ok, judged


def control_verdict(numbers: Dict, limits: Dict):
    """``verdict`` of the control's readings (the reference at the lower
    precision in the program's place) against the same limits."""
    return verdict({k: {"value": v["control"]} for k, v in numbers.items()
                    if not k.startswith("_") and "control" in v}, limits, {})


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start)
    rec = out["rec"]
    if rec["forbidden"]:
        print(f"portbench: loaded after the window: {rec['forbidden']}",
              file=sys.stderr)
        return 3
    correct, judged = verdict(out["numbers"], cell.limits, rec)
    diag = {"setup_parts": rec.get("setup_parts"), "check_s": rec["check_s"],
            "host": rec.get("host"), "numbers": out["numbers"]}
    if args.trace and rec.get("steps"):
        # the device-only profile's time per step over the window's
        diag["trace_pace"] = (rec["trace"].wall_s / rec["trace_steps"]) / (
            rec["window_s"] / rec["steps"])
    print("portbench: " + json.dumps(diag, default=str), file=sys.stderr)
    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end,
                           rec, cell)
    dev = device_info(device, cell.chips, out["peak"])
    line = {"correct": correct, "attempted": int(rec.get("attempted", 0)),
            "failed": int(rec.get("failed", 0)), "metrics": metrics,
            "device": dev}
    if args.trace:
        from portbench import trace
        t = rec["trace"]
        dev.update(busy_s=t.busy_s, window_s=t.wall_s)
        line["breakdown"] = trace.breakdown(t, rec.get("host_trace"))
    line["checks"] = judged
    for k, v in judged.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
