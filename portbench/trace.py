"""The device trace of a short sub-window, and what is read from it.

``sub_window`` runs its block under ``torch.profiler`` between two
synchronizes, writes the Chrome trace to the temporary directory and
reads it back. By default it records the device's activity alone
(kernels, copies, fills), which costs the host little, so the block runs
at about the pace of the unprofiled window: ``busy_s``, the union of the
device intervals (overlapping kernels count once), the launches and the
device time of the kernels that match an op's names
(``kernel_names/*.json``) come from such a trace. With ``host=True`` it
also records the host's ops and the benchmark's own labels (``label``:
``record_function`` spans around the calls into the program); that
slows the host's side of a step about twofold, so such a trace only
names what the host was doing at each idle gap (``idle_gaps``), the
innermost host op and the benchmark label around the gap's start.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_names() -> Dict[str, Dict[str, List[str]]]:
    """op → {"launch": patterns of the kernel that counts one launch of
    the op, "also": patterns of further kernels of the same launch},
    merged from every ``kernel_names/*.json``."""
    out: Dict[str, Dict[str, List[str]]] = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernel_names",
                                              "*.json"))):
        with open(path) as f:
            for op, pats in json.load(f)["ops"].items():
                d = out.setdefault(op, {"launch": [], "also": []})
                d["launch"] += pats.get("launch", [])
                d["also"] += pats.get("also", [])
    return out


def label(name: str):
    return torch.profiler.record_function(f"bench.{name}")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    def __init__(self, events: List[dict], wall_s: float):
        self.wall_s = wall_s
        dev, self.kernels, host, labels = [], [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if cat in DEVICE_CATS:
                dev.append(iv)
                if cat == "kernel":
                    self.kernels.append((e["name"], iv))
            elif cat == "cpu_op":
                host.append((iv, e["name"]))
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                labels.append((iv, e["name"][6:]))
        self.busy = _union(dev)
        self.host = sorted(host)
        self.labels = sorted(labels)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def op_time_s(self, patterns: List[str]) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels matching any
        pattern."""
        rx = [re.compile(p) for p in patterns]
        n, t = 0, 0.0
        for name, (s, e) in self.kernels:
            if any(r.search(name) for r in rx):
                n += 1
                t += e - s
        return n, t / 1e6

    @staticmethod
    def _innermost(spans, t: float) -> Optional[str]:
        """The latest-starting span around t (spans nest)."""
        i = bisect.bisect_right(spans, ((t, float("inf")), ""))
        for j in range(i - 1, max(-1, i - 400), -1):
            (s, e), name = spans[j]
            if s <= t <= e:
                return name
        return None

    def device_ops(self, top: int = 10) -> List[list]:
        """The kernels that took most device time: [[name, seconds]]."""
        ops: Dict[str, float] = collections.Counter()
        for name, (s, e) in self.kernels:
            ops[name] += (e - s) / 1e6
        return [[k, v] for k, v in ops.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle gaps summed by what the host was doing at
        each gap's start: [["<label>: <host op>", seconds]]."""
        gaps: Dict[str, float] = collections.Counter()
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            lab = self._innermost(self.labels, e0) or "outside"
            op = self._innermost(self.host, e0) or "idle host"
            gaps[f"{lab}: {op}"] += (s1 - e0) / 1e6
        return [[k, v] for k, v in gaps.most_common(top)]


def breakdown(device: Trace, host: Optional[Trace]) -> Dict[str, list]:
    """The result line's ``breakdown``: the top device ops of the
    device-only trace, the idle gaps of the host trace."""
    return {"device_ops": device.device_ops(),
            "idle_gaps": host.idle_gaps() if host is not None else []}


@contextlib.contextmanager
def sub_window(device, out: Dict, host: bool = False):
    """Profile the block; ``out["trace"]`` holds its ``Trace`` after. On
    a CUDA device the device's activity is recorded, and the host's ops
    only with ``host``; on the CPU the host's ops."""
    cuda = torch.device(device).type == "cuda"
    P = torch.profiler.ProfilerActivity
    acts = ([P.CUDA] + ([P.CPU] if host else [])) if cuda else [P.CPU]
    if cuda:
        torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events, wall)
