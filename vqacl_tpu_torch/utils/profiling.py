"""Profiling / tracing: the program's span and counter recorder, its
clock shared with ``torch.profiler``, and the Chrome trace exporter.

``span(name)`` marks a piece of host work where it happens (the train
step's phases, the loader's blocking wait); ``count(name, n)`` adds to a
counter (``h2d_bytes``; ``optim.fused_leaves`` and
``optim.eager_leaves``, the leaves each route of ``ops/adamw.py``
updated; ``graph.captures``, ``graph.replays`` and
``graph.eager_steps``, how the train step of ``train/graph.py`` ran).
Both are off by default: ``span`` then returns one shared
no-op context after a single flag test, and ``count`` returns at once.
When ``enable()`` has switched them on, a span appends ``(name, id,
parent id, start_ns, end_ns)`` to an in-memory list on
``time.perf_counter_ns()``, its parent the innermost open span of the
same thread. A span never
touches the device: no CUDA events, no synchronisation, no launches.
``take()`` hands over what was recorded and clears it. Inside
``diverted()`` (a CUDA-graph capture, which launches nothing) spans
record nothing and every ``count`` goes to the dict it yields, recorder
on or off, so that each replay can count what the captured work counted.

The profiler's Chrome trace gives each event's ``ts`` in µs after its
top-level ``baseTimeNanoseconds``, on the wall clock. ``enable`` keeps one
anchor pair ``(perf_counter_ns, time_ns)``, so ``profiler_us`` puts a span
on that timeline, and ``attribute`` assigns each kernel of a trace to the
span that was innermost when its launch call was made (by correlation id
from the ``cuda_runtime`` / ``cuda_driver`` events: by time, not by
thread, since the backward's launches come from the autograd engine's
device thread while the step's thread sits in ``step.backward``) and
each idle gap of the device to the spans it falls in.

``trace`` is the operator's exporter: it records a ``torch.profiler``
trace (host and, where there is a card, CUDA activity) of the work inside
it with the recorder on, and writes both as one Chrome trace, the spans
as complete events of category ``program_span``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"

# (name, id, parent id or 0, start_ns, end_ns) on time.perf_counter_ns()
Span = Tuple[str, int, int, int, int]


class Taken(NamedTuple):
    """What ``take`` hands over: the closed spans in the order they
    closed, the counters, and the anchor ``(perf_counter_ns, time_ns)``
    read together when the recorder was switched on."""
    spans: List[Span]
    counters: Dict[str, int]
    anchor: Tuple[int, int]


_on = False
_NOOP = contextlib.nullcontext()
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_anchor = (0, 0)
_divert: Optional[Dict[str, int]] = None


class _Span:
    __slots__ = ("name", "id", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        _spans.append((self.name, self.id, self.parent, self.start, end))
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` when
    the recorder is on; the shared no-op context when it is off or
    diverted."""
    if not _on or _divert is not None:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` when the recorder is on (to
    the diverted dict inside ``diverted``)."""
    if not _on and _divert is None:
        return
    with _count_lock:
        into = _counters if _divert is None else _divert
        into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def diverted() -> Iterator[Dict[str, int]]:
    """Within the block no span is recorded and ``count`` adds to the dict
    yielded, whether the recorder is on or not."""
    global _divert
    _divert = {}
    try:
        yield _divert
    finally:
        _divert = None


def recording() -> bool:
    """Whether the recorder is on."""
    return _on


def enable(on: bool = True) -> None:
    """Switches the recorder on (reading the anchor pair) or off. What
    was recorded stays until ``take``."""
    global _on, _anchor
    if on and not _on:
        _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = bool(on)


def take() -> Taken:
    """The spans and counters recorded so far (cleared), with the
    anchor."""
    global _spans, _counters
    with _count_lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return Taken(spans, counters, _anchor)


def profiler_us(t_ns: int, anchor: Tuple[int, int], base_ns: int) -> float:
    """A ``perf_counter_ns`` time on a Chrome trace's timeline: µs after
    the trace's ``baseTimeNanoseconds``."""
    return (t_ns - anchor[0] + anchor[1] - base_ns) / 1000.0


def self_ns(spans: List[Span]) -> Dict[str, int]:
    """Each span name's total self time: its spans' durations less their
    children's."""
    out: Dict[str, int] = collections.Counter()
    for name, _, parent, s, e in spans:
        out[name] += e - s
    names = {sid: name for name, sid, _, _, _ in spans}
    for _, _, parent, s, e in spans:
        if parent in names:
            out[names[parent]] -= e - s
    return dict(out)


class Segments:
    """A timeline (µs) cut where the innermost span changes: the span
    that started last among those open at each time. ``at(t)`` is its
    name, or ``OUTSIDE``."""

    def __init__(self, spans: List[Span], anchor: Tuple[int, int],
                 base_ns: int):
        iv = sorted(((profiler_us(s, anchor, base_ns),
                      profiler_us(e, anchor, base_ns), name)
                     for name, _, _, s, e in spans),
                    key=lambda x: (x[0], -x[1]))
        self.segs: List[Tuple[float, float, str]] = []
        stack: List[Tuple[float, str]] = []
        cur = 0.0
        for s, e, name in iv:
            while stack and stack[-1][0] <= s:
                cur = self._close(stack, cur)
            if stack and s > cur:
                self.segs.append((cur, s, stack[-1][1]))
            stack.append((e, name))
            cur = s
        while stack:
            cur = self._close(stack, cur)
        self.starts = [s for s, _, _ in self.segs]

    def _close(self, stack, cur: float) -> float:
        end, name = stack.pop()
        if end > cur:
            self.segs.append((cur, end, name))
            return end
        return cur

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.segs[i][0] <= t < self.segs[i][1]:
            return self.segs[i][2]
        return OUTSIDE

    def split(self, t0: float, t1: float) -> Dict[str, float]:
        """The interval [t0, t1) by name: its overlap with each segment,
        the rest under ``OUTSIDE``."""
        out: Dict[str, float] = collections.Counter()
        covered = 0.0
        i = max(bisect.bisect_right(self.starts, t0) - 1, 0)
        while i < len(self.segs) and self.segs[i][0] < t1:
            s, e, name = self.segs[i]
            d = min(e, t1) - max(s, t0)
            if d > 0:
                out[name] += d
                covered += d
            i += 1
        if t1 - t0 > covered:
            out[OUTSIDE] += t1 - t0 - covered
        return dict(out)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def attribute(trace: Dict, spans: List[Span], anchor: Tuple[int, int]
              ) -> Dict:
    """A Chrome trace (``export_chrome_trace``'s JSON: ``traceEvents``,
    ``baseTimeNanoseconds``) against the spans recorded over it →
    ``{"launches": {name: kernels}, "idle_s": {name: seconds},
    "device_s": {name: seconds of its kernels on the device},
    "kernels": {name: {kernel: launches}}, "no_launch_call": n}``. Each
    kernel goes to the span innermost at its launch call, or to
    ``OUTSIDE``, as does a kernel whose launch call the trace lacks
    (``no_launch_call`` counts those); each gap between the device's
    busy intervals (the union of kernels, copies and fills) is split
    over the spans it overlaps."""
    events = trace["traceEvents"]
    segs = Segments(spans, anchor, int(trace.get("baseTimeNanoseconds", 0)))
    calls: Dict[int, float] = {}
    kernels, busy = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            calls[corr] = float(e["ts"])
        elif cat in DEVICE_CATS and "dur" in e:
            s = float(e["ts"])
            busy.append((s, s + float(e["dur"])))
            if cat == "kernel":
                kernels.append((e["name"], corr, float(e["dur"])))
    launches: Dict[str, int] = collections.Counter()
    device: Dict[str, float] = collections.Counter()
    by_kernel: Dict[str, Dict[str, int]] = collections.defaultdict(
        collections.Counter)
    missing = 0
    for name, corr, dur in kernels:
        t = calls.get(corr)
        where = OUTSIDE if t is None else segs.at(t)
        missing += t is None
        launches[where] += 1
        device[where] += dur / 1e6
        by_kernel[where][name] += 1
    idle: Dict[str, float] = collections.Counter()
    busy = _union(busy)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        for name, us in segs.split(e0, s1).items():
            idle[name] += us / 1e6
    return {"launches": dict(launches), "idle_s": dict(idle),
            "device_s": dict(device),
            "kernels": {k: dict(v) for k, v in by_kernel.items()},
            "no_launch_call": missing}


def span_events(taken: Taken, base_ns: int, pid: int = 0) -> List[Dict]:
    """The spans as Chrome trace complete events (category
    ``program_span``) on a trace's timeline, on one named track."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for name, sid, parent, s, e in taken.spans:
        out.append({"ph": "X", "cat": "program_span", "name": name,
                    "pid": pid, "tid": 0,
                    "ts": profiler_us(s, taken.anchor, base_ns),
                    "dur": (e - s) / 1000.0,
                    "args": {"id": sid, "parent": parent}})
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """Profile the enclosed work with ``torch.profiler`` and the span
    recorder and write ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto): the profiler's events and the program's spans on the same
    clock, and the counters in ``programCounters``. The default directory
    is ``vqacl_trace`` under the temporary directory. Yields the profiler
    (``key_averages()`` for sums by kernel); the recorder is switched off
    after, and what it recorded in the block goes to the file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vqacl_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    take()
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        enable(False)
    taken = take()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += span_events(
        taken, int(doc.get("baseTimeNanoseconds", 0)), os.getpid())
    doc["programCounters"] = taken.counters
    with open(path, "w") as f:
        json.dump(doc, f)
