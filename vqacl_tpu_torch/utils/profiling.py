"""Profiling / tracing helpers.

Counterpart of ``vqacl_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace (host and, where there is a card, CUDA
activity) of the work inside it and writes it as a Chrome trace, and
``StepTimer`` is a per-step timing meter that syncs every
``sync_every`` steps through a scalar pull.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """Profile the enclosed work with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto); the default
    directory is ``vqacl_trace`` under the temporary directory. Yields
    the profiler (``key_averages()`` for sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vqacl_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step timing with periodic hard syncs."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self.times: List[float] = []
        self._count = 0
        self._t0 = time.perf_counter()

    def step(self, sync_value=None) -> None:
        """Call once per train step; pass a device scalar (e.g. the loss)
        to force execution every ``sync_every`` steps."""
        self._count += 1
        if self._count % self.sync_every == 0:
            if sync_value is not None:
                float(sync_value)
            t1 = time.perf_counter()
            self.times.append((t1 - self._t0) / self.sync_every)
            self._t0 = t1

    @property
    def ms_per_step(self) -> float:
        if not self.times:
            return 0.0
        tail = self.times[max(1, len(self.times) // 2):] or self.times
        return 1e3 * sum(tail) / len(tail)

    def summary(self) -> Dict[str, float]:
        return {"ms_per_step": self.ms_per_step,
                "steps": self._count}
