"""The cell's files, found by name.

``load(cell)`` reads ``workloads/<cell>.json``, the configuration and the
traffic mix it names, and the metrics of ``BENCHMARK.json`` that the cell
reports: an ``end_to_end`` or ``per_layer`` metric is the cell's when its
``workloads`` list names it or when it has no such list.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _read(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def entry(self) -> str:
        return self.workload["entry"]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def limits(self) -> Dict[str, float]:
        return dict(self.workload.get("limits", {}))

    def param(self, key: str, default=None):
        return self.workload.get("params", {}).get(key, default)


def _mine(metric: Dict[str, Any], cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def load(cell: str, benchmark: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell named ``cell``; ``benchmark`` defaults to the root's
    ``BENCHMARK.json``."""
    if benchmark is None:
        benchmark = _read(os.path.join(ROOT, "BENCHMARK.json"))
    workload = _read(os.path.join(HERE, "workloads", f"{cell}.json"))
    config = _read(os.path.join(HERE, "configs",
                                f"{workload['config']}.json"))
    traffic = _read(os.path.join(HERE, "traffic",
                                 f"{workload['traffic']}.json"))
    return Cell(cell, workload, config, traffic,
                [m for m in benchmark["end_to_end"] if _mine(m, cell)],
                [m for m in benchmark["per_layer"] if _mine(m, cell)])
