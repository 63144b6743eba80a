"""Continual-learning result matrix + Avg-Accuracy / Avg-Forgetting
(counterpart of ``vqacl_tpu/cl/metrics.py``).

The reference's ``show_results_matrix`` / ``evaluate_metric``
(``Question_type.py:56-201``), including every quirk of its math:

- matrix cells default to -1 ("not evaluated") and are excluded from the
  incremental averages;
- forgetting at step t for seen task j = max over previous rows of
  column j minus the final row (pre_max == -1 → 0);
- the "6Q" variants restrict to the composition-subset task indices,
  with the reference's ``i_+1 in _6Q_idx`` filter for forgetting
  (``Question_type.py:169-171``) kept as it is.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np

from vqacl_tpu_torch.cl.tasks import ALL_TASKS, COMP_TASK_IDX


class ResultMatrix:
    """results[task_i][task_j] = accuracy on task_j after training task_i."""

    def __init__(self, tasks: Sequence[str] = ALL_TASKS):
        self.tasks = list(tasks)
        self.results: Dict[str, Dict[str, float]] = {
            t: {u: 0.0 for u in self.tasks} for t in self.tasks}
        self._trained: List[str] = []

    def record(self, trained_task: str, eval_task: str, acc: float) -> None:
        self.results[trained_task][eval_task] = float(acc)
        if trained_task not in self._trained:
            self._trained.append(trained_task)

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        return {t: dict(v) for t, v in self.results.items()}

    def show(self, start: int = 0) -> str:
        """Text rendering matching show_results_matrix
        (Question_type.py:56-75): lower triangle filled, row Avg divides
        by the FULL task count (reference quirk)."""
        n = len(self.tasks)
        lines = ["\t".join(self.tasks)]
        mat = self.matrix(start)
        for i in range(start, n):
            row = []
            avg = 0.0
            for j in range(start, n):
                v = mat[i][j] if j < i + 1 and mat[i][j] != -1 else \
                    (mat[i][j] if j < i + 1 else 0.0)
                shown = v if j < i + 1 else 0.0
                if j < i + 1:
                    avg += max(v, 0.0) if v != -1 else 0.0
                row.append(str(round(shown, 2)))
            lines.append("\t".join(row) + f"\tAvg: {round(avg / (n - start), 2)}")
        return "\n".join(lines)

    def matrix(self, start: int = 0) -> np.ndarray:
        n = len(self.tasks)
        mat = np.zeros((n, n)) - 1
        for i in range(start, n):
            for j in range(start, n):
                if j < i + 1:
                    mat[i][j] = self.results[self.tasks[i]][self.tasks[j]]
        return mat


def evaluate_metric(results: Mapping[str, Mapping[str, float]],
                    start: int = 0,
                    comp_idx: Sequence[int] = COMP_TASK_IDX) -> Dict:
    """``evaluate_metric`` (Question_type.py:107-201).

    results: full nested dict (every task key present; untrained cells
    are ignored because only j < i+1 enters the matrix).
    """
    keys = list(results.keys())
    n = len(keys)
    mat = np.zeros((n, n)) - 1
    for i in range(start, n):
        for j in range(start, n):
            if j < i + 1:
                mat[i][j] = results[keys[i]][keys[j]]

    incre_avg_acc, incre_avg_acc_6q = [], []
    for t in range(start, n):
        row = mat[t]
        vals = [a for a in row if a != -1]
        incre_avg_acc.append(sum(vals) / len(vals))
        vals6 = [row[i] for i in range(n) if i in comp_idx and row[i] != -1]
        incre_avg_acc_6q.append(sum(vals6) / len(vals6) if vals6 else -1)

    avg_acc = incre_avg_acc[-1]
    avg_acc_6q = incre_avg_acc_6q[-1]

    incre_avg_forget: List[float] = [0]
    incre_avg_forget_6q: List[float] = [0]
    for t in range(1 + start, n):
        sub = mat[:t + 1, :t + 1]
        t_forget = []
        for idx in range(start, len(sub) - 1):
            prev_max = max(sub[:-1, idx])
            final = sub[-1, idx]
            t_forget.append(0 if prev_max == -1 else prev_max - final)
        incre_avg_forget.append(sum(t_forget) / len(t_forget))
        # reference filter (Question_type.py:169-171): i_+1 in _6Q_idx
        t6 = [f for i_, f in enumerate(t_forget) if i_ + 1 in comp_idx]
        incre_avg_forget_6q.append(sum(t6) / len(t6) if t6 else -1)

    return {
        "Incre_avg_acc": incre_avg_acc,
        "Avg_acc": avg_acc,
        "Incre_avg_forget": incre_avg_forget,
        "Avg_forget": incre_avg_forget[-1],
        "Incre_avg_acc_6Q": incre_avg_acc_6q,
        "Avg_acc_6Q": avg_acc_6q,
        "Incre_avg_forget_6Q": incre_avg_forget_6q,
        "Avg_forget_6Q": incre_avg_forget_6q[-1],
    }
