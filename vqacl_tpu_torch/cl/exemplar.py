"""Experience-replay exemplar buffer, category-balanced (counterpart of
``vqacl_tpu/cl/exemplar.py``).

The reference's inline exemplar logic (``VL-T5/src/vqacl.py:167-203``,
duplicated as ``Update_memory`` in ``Question_type.py:79-105``):

Entering task t (t ≥ 1) with budget M:
  each_memory          = M // t
  each_memory_for_cate = each_memory // 5
  From the PREVIOUS task's (shuffled) train items, take the first
  ``each_memory_for_cate`` whose image category falls in each group
  G1..G5 and append as that task's slice; then truncate every older
  task's slice to the same per-category quota, so the total stays ≈ M.

The shuffle draws from the caller's ``random.Random`` exactly as the JAX
package does, so the same seed picks the same exemplars. The buffer
keys exemplars by group so the replay loader can serve group-matched
memory batches (get_loader_memory, vqa_data_memory.py:756).
"""

from __future__ import annotations

import random
from typing import Dict, List, Mapping, Sequence

from vqacl_tpu_torch.cl.tasks import CATEGORY_SPLITS


class ExemplarBuffer:
    def __init__(self, m_size: int,
                 splits: Mapping[str, Sequence[int]] = CATEGORY_SPLITS):
        self.M = m_size
        self.splits = {g: set(ids) for g, ids in splits.items()}
        # per group: list of per-task exemplar lists (vqacl.py:141-142)
        self.sets: Dict[str, List[List[dict]]] = {g: [] for g in self.splits}

    def update(self, task_idx: int, prev_task_items: Sequence[dict],
               cate_map: Mapping[str, int], rng: random.Random) -> None:
        """Rebuild quota after finishing task ``task_idx - 1``; call with
        the previous task's raw train items before training task_idx."""
        if task_idx < 1:
            return
        each_memory = self.M // task_idx
        per_cate = each_memory // len(self.splits)
        items = list(prev_task_items)
        rng.shuffle(items)

        for g, ids in self.splits.items():
            # pad missing history (resume from a task: older tasks' slots
            # were built in a previous process; the trainer replays them)
            while len(self.sets[g]) < task_idx - 1:
                self.sets[g].append([])
            slot: List[dict] = []
            self.sets[g].append(slot)
            for d in items:
                img_id = str(d["img_id"])
                c = cate_map.get(img_id)
                if c is not None and int(c) in ids:
                    slot.append(d)
                    if len(slot) >= per_cate:
                        break
        # shrink older tasks to the new per-category quota (vqacl.py:193-195)
        for g in self.splits:
            for i in range(task_idx):
                self.sets[g][i] = self.sets[g][i][:per_cate]

    def all_examplars(self) -> List[dict]:
        out: List[dict] = []
        for g in self.sets:
            for slot in self.sets[g]:
                out.extend(slot)
        return out

    def by_group(self) -> Dict[str, List[dict]]:
        return {g: [d for slot in self.sets[g] for d in slot]
                for g in self.sets}

    def __len__(self) -> int:
        return len(self.all_examplars())
