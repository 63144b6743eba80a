"""VQACL benchmark protocol: the dual-level task structure (counterpart
of ``vqacl_tpu/cl/tasks.py``).

The reference's ``Question_type.py:7-24`` and ``nextqa/Question_type.py:5-33``:
the outer linguistic task sequences, the inner visual category-group
splits, and the seeded shuffle used for the random visual-subtask order.

The reference seeds python's global ``random`` at import (seed 66666,
``Question_type.py:2-4``), which fixes the exemplar and group shuffles;
here randomness is explicit: callers pass a ``random.Random(seed)`` or use
``make_rng``. The draws are those of the JAX package for the same seed.
"""

from __future__ import annotations

import random
from typing import Dict, List

SEED = 66666

# 10 linguistic-driven tasks for VQA v2 (Question_type.py:16)
ALL_TASKS: List[str] = [
    "q_recognition", "q_location", "q_judge", "q_commonsense", "q_count",
    "q_action", "q_color", "q_type", "q_subcategory", "q_causal",
]

# novel-composition evaluation subset (Question_type.py:17)
COMP_TASKS: List[str] = [
    "q_location", "q_count", "q_action", "q_color", "q_type", "q_subcategory",
]

# visual-driven subtasks: 5 groups × 16 COCO category ids
# (Question_type.py:20-24)
CATEGORY_SPLITS: Dict[str, List[int]] = {
    "G1": [58, 48, 55, 36, 64, 1, 70, 73, 42, 15, 6, 18, 49, 59, 31, 2],
    "G2": [19, 77, 22, 9, 24, 53, 12, 13, 78, 50, 47, 41, 32, 28, 54, 23],
    "G3": [60, 8, 34, 25, 67, 4, 14, 68, 3, 79, 0, 5, 65, 20, 71, 39],
    "G4": [35, 29, 66, 40, 43, 26, 72, 10, 38, 61, 76, 44, 75, 69, 16, 57],
    "G5": [45, 33, 63, 56, 21, 11, 62, 74, 17, 52, 46, 30, 27, 51, 37, 7],
}

# indices of the composition subset inside ALL_TASKS (Question_type.py:38-46)
COMP_TASK_IDX: List[int] = [ALL_TASKS.index(t) for t in COMP_TASKS]

# --- NExT-QA (nextqa/Question_type.py:5-15) ---
NEXTQA_SEED = 6666
NEXTQA_TASKS: List[str] = ["CW", "TN", "TC", "DL", "DB", "DC", "DO", "CH"]
NEXTQA_GROUPS: List[str] = ["G0", "G1", "G2", "G3", "G4"]


def make_rng(seed: int = SEED) -> random.Random:
    return random.Random(seed)


def random_dic(d: Dict, rng: random.Random) -> Dict:
    """Seeded key shuffle (Question_type.py:7-13): the visual-subtask
    order inside each linguistic task (vqacl.py:314)."""
    keys = list(d.keys())
    rng.shuffle(keys)
    return {k: d[k] for k in keys}


def category_to_group(cate_id: int,
                      splits: Dict[str, List[int]] = CATEGORY_SPLITS) -> str:
    for g, ids in splits.items():
        if cate_id in ids:
            return g
    raise KeyError(cate_id)
