"""Region-feature store (counterpart of ``vqacl_tpu/data/features.py``).

Interface: ``store.get(img_id) -> (feats f32[N,feat_dim], boxes f32[N,4])``
with boxes already normalized to [0,1]. Only the in-memory store is
ported so far; the h5-backed store comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class MemoryFeatureStore:
    def __init__(self, table: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None):
        self.table = table or {}

    def put(self, img_id: str, feats: np.ndarray, boxes: np.ndarray) -> None:
        self.table[img_id] = (np.asarray(feats, np.float32),
                              np.asarray(boxes, np.float32))

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        return self.table[img_id]

    def __contains__(self, img_id: str) -> bool:
        return img_id in self.table
