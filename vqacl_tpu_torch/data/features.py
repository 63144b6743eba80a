"""Region-feature stores (counterpart of ``vqacl_tpu/data/features.py``).

Interface: ``store.get(img_id) -> (feats f32[N,feat_dim], boxes f32[N,4])``
with boxes already normalized to [0,1]. Implementations:

- ``MemoryFeatureStore``: a plain dict (tests, synthetic data);
- ``H5FeatureStore``: the reference's ``*_obj36.h5`` files (per-image
  groups ``features [36,2048]``, ``boxes [36,4]`` in pixels, ``img_h``,
  ``img_w``), routed by source name as the reference's
  ``img_ids_to_source``, with an LRU host-RAM tier;
- ``write_h5`` / ``subset_h5``: write and subset files in that schema.

``h5py`` is imported only where an h5 file is opened: a machine without
it imports this module and serves from memory or from a pack
(data/packed_cache.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np


def _h5py():
    """``h5py``, or ImportError naming it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5 feature files need the h5py package, which "
                          "is not installed") from e
    return h5py


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


class H5FeatureStore:
    """source-routed h5 reader + LRU RAM cache.

    ``sources``: {source_name: h5_path}; an img_id like
    ``COCO_val2014_000000xxxx`` routes by substring match on the source
    name (matching ``img_ids_to_source`` logic, vqa_data_memory.py:64-78).
    """

    def __init__(self, sources: Mapping[str, str],
                 cache_items: int = 100_000, n_boxes: int = 36):
        self.sources = dict(sources)
        self._files: Dict[str, object] = {}
        self._cache: OrderedDict = OrderedDict()
        self.cache_items = cache_items
        self.n_boxes = n_boxes
        # multi-worker BatchLoader calls get() concurrently: the LRU
        # OrderedDict mutates on every hit and libhdf5 is not built
        # thread-safe — one lock serializes the store while the workers
        # overlap tokenize/collate with each other's feature reads
        self._lock = threading.Lock()

    def _file(self, source: str):
        if source not in self._files:
            self._files[source] = _h5py().File(self.sources[source], "r")
        return self._files[source]

    def _route(self, img_id: str) -> str:
        for source in self.sources:
            if source in img_id:
                return source
        # single-source stores route everything to it
        if len(self.sources) == 1:
            return next(iter(self.sources))
        raise KeyError(f"cannot route {img_id} to a feature source")

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            hit = self._cache.get(img_id)
            if hit is not None:
                self._cache.move_to_end(img_id)
                return hit
            f = self._file(self._route(img_id))
            g = f[img_id]
            feats = np.asarray(g["features"], np.float32)
            boxes = np.asarray(g["boxes"], np.float32)
            img_h = float(np.asarray(g["img_h"]))
            img_w = float(np.asarray(g["img_w"]))
            boxes[:, (0, 2)] /= img_w
            boxes[:, (1, 3)] /= img_h
            boxes = np.clip(boxes, 0.0, 1.0)
            out = (feats, boxes)
            self._cache[img_id] = out
            if len(self._cache) > self.cache_items:
                self._cache.popitem(last=False)
            return out

    def __contains__(self, img_id: str) -> bool:
        try:
            return img_id in self._file(self._route(img_id))
        except KeyError:
            return False


def write_h5(path: str, records: Iterable[Tuple[str, dict]]) -> None:
    """Write reference-schema features (tsv_to_h5.py:77-93): per-image
    group with features/boxes/img_h/img_w (+ optional obj/attr arrays).
    Boxes are stored in PIXELS (x1,y1,x2,y2)."""
    with _h5py().File(path, "w") as f:
        for img_id, rec in records:
            g = f.create_group(img_id)
            g["features"] = np.asarray(rec["features"], np.float32)
            g["boxes"] = np.asarray(rec["boxes"], np.float32)
            g["img_h"] = np.int64(rec["img_h"])
            g["img_w"] = np.int64(rec["img_w"])
            for k in ("obj_id", "obj_conf", "attr_id", "attr_conf"):
                if k in rec:
                    g[k] = np.asarray(rec[k])


def subset_h5(src_path: str, dst_path: str, img_ids) -> int:
    """Copy the named image groups from one feature h5 into a new one.

    Port of ``feature_extraction/coco_val_compact.py`` (subset
    ``val2014_obj36.h5`` to the LXMERT resplit-val ids). ``img_ids`` may
    be an iterable of ids or of dicts with an ``img_id`` key (the
    ``mscoco_resplit_val.json`` record shape). Returns groups copied;
    ids absent from the source are skipped."""
    h5py = _h5py()
    n = 0
    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        for item in img_ids:
            img_id = item["img_id"] if isinstance(item, dict) else str(item)
            if img_id not in src:
                continue
            grp = dst.create_group(img_id)
            for k in src[img_id]:
                grp[k] = src[f"{img_id}/{k}"][()]
            n += 1
    return n
