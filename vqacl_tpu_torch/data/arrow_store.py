"""Arrow-format feature store (reference ``inference/extracting_data.py``;
counterpart of ``vqacl_tpu/data/arrow_store.py``).

The reference's third extraction output format (besides tsv→h5 and the
native ``.vfpack``) is an Apache Arrow file with the schema of
``extracting_data.py:27-41`` — fixed-size detection tensors per image,
integer ``img_id`` parsed from the COCO/VQA filename, ``sizes`` [h, w]
and ``preds_per_image``. This module writes and reads that schema with
pyarrow directly (one stream pass each way, no torch/datasets
dependency) and exposes the read side through the same ``get(img_id) ->
(features, boxes)`` protocol as the h5/pack stores so the whole data
stack can run off an Arrow file.
"""

from __future__ import annotations

import importlib.util
import os
import re
import zlib
from typing import Dict, Iterable, Tuple

import numpy as np

# pyarrow is optional (the card's machine has none): it is imported only
# by the functions that read or write Arrow files
HAVE_ARROW = importlib.util.find_spec("pyarrow") is not None


def _pa():
    if not HAVE_ARROW:
        raise ImportError("pyarrow unavailable: Arrow feature files need it")
    import pyarrow

    return pyarrow


def parse_img_id(img_id) -> int:
    """Filename → int id, reference semantics (``_vqa_file_split``:
    trailing ``_``-separated digits of the stem)."""
    if isinstance(img_id, (int, np.integer)):
        return int(img_id)
    stem = os.path.basename(str(img_id)).split(".")[0]
    tail = stem.split("_")[-1]
    m = re.search(r"\d+", tail)
    if m:
        return int(m.group(0))
    # no digits: deterministic 31-bit hash (crc32 — Python's hash() is
    # salted per process, so a writer/reader pair would disagree)
    return zlib.crc32(stem.encode()) & 0x7FFFFFFF


def arrow_schema(n_boxes: int, feat_dim: int = 2048) -> "pa.Schema":
    pa = _pa()
    f32 = pa.float32()
    return pa.schema([
        ("attr_ids", pa.list_(f32, n_boxes)),
        ("attr_probs", pa.list_(f32, n_boxes)),
        ("boxes", pa.list_(pa.list_(f32, 4), n_boxes)),
        ("img_id", pa.int32()),
        ("obj_ids", pa.list_(f32, n_boxes)),
        ("obj_probs", pa.list_(f32, n_boxes)),
        ("roi_features", pa.list_(pa.list_(f32, feat_dim), n_boxes)),
        ("sizes", pa.list_(f32, 2)),
        ("preds_per_image", pa.int32()),
    ])


def write_arrow(path: str, records: Iterable[Tuple[str, Dict]],
                n_boxes: int = 36, feat_dim: int = 2048,
                batch_rows: int = 64) -> int:
    """records: (img_id, rec) with rec keys features [N,2048], boxes
    [N,4], img_h, img_w, optional obj_id/obj_conf/attr_id/attr_conf
    (the extract CLI's record shape). Returns rows written."""
    pa = _pa()
    schema = arrow_schema(n_boxes, feat_dim)
    sink = pa.OSFile(path, "wb")
    writer = pa.ipc.new_file(sink, schema)
    buf = []
    n = 0

    def flush():
        nonlocal buf
        if not buf:
            return
        cols = {k: [r[k] for r in buf] for k in schema.names}
        writer.write_batch(pa.record_batch(
            [pa.array(cols[k], type=schema.field(k).type)
             for k in schema.names], schema=schema))
        buf = []

    for img_id, rec in records:
        feats = np.asarray(rec["features"], np.float32)[:n_boxes]
        boxes = np.asarray(rec["boxes"], np.float32)[:n_boxes]
        k = feats.shape[0]
        zeros = np.zeros((n_boxes,), np.float32)

        def vec(key):
            v = rec.get(key)
            if v is None:
                return zeros.tolist()
            v = np.asarray(v, np.float32)[:n_boxes]
            return np.pad(v, (0, n_boxes - v.shape[0])).tolist()

        if k < n_boxes:
            feats = np.pad(feats, ((0, n_boxes - k), (0, 0)))
            boxes = np.pad(boxes, ((0, n_boxes - k), (0, 0)))
        buf.append({
            "attr_ids": vec("attr_id"),
            "attr_probs": vec("attr_conf"),
            "boxes": boxes.tolist(),
            "img_id": parse_img_id(img_id),
            "obj_ids": vec("obj_id"),
            "obj_probs": vec("obj_conf"),
            "roi_features": feats.tolist(),
            "sizes": [float(rec.get("img_h", 0)), float(rec.get("img_w", 0))],
            "preds_per_image": int(k),
        })
        n += 1
        if len(buf) >= batch_rows:
            flush()
    flush()
    writer.close()
    sink.close()
    return n


class ArrowFeatureStore:
    """Read side: same ``get`` protocol as the h5/pack stores
    (data/features.py) so loaders/caches can consume Arrow files."""

    def __init__(self, path: str):
        pa = _pa()
        with pa.OSFile(path, "rb") as f:
            table = pa.ipc.open_file(f).read_all()
        ids = table.column("img_id").to_numpy()
        feats = table.column("roi_features").to_pylist()
        boxes = table.column("boxes").to_pylist()
        sizes = table.column("sizes").to_pylist()
        self._rows = {}
        for i, img in enumerate(ids):
            self._rows[int(img)] = (
                np.asarray(feats[i], np.float32),
                np.asarray(boxes[i], np.float32),
                sizes[i])

    def __len__(self) -> int:
        return len(self._rows)

    def keys(self):
        return self._rows.keys()

    def get(self, img_id) -> Tuple[np.ndarray, np.ndarray]:
        f, b, _ = self._rows[parse_img_id(img_id)]
        return f, b

    def get_with_size(self, img_id):
        return self._rows[parse_img_id(img_id)]
