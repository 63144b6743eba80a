"""LXMERT tsv → h5/pack converter (counterpart of
``vqacl_tpu/data/tsv_convert.py``).

Rebuild of feature_extraction/tsv_to_h5.py:18-93: the
publicly distributed COCO features come as LXMERT-style tsv rows with
base64-encoded arrays; this reads them and writes either the reference
h5 schema (needs ``h5py``) or the native pack (needs only numpy).
"""

from __future__ import annotations

import base64
import csv
import sys
from typing import Dict, Iterator, Sequence

import numpy as np

FIELDNAMES = ["img_id", "img_h", "img_w", "objects_id", "objects_conf",
              "attrs_id", "attrs_conf", "num_boxes", "boxes", "features"]


def load_obj_tsv(path: str, topk: int | None = None) -> Iterator[Dict]:
    """Yield decoded rows (tsv_to_h5.py:18-56 semantics)."""
    csv.field_size_limit(sys.maxsize)
    with open(path) as f:
        reader = csv.DictReader(f, FIELDNAMES, delimiter="\t")
        for i, item in enumerate(reader):
            if topk is not None and i >= topk:
                break
            n = int(item["num_boxes"])
            decode = {
                "objects_id": (np.int64, (n,)),
                "objects_conf": (np.float32, (n,)),
                "attrs_id": (np.int64, (n,)),
                "attrs_conf": (np.float32, (n,)),
                "boxes": (np.float32, (n, 4)),
                "features": (np.float32, (n, -1)),
            }
            out = {"img_id": item["img_id"], "img_h": int(item["img_h"]),
                   "img_w": int(item["img_w"]), "num_boxes": n}
            for key, (dt, shape) in decode.items():
                out[key] = np.frombuffer(
                    base64.b64decode(item[key]), dtype=dt).reshape(shape)
            yield out


def tsv_to_h5(tsv_paths: Sequence[str], out_path: str,
              topk: int | None = None) -> int:
    """Write the reference per-image-group h5 (tsv_to_h5.py:77-93)."""
    from vqacl_tpu_torch.data.features import write_h5

    n = 0

    def records():
        nonlocal n
        for path in tsv_paths:
            for row in load_obj_tsv(path, topk):
                n += 1
                yield row["img_id"], {
                    "features": row["features"],
                    "boxes": row["boxes"],
                    "img_h": row["img_h"], "img_w": row["img_w"],
                    "obj_id": row["objects_id"],
                    "obj_conf": row["objects_conf"],
                    "attr_id": row["attrs_id"],
                    "attr_conf": row["attrs_conf"],
                }

    write_h5(out_path, records())
    return n


def tsv_to_pack(tsv_paths: Sequence[str], out_path: str,
                topk: int | None = None, n_boxes: int = 36,
                feat_dim: int = 2048) -> int:
    from vqacl_tpu_torch.data.packed_cache import write_pack

    n = 0

    def records():
        nonlocal n
        for path in tsv_paths:
            for row in load_obj_tsv(path, topk):
                n += 1
                yield (row["img_id"], row["features"], row["boxes"],
                       float(row["img_h"]), float(row["img_w"]))

    write_pack(out_path, records(), n_boxes=n_boxes, feat_dim=feat_dim)
    return n
