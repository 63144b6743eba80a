"""Packed feature store: a flat memory-mapped pack of region features
read by host C++ (counterpart of ``vqacl_tpu/data/packed_cache.py``).

``native/feature_cache.cpp`` (a copy of the JAX package's, not a GPU
kernel) maps the pack and gathers a batch with several threads, box
normalization fused in. h5 files convert once with ``pack_from_h5``;
the store then serves batches with no per-item Python work. The pack
format and the ``fnv1a`` name hash are the JAX package's, so a pack
written by either package reads in the other.

The library is built with ``g++`` at first use, never at import, into
``build/native/`` at the root of the checkout (gitignored), named by a
hash of its source and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0x56514143_4C504B31
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "feature_cache.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
# portable flags (no -march=native): the gather is memcpy-bound, and a
# library built on one host then runs on any x86-64 host
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _lib_path() -> str:
    """``build/native/libvfcache-<hash>.so``, the hash over the source
    and the flags."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libvfcache-{digest.hexdigest()[:16]}.so")


def _build_lib() -> str:
    out = _lib_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            lib.vf_hash.restype = ctypes.c_uint64
            lib.vf_hash.argtypes = [ctypes.c_char_p]
            lib.vf_open.restype = ctypes.c_void_p
            lib.vf_open.argtypes = [ctypes.c_char_p]
            lib.vf_close.restype = None
            lib.vf_close.argtypes = [ctypes.c_void_p]
            for f in ("vf_n_images", "vf_n_boxes", "vf_feat_dim"):
                getattr(lib, f).restype = ctypes.c_uint32
                getattr(lib, f).argtypes = [ctypes.c_void_p]
            lib.vf_find.restype = ctypes.c_int64
            lib.vf_find.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.vf_gather.restype = None
            lib.vf_gather.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _LIB = lib
        return _LIB


def fnv1a(s: str) -> int:
    """64-bit FNV-1a of the UTF-8 bytes: the pack's image-id hash."""
    h = 1469598103934665603
    for ch in s.encode():
        h ^= ch
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def write_pack(path: str,
               records: Iterable[Tuple[str, np.ndarray, np.ndarray,
                                       float, float]],
               n_boxes: int = 36, feat_dim: int = 2048) -> None:
    """records: (img_id, features [n_boxes,feat_dim] f32,
    boxes_pixels [n_boxes,4] f32, img_h, img_w)."""
    entries: List[Tuple[int, bytes]] = []
    hw: List[Tuple[float, float]] = []
    seen: Dict[int, str] = {}
    for img_id, feats, boxes, img_h, img_w in records:
        h = fnv1a(img_id)
        if h in seen and seen[h] != img_id:
            raise ValueError(f"hash collision: {img_id} vs {seen[h]}")
        seen[h] = img_id
        feats = np.ascontiguousarray(feats, np.float32)
        boxes = np.ascontiguousarray(boxes, np.float32)
        if feats.shape != (n_boxes, feat_dim) or boxes.shape != (n_boxes, 4):
            raise ValueError(f"{img_id}: features {feats.shape} and boxes "
                             f"{boxes.shape}, expected ({n_boxes}, "
                             f"{feat_dim}) and ({n_boxes}, 4)")
        entries.append((h, feats.tobytes() + boxes.tobytes()))
        hw.append((float(img_h), float(img_w)))

    order = np.argsort([e[0] for e in entries], kind="stable")
    header = struct.pack("<QIIII", MAGIC, 1, len(entries), n_boxes, feat_dim)
    offset = len(header) + 24 * len(entries)
    with open(path, "wb") as f:
        f.write(header)
        for i in order:
            h, blob = entries[i]
            f.write(struct.pack("<QQff", h, offset, hw[i][0], hw[i][1]))
            offset += len(blob)
        for i in order:
            f.write(entries[i][1])


def pack_from_h5(h5_paths: Sequence[str], out_path: str,
                 n_boxes: int = 36, feat_dim: int = 2048) -> int:
    """Convert reference ``*_obj36.h5`` file(s) into one pack → count."""
    from vqacl_tpu_torch.data.features import _h5py

    h5py = _h5py()
    n = 0

    def records():
        nonlocal n
        for hp in h5_paths:
            with h5py.File(hp, "r") as f:
                for img_id in f.keys():
                    g = f[img_id]
                    n += 1
                    yield (img_id, np.asarray(g["features"], np.float32),
                           np.asarray(g["boxes"], np.float32),
                           float(np.asarray(g["img_h"])),
                           float(np.asarray(g["img_w"])))

    write_pack(out_path, records(), n_boxes=n_boxes, feat_dim=feat_dim)
    return n


class PackedFeatureStore:
    """The feature-store interface over a pack (in place of
    ``H5FeatureStore``), plus ``get_batch`` for whole batches."""

    def __init__(self, path: str, n_threads: int = 8):
        self._lib = _lib()
        self._h = self._lib.vf_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open pack {path}")
        self.n_boxes = self._lib.vf_n_boxes(self._h)
        self.feat_dim = self._lib.vf_feat_dim(self._h)
        self.n_images = self._lib.vf_n_images(self._h)
        self.n_threads = n_threads
        self._slot_cache: Dict[str, int] = {}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vf_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def slot(self, img_id: str) -> int:
        """The image's row in the pack, −1 if absent."""
        s = self._slot_cache.get(img_id)
        if s is None:
            s = self._lib.vf_find(self._h, fnv1a(img_id))
            self._slot_cache[img_id] = s
        return s

    def __contains__(self, img_id: str) -> bool:
        return self.slot(img_id) >= 0

    def get_batch(self, img_ids: Sequence[str]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (feats [n, n_boxes, feat_dim], boxes [n, n_boxes, 4]
        normalized and clipped to [0,1]), gathered by the native threads;
        an absent id gives zeros."""
        n = len(img_ids)
        slots = np.asarray([self.slot(i) for i in img_ids], np.int64)
        feats = np.empty((n, self.n_boxes, self.feat_dim), np.float32)
        boxes = np.empty((n, self.n_boxes, 4), np.float32)
        self._lib.vf_gather(
            self._h, slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)
        return feats, boxes

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.slot(img_id) < 0:
            raise KeyError(img_id)
        feats, boxes = self.get_batch([img_id])
        return feats[0], boxes[0]
