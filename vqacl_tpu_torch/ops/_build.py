"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), then loaded with ``ctypes``. The library file name
carries a hash of the source, of every shared header ``csrc/*.cuh`` and
of the flags, so an edited source or header is rebuilt and never
mistaken for an old build. ``load(name, csrc=...)`` builds the same
library from another checkout's sources (``chip_smoke.py --base``).
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# C signatures of the entry points, per source file
SIGNATURES = {
    "fused_attention_fwd": {
        # q, k, v, bias, mask, o, B, Tq, Sk, H, dk, L, dtype, stream
        "fused_attention_fwd": ([_P] * 6 + [_I] * 7 + [_P], _I),
        # q, k, v, bias, mask, seed, o, p, B, Tq, Sk, H, dk, L, dtype,
        # dropout, thresh, keep_div, stream
        "fused_attention_fwd_train": ([_P] * 8 + [_I] * 8 + [_U, _F, _P],
                                      _I),
        "fused_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "fused_attention_bwd": {
        # q, k, v, p, seed, do, dq, dk, dv, dbias_part, dbias, B, Tq, Sk,
        # H, dk, L, dtype, dropout, thresh, keep_div, stream
        "fused_attention_bwd": ([_P] * 11 + [_I] * 8 + [_U, _F, _P], _I),
        # seed, out, B*H, Tq, Sk, thresh, stream
        "fused_attention_keep_mask": ([_P] * 2 + [_I] * 3 + [_U, _P], _I),
        "fused_attention_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "dw_splitk": {
        # x, g, out, K, D, F, dtype, stream
        "dw_splitk": ([_P] * 3 + [_I] * 4 + [_P], _I),
        "dw_splitk_error_string": ([_I], ctypes.c_char_p),
    },
}

_libs: Dict[Tuple[str, str], ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str, csrc: Optional[str] = None) -> str:
    """Library path for ``<csrc>/<name>.cu`` (default ``CSRC``), named by
    a hash of the source, every ``<csrc>/*.cuh`` (name and bytes) and the
    flags."""
    csrc = csrc or CSRC
    digest = hashlib.sha256()
    sources = [f"{name}.cu"] + sorted(
        f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for fname in sources:
        with open(os.path.join(csrc, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, csrc: str):
    """Start nvcc for ``name`` unless its library exists; → (path, proc)."""
    out = _lib_path(name, csrc)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(out: str, started) -> None:
    if started is None:
        return
    proc, tmp, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or none


def build(names: Iterable[str] = tuple(SIGNATURES),
          csrc: Optional[str] = None) -> List[str]:
    """Compile the named kernels from ``csrc`` (default ``CSRC``), all nvcc
    processes started together; returns the library paths."""
    names = list(names)
    csrc = csrc or CSRC
    started = [_start(n, csrc) for n in names]
    for out, s in started:
        _finish(out, s)
    return [out for out, _ in started]


def load(name: str, csrc: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for ``<csrc>/<name>.cu`` (default ``CSRC``),
    built on first use, with ``argtypes``/``restype`` set for every entry
    point."""
    csrc = csrc or CSRC
    with _lock:
        lib = _libs.get((csrc, name))
        if lib is None:
            path, = build([name], csrc)
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[(csrc, name)] = lib
        return lib
