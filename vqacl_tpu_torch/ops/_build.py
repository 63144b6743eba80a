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
        # dropout, thresh, keep_div, stream, bh0, Hc, h0 (last, so that an
        # older library without them still lines up: ``chip_smoke.py
        # --base``)
        "fused_attention_fwd_train": ([_P] * 8 + [_I] * 8
                                      + [_U, _F, _P, _I, _I, _I], _I),
        # as fused_attention_fwd, with ldq, ldk, ldv before dtype
        "fused_attention_fwd_strided": ([_P] * 6 + [_I] * 10 + [_P], _I),
        # as fused_attention_fwd_train, with ldq, ldk, ldv before dtype
        "fused_attention_fwd_train_strided": ([_P] * 8 + [_I] * 11
                                              + [_U, _F, _P, _I, _I, _I],
                                              _I),
        "fused_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "fused_attention_bwd": {
        # q, k, v, p, seed, do, dq, dk, dv, dbias_part, dbias, B, Tq, Sk,
        # H, dk, L, dtype, dropout, thresh, keep_div, stream, bh0, Hc, h0
        "fused_attention_bwd": ([_P] * 11 + [_I] * 8
                                + [_U, _F, _P, _I, _I, _I], _I),
        # as fused_attention_bwd, with ldq, ldk, ldv before dtype
        "fused_attention_bwd_strided": ([_P] * 11 + [_I] * 11
                                        + [_U, _F, _P, _I, _I, _I], _I),
        # seed, out, B*H, Tq, Sk, thresh, stream, bh0, H, Hc, h0
        "fused_attention_keep_mask": ([_P] * 2 + [_I] * 3
                                      + [_U, _P] + [_I] * 4, _I),
        "fused_attention_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "nms": {
        # boxes, valid, thresholds, mask scratch, keep, N, T, stream
        "greedy_nms": ([_P] * 5 + [_I] * 2 + [_P], _I),
        "greedy_nms_error_string": ([_I], ctypes.c_char_p),
    },
    "fused_adamw": {
        # ptrs, gshape, n_leaves, plan, n_chunks, partials, gnorm_in,
        # count_in, step_in, sched, p_out, m_out, v_out, scal_out,
        # count_out, b1, 1 - b1, b2, 1 - b2, eps, wd, lr, max_norm,
        # linear, impl, moment_dtype, stream
        "fused_adamw": ([_P, _P, _I, _P, _I] + [_P] * 10 + [_F] * 8
                        + [_I] * 3 + [_P], _I),
        "fused_adamw_error_string": ([_I], ctypes.c_char_p),
    },
    "moe_grouped_gemm": {
        # A, a_rows, lda, B, b_stride, ldb, b_kmajor, offsets, experts,
        # max_rows, C, C2, G, N, K, epi, stream
        "moe_rows_gemm": ([_P, _P, _I, _P, _I, _I, _I, _P,
                           _I, _I, _P, _P, _P, _I, _I, _I, _P], _I),
        # A, a_rows, lda, B, ldb, offsets, experts, C, C2, M, N, epi, stream
        "moe_dw_gemm": ([_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                         _P], _I),
        "moe_error_string": ([_I], ctypes.c_char_p),
    },
    "dw_splitk": {
        # x, g, out, K, D, F, dtype, stream, plan, workspace, n_blocks
        # (the wgmma route's; last, so that an older library without them
        # still lines up: ``chip_smoke.py --base``)
        "dw_splitk": ([_P] * 3 + [_I] * 4 + [_P] * 3 + [_I], _I),
        # int* blocks
        "dw_splitk_wgmma_blocks": ([_P], _I),
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
    point. Another checkout's sources may predate some entries (the
    strided attention entries); those are left unset there, and the
    wrappers reach them only for strided calls."""
    csrc = csrc or CSRC
    with _lock:
        lib = _libs.get((csrc, name))
        if lib is None:
            path, = build([name], csrc)
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                if csrc != CSRC and not hasattr(lib, fn):
                    continue
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[(csrc, name)] = lib
        return lib
