"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The compile caches of the program (its
CUDA kernels under ``build/kernels``, Triton's and the CUDA driver's
caches under ``build/``) stay at fixed paths inside the checkout, so only
the first run there builds. Libraries that could load JAX are told not
to.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare() -> None:
    """Fixed cache directories inside the checkout, no JAX from libraries
    that could load it, and the checkout's root (not this directory) on
    the import path. Call before torch is imported."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    for flag in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[flag] = "0"
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


if __name__ == "__main__":
    prepare()
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
