"""Matrix-product rates at the train step's hot shapes on the card.

    python3 -m vqacl_tpu_torch.mm_bench [--reps 20] [--sets 3]

Counterpart of ``scripts/mm_bench.py``, with its cases at its shapes
(B, S, D, F, H, dk = 80, 56, 768, 3072, 12, 64; bf16 inputs): the MLP
input projection forward, its weight gradient xᵀ·g written five ways
through PyTorch's matrix products and once through the port's own
kernel (``ops.dw.dw_splitk``, K5, which replaces the probe's two Pallas
split-K cases), the attention projections, the score and weighted-sum
products and one attention block's forward. Each case is timed with
CUDA events over ``reps`` calls that cycle through ``sets`` input sets
(more bytes than the 50 MB L2 at these shapes), and its rate is given
against the H100's dense bf16 peak, 989 TFLOP/s. Prints the card's name
and power limit, a table, and the rows as one JSON line.

``run(device="cpu", shapes=...)`` runs the same case list on the CPU at
small shapes for the tests; its times are host-clock times of PyTorch's
CPU kernels, not the card's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.ops import dw
from vqacl_tpu_torch.utils.device import resolve_device

SHAPES = dict(B=80, S=56, D=768, F=3072, H=12, dk=64)
PEAK_FLOPS = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
DW_CASE = "mlp_wi dW dw_splitk (CUDA, K5)"

Case = Tuple[List[Callable[[], torch.Tensor]], int]


def make_cases(device, shapes=None, n_sets: int = 3, seed: int = 0
               ) -> Dict[str, Case]:
    """{case name: (one call per input set, FLOP per call)}. Each call
    returns the case's result."""
    s = dict(SHAPES, **(shapes or {}))
    B, S, D, F, H, dk = (s[k] for k in ("B", "S", "D", "F", "H", "dk"))
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    bf16 = torch.bfloat16

    def rand(*shape, dtype=bf16):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    w1, wq, wqkv = rand(D, F), rand(D, D), rand(D, 3 * D)
    bias = rand(1, H, S, S, dtype=torch.float32)
    sets = [{"x": rand(B, S, D), "dh": rand(B, S, F), "q": rand(B, S, H, dk),
             "wat": rand(B, H, S, S)} for _ in range(n_sets)]
    for t in sets:
        t["x2"] = t["x"].reshape(B * S, D)
        t["dh2"] = t["dh"].reshape(B * S, F)

    def split_k(t, parts=4):
        kc = (B * S) // parts
        acc = torch.zeros((D, F), dtype=torch.float32, device=dev)
        for p in range(parts):
            lo, hi = p * kc, (B * S if p == parts - 1 else (p + 1) * kc)
            acc = acc + (t["x2"][lo:hi].t() @ t["dh2"][lo:hi]).float()
        return acc

    def attn_core(t):
        xx = t["x"]
        qq = (xx @ wq).reshape(B, S, H, dk)
        kk = (xx @ wq).reshape(B, S, H, dk)
        vv = (xx @ wq).reshape(B, S, H, dk)
        sc = torch.einsum("bqhd,bkhd->bhqk", qq, kk).float()
        w = torch.softmax(sc + bias, dim=-1).to(bf16)
        o = torch.einsum("bhqk,bkhd->bqhd", w, vv)
        return o.reshape(B, S, D) @ wq

    mlp = 2 * B * S * D * F
    bodies = {
        "mlp_wi fwd [4480,768]x[768,3072]": (lambda t: t["x"] @ w1, mlp),
        "mlp_wi dW btd,btf->df": (
            lambda t: torch.einsum("btd,btf->df", t["x"], t["dh"]), mlp),
        "mlp_wi dW 2d k=dim0": (lambda t: t["x2"].t() @ t["dh2"], mlp),
        "mlp_wi dW split-K x4 (torch)": (split_k, mlp),
        "mlp_wi dW pre-transposed [768,4480]@": (
            lambda t: t["x2"].t().contiguous() @ t["dh2"], mlp),
        "mlp_wi dW + gnorm epilogue": (
            lambda t: torch.einsum("btd,btf->df", t["x"], t["dh"]).float()
            .square().sum(), mlp),
        # looked up at call time, so a replaced wrapper is the one timed
        DW_CASE: (lambda t: dw.dw_splitk(t["x2"], t["dh2"]), mlp),
        "attn proj [4480,768]x[768,768]": (lambda t: t["x"] @ wq,
                                           2 * B * S * D * D),
        "qkv merged [4480,768]x[768,2304]": (lambda t: t["x"] @ wqkv,
                                             2 * B * S * D * 3 * D),
        "scores bqhd,bkhd->bhqk": (
            lambda t: torch.einsum("bqhd,bkhd->bhqk", t["q"], t["q"]),
            2 * B * H * S * S * dk),
        "attnout bhqk,bkhd->bqhd": (
            lambda t: torch.einsum("bhqk,bkhd->bqhd", t["wat"], t["q"]),
            2 * B * H * S * S * dk),
        "attn block fwd (4 proj + core)": (
            attn_core, 2 * B * S * D * D * 4 + 2 * 2 * B * H * S * S * dk),
    }
    return {name: ([lambda body=body, t=t: body(t) for t in sets], flops)
            for name, (body, flops) in bodies.items()}


def time_ms(fns: List[Callable], reps: int, device) -> float:
    """Mean time of one call over ``reps`` calls cycling through ``fns``:
    CUDA events on a CUDA device, the host clock on the CPU."""
    for f in fns:
        f()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            fns[i % len(fns)]()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(device="cuda", shapes=None, reps: int = 20, n_sets: int = 3
        ) -> List[dict]:
    """Time every case → rows {case, us, tflops, peak_pct}."""
    dev = resolve_device(device)
    rows = []
    for name, (fns, flops) in make_cases(dev, shapes, n_sets).items():
        ms = time_ms(fns, reps, dev)
        rate = flops / (ms * 1e-3)
        rows.append({"case": name, "us": ms * 1e3, "tflops": rate / 1e12,
                     "peak_pct": 100 * rate / PEAK_FLOPS})
    return rows


def table(rows: List[dict]) -> str:
    lines = [f"{'case':42s} {'us':>10} {'TFLOP/s':>8} {'peak%':>6}"]
    lines += [f"{r['case']:42s} {r['us']:10.2f} {r['tflops']:8.2f} "
              f"{r['peak_pct']:6.2f}" for r in rows]
    return "\n".join(lines)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sets", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = run(dev, reps=args.reps, n_sets=args.sets)
    print(f"card: {card}; {torch.cuda.get_device_name(dev)}; peak "
          f"{PEAK_FLOPS / 1e12:g} TFLOP/s bf16")
    print(table(rows))
    print(json.dumps({"card": card, "mm_bench": rows}))
    return rows


if __name__ == "__main__":
    main()
