"""Where the training step's time goes on the card.

    python -m vqacl_tpu_torch.profile_train [--batch 80] [--steps 10] [--seed 0]
        [--fused_decoder] [--remat {none,full,dots}]

Random-init t5-base (seeded), f32 master weights, bf16 compute, dropout
0.1, the port's train step on one synthetic batch. Prints, as one JSON
line: the train step's host-clock median and p90 (each step ends in
``torch.cuda.synchronize()``), those steps run with the span recorder on
(``utils/profiling.py``), so the same run gives each phase's host time
per step (the self time of ``step.inputs``, ``step.forward``,
``step.backward``, ``step.optimizer`` and ``step.train`` itself) and the
bytes it copies from host memory (``h2d_bytes``); and
from a ``torch.profiler`` window over a few steps, spans on, the device
time by kernel, launches per step, the device's busy share of the
window, the fused-attention kernels' share, and per phase the kernels
it launched (by the time of each launch call) and the device's idle time
inside it; and the peak device memory (``torch.cuda.max_memory_allocated``)
of one step and of one forward and backward alone, each above the memory
held before it. ``--fused_decoder`` runs the decoder's attention through
the kernels too, ``--remat`` recomputes the encoder and decoder blocks
in the backward pass (the JAX CLI's ``--fused_decoder`` and ``--remat``).
Without ``--remat`` the step after the first replays its CUDA graph
(``train/graph.py``), so its phases are the spans ``step.train`` and
``step.graph_replay``, and the peak memory holds the graphs' pool and
the two state slots. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import torch

from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import fused_attention as fa
from vqacl_tpu_torch.profile_eval import _device_us, _pct
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves, tree_map
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_train_step
from vqacl_tpu_torch.utils import profiling
from vqacl_tpu_torch.utils.config import Config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=80)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused_decoder", action="store_true")
    ap.add_argument("--remat", choices=("none", "full", "dots"),
                    default="none")
    args = ap.parse_args(argv)
    remat = False if args.remat == "none" else args.remat
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    cfg = Config()
    m, t = cfg.model, cfg.train
    m.fused_decoder = args.fused_decoder
    params = vlt5.init_vlt5_params(args.seed, m, device=dev)
    tx = make_transform(t)
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device=dev)
    state = TrainState.create(params, tx, proto, seed=args.seed,
                              warmup_iters=1.0, t_total=1000.0)
    batch = next(SyntheticVQA(args.batch, seed=args.seed).batches(
        args.batch, seed=args.seed))["tensors"]
    step = make_train_step(cfg, dtype=torch.bfloat16, device=dev,
                           remat=remat)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_bytes = torch.cuda.memory_allocated()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()

    # the timed steps, spans on: each phase's host time from the same run
    steps = []
    profiling.take()
    profiling.enable()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    profiling.enable(False)
    timed = profiling.take()
    host_ms = {k: v / 1e6 / args.steps for k, v in
               profiling.self_ns(timed.spans).items()}

    # the activation peak: one forward and backward alone (what remat
    # acts on; the whole step's peak above includes the optimizer's)
    dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    live = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    loss = vlt5.forward_train(
        live, m, dbatch, state.proto, t.proto_alpha, t.proto_beta,
        generator=state.generator, dtype=torch.bfloat16, remat=remat).loss
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    torch.cuda.synchronize()
    fwd_bwd_peak = torch.cuda.max_memory_allocated() - start
    del live, loss, grads

    n_prof = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.enable()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            state, met = step(state, batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    profiling.enable(False)
    by_span = _by_span(prof, profiling.take())
    by_kernel = {}
    launches = 0
    for avg in prof.key_averages():
        us = _device_us(avg)
        if us > 0 and avg.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[avg.key] = (us, avg.count)
            launches += avg.count
    busy_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    attn = {name: sum(us for k, (us, _) in by_kernel.items() if tag in k)
            / n_prof / 1e3
            for name, tag in (("K1p_fwd_kernel_ms_per_step", "fwd_kernel"),
                              ("K2_bwd_kernel_ms_per_step", "bwd_kernel"),
                              ("K2_dbias_reduce_ms_per_step",
                               "dbias_reduce"))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    p50 = _pct(steps, 0.5)
    out = {
        "card": smi, "batch": args.batch, "steps": args.steps,
        "fused_decoder": args.fused_decoder, "remat": args.remat,
        "peak_bytes": peak_bytes,
        "peak_above_state_bytes": peak_bytes - state_bytes,
        "fwd_bwd_peak_bytes": fwd_bwd_peak,
        "train_step_ms_p50": p50,
        "train_step_ms_p90": _pct(steps, 0.9),
        "host_ms_per_step": host_ms,
        "h2d_bytes_per_step":
            timed.counters.get("h2d_bytes", 0) / args.steps,
        "loss_last": float(met["loss"]),
        "profiled_steps": n_prof,
        "device_busy_share": busy_us / window_us if window_us else None,
        "device_ms_per_step": busy_us / n_prof / 1e3,
        "kernel_launches_per_step": launches / n_prof,
        "launches_per_step_by_span": {
            k: n / n_prof for k, n in by_span["launches"].items()},
        "idle_ms_per_step_by_span": {
            k: v * 1e3 / n_prof for k, v in by_span["idle_s"].items()},
        "top_kernels_by_span": {
            k: [[name[:80], n / n_prof] for name, n in
                collections.Counter(v).most_common(3)]
            for k, v in by_span["kernels"].items()},
        "no_launch_call": by_span["no_launch_call"],
        **attn,
        "fused_attention_launches": {
            "K1": fa.fused_attention.launches,
            "K1p": fa.fused_attention_fwd_train.launches,
            "K2": fa.fused_attention_bwd.launches},
        "top_kernels": [{"name": k[:80], "device_ms_per_step":
                         us / n_prof / 1e3, "launches_per_step": n / n_prof}
                        for k, (us, n) in top],
    }
    print(json.dumps(out))
    return out


def _by_span(prof, taken) -> dict:
    """``profiling.attribute`` of the profiler's Chrome trace against the
    spans recorded over it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return profiling.attribute(doc, taken.spans, taken.anchor)


if __name__ == "__main__":
    main()
