"""Where the serving path's time goes on the card.

    python -m vqacl_tpu_torch.profile_eval [--batch 100] [--steps 10] [--seed 0]

Random-init t5-base (seeded), cast to bf16, the port's eval step on a
synthetic batch. Prints, as one JSON line: the eval step's host-clock
median and p90 (each step ends in ``torch.cuda.synchronize()``), the
same split into encode+retrieve and greedy decode, the decode steps
run, and from a ``torch.profiler`` window over a few steps the device
time by kernel, launches per step and the device's busy share of the
window. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.generate import greedy_decode
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops.fused_attention import fused_attention
from vqacl_tpu_torch.train.step import make_eval_step
from vqacl_tpu_torch.utils.config import Config


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return float(getattr(avg, name))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    cfg = Config()
    m = cfg.model
    params = vlt5.init_vlt5_params(args.seed, m, device=dev)
    # as in chip_smoke.py: a random decoder otherwise repeats its start token
    params["shared"][m.pad_token_id] = 0.0
    params = vlt5.cast_params_for_inference(params, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device=dev)._replace(
        q_proto=torch.randn(m.n_ques_types, m.d_model, generator=g,
                            device=dev),
        v_proto=torch.randn(m.n_categories, m.d_model, generator=g,
                            device=dev))
    batch = collate(SyntheticVQA(args.batch, seed=args.seed).examples,
                    with_targets=False)["tensors"]
    ev = make_eval_step(cfg, dtype=torch.bfloat16, device=dev)
    ev(params, proto, batch)
    torch.cuda.synchronize()

    steps = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        tokens = ev(params, proto, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)

    # the same work split at the encode / decode boundary
    dev_batch = {k: torch.from_numpy(batch[k]).to(dev)
                 for k in ("input_ids", "vis_feats", "boxes")}
    enc_ms, dec_ms = [], []
    with torch.inference_mode():
        for _ in range(args.steps):
            t0 = time.perf_counter()
            hidden, mask = vlt5.encode(params, m, **dev_batch,
                                       dtype=torch.bfloat16)
            hidden, mask, _, _ = vlt5.augment(m, hidden, mask, proto)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            greedy_decode(params, m, hidden, mask, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((time.perf_counter() - t1) * 1e3)
    # the loop runs until every row has emitted EOS, or all T steps
    T = tokens.shape[1]
    eos = tokens == m.eos_token_id
    first_eos = torch.where(eos.any(dim=1), eos.int().argmax(dim=1),
                            torch.full_like(tokens[:, 0], T - 1))
    decode_steps = int(first_eos.max()) + 1

    n_prof = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            ev(params, proto, batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    launches = 0
    for avg in prof.key_averages():
        us = _device_us(avg)
        if us > 0 and avg.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[avg.key] = (us, avg.count)
            launches += avg.count
    busy_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {
        "card": smi, "batch": args.batch, "steps": args.steps,
        "eval_step_ms_p50": _pct(steps, 0.5),
        "eval_step_ms_p90": _pct(steps, 0.9),
        "encode_retrieve_ms_p50": _pct(enc_ms, 0.5),
        "greedy_decode_ms_p50": _pct(dec_ms, 0.5),
        "decode_steps": decode_steps,
        "profiled_steps": n_prof,
        "device_busy_share": busy_us / window_us if window_us else None,
        "device_ms_per_step": busy_us / n_prof / 1e3,
        "kernel_launches_per_step": launches / n_prof,
        "fused_attention_launches_total": fused_attention.launches,
        "top_kernels": [{"name": k[:80], "device_ms_per_step":
                         us / n_prof / 1e3, "launches_per_step": n / n_prof}
                        for k, (us, n) in top],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
