"""End-to-end VQACL soak at full model scale on the card (counterpart of
``scripts/soak.py``).

Runs the ENTIRE dual-level benchmark loop — 10 tasks × 5 groups with
replay, per-epoch validation, per-task checkpoints, and the full
55-cell greedy-decode test matrix — on synthetic data at t5-base scale
with the device feature cache (bf16 compute), and reports wall-clock:

  python -m vqacl_tpu_torch.soak            # small: 1000 QA/task, M=1000
  python -m vqacl_tpu_torch.soak --full     # published protocol scale:
                                            # 29k QA/task, M=5000, 3 epochs

Before the ``SOAK ...`` line (the last) it prints, from the trainer's own
records: the wall of each task and the wall's shares (train, predict,
loader, checkpoint), the median train step and predict batch (CUDA
events around each call on a card), the share of the wall inside those
calls' event spans, the K1/K1′/K2 launches against what the counted
steps and batches imply, the peak device memory and, on a card, its
busy share over ``BUSY_STEPS`` train steps (``torch.profiler``). ``--device cpu``
runs the kernels' plain versions; the default ``cuda`` raises without a
card. ``--tasks N`` runs the first N tasks of the protocol only (the
same items as the whole run's first N), for a run that a time limit
cannot hold whole.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from vqacl_tpu_torch.cl.tasks import ALL_TASKS
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.ops import fused_attention as fa
from vqacl_tpu_torch.profile_eval import _device_us
from vqacl_tpu_torch.utils.config import Config
from vqacl_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (epochs, m_size, train QA per task, image pool) of the two scales; the
# full scale bounds the pool (real VQA v2 ≈ 7 questions/image), which
# keeps its device feature cache at ~1.8 GB bf16
SCALES = {"small": dict(epochs=1, m_size=1000, n_train=1000, n_images=None),
          "full": dict(epochs=3, m_size=5000, n_train=29000,
                       n_images=12_400)}
N_VAL = N_TEST = 200
ANSWER_VOCAB = 32
# the calls the trainer counts and times (``VQACLTrainer.counts``)
KINDS = ("train_steps", "replay_steps", "predict_batches",
         "importance_batches", "capture_batches")
# train and replay steps run before the busy-share window opens (the
# first calls build and warm up), and the steps it spans: reading the
# trace of ~12,600 launches per t5-base step costs host seconds, which
# the run's wall then holds (``read_s``)
BUSY_SKIP = 20
BUSY_STEPS = 3


def make_config(full: bool, out: str) -> Config:
    s = SCALES["full" if full else "small"]
    cfg = Config()
    cfg.output = out
    cfg.train.epochs = s["epochs"]
    cfg.train.m_size = s["m_size"]
    cfg.data.device_cache = True
    return cfg


def make_data(tok, cfg, full: bool, tasks=None) -> SyntheticDataModule:
    s = SCALES["full" if full else "small"]
    kw = {} if tasks is None else {"tasks": list(tasks)}
    return SyntheticDataModule(
        tok, n_train_per_task=s["n_train"], n_val_per_task=N_VAL,
        n_test_per_task=N_TEST, feat_dim=cfg.model.feat_dim,
        n_boxes=cfg.model.n_boxes, answer_vocab=ANSWER_VOCAB, seed=0,
        n_images=s["n_images"], **kw)


def launch_counts():
    """K1, K1′ and K2 launches so far (the wrappers' counters)."""
    return (fa.fused_attention.launches,
            fa.fused_attention_fwd_train.launches,
            fa.fused_attention_bwd.launches)


def expected_launches(counts, num_layers: int):
    """[K1, K1′, K2] that a run's counted calls imply with the encoder's
    attention in the kernels: K1′ and K2 once per encoder layer in every
    train, replay and importance step, K1 once per layer in every predict
    and DER capture batch."""
    steps = counts.get("train_steps", 0) + counts.get("replay_steps", 0) \
        + counts.get("importance_batches", 0)
    k1 = counts.get("predict_batches", 0) + counts.get("capture_batches", 0)
    return [num_layers * k1, num_layers * steps, num_layers * steps]


def busy_window(trainer, n_steps: int, skip: int = BUSY_SKIP) -> dict:
    """Profile train and replay steps ``skip + 1`` … ``skip + n_steps`` of
    ``trainer``'s run (``torch.profiler``, the CUDA activity): the dict
    returned gets, once the window closes, its host seconds (a
    synchronize before its first step and after its last), the device
    seconds of the kernels in it, their ratio (the card's busy share;
    None when the trace holds no kernel) and the host seconds spent
    reading the trace."""
    win = {}
    make, seen = trainer._train_step, [0]
    # the host's ops only where torch has no CUDA (the CPU tests)
    acts = [torch.profiler.ProfilerActivity.CUDA
            if torch.backends.cuda.is_built()
            else torch.profiler.ProfilerActivity.CPU]

    def wrapped(use_memory_loss):
        fn = make(use_memory_loss)

        def step(state, batch):
            seen[0] += 1
            if seen[0] == skip + 1:
                torch.cuda.synchronize()
                win["prof"] = torch.profiler.profile(activities=acts)
                win["prof"].__enter__()
                win["t0"] = time.perf_counter()
            out = fn(state, batch)
            if seen[0] == skip + n_steps:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                wall = t1 - win.pop("t0")
                prof = win.pop("prof")
                prof.__exit__(None, None, None)
                dev_s = sum(
                    _device_us(a) for a in prof.key_averages()
                    if a.device_type == torch.autograd.DeviceType.CUDA) / 1e6
                win.update(steps=n_steps, wall_s=wall, device_s=dev_s,
                           busy_share=dev_s / wall if dev_s else None,
                           read_s=time.perf_counter() - t1)
            return out
        return step

    trainer._train_step = wrapped
    return win


def record(trainer, metrics, wall: float, launches) -> dict:
    """The run's numbers from the trainer's own records."""
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None  # noqa: E731
    c, times, w = trainer.counts, trainer.times_ms, trainer.wall_s
    in_calls = sum(sum(times[k]) for k in KINDS) / 1e3
    on_card = trainer.device.type == "cuda"
    return {
        "device": trainer.device.type,
        "wall_s": wall, "task_wall_s": dict(trainer.task_wall_s),
        "wall_share": {k: w[k] / wall for k in
                       ("train", "predict", "loader", "checkpoint")},
        "counts": {k: c[k] for k in KINDS},
        "train_step_ms_median": med(times["train_steps"]
                                    + times["replay_steps"]),
        "predict_batch_ms_median": med(times["predict_batches"]),
        "steps_per_s": (c["train_steps"] + c["replay_steps"])
        / max(w["train"], 1e-9),
        "call_span_share": in_calls / wall,
        "launches": list(launches),
        "expected_launches": expected_launches(
            c, trainer.cfg.model.num_layers),
        "peak_device_bytes": torch.cuda.max_memory_allocated(
            trainer.device) if on_card else None,
        "result_matrix": trainer.result_matrix.matrix().tolist(),
        "Avg_acc": metrics["Avg_acc"], "Avg_forget": metrics["Avg_forget"],
    }


def report(rec: dict) -> list:
    """The lines printed before the SOAK line."""
    ms = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
    clock = "between CUDA events, no sync per call" \
        if rec["device"] == "cuda" else "on the host clock"
    c = rec["counts"]
    peak = rec["peak_device_bytes"]
    return [
        "soak: wall per task " + ", ".join(
            f"{t} {s:.3f} s" for t, s in rec["task_wall_s"].items()),
        "soak: wall shares " + json.dumps(rec["wall_share"])
        + f"; {rec['call_span_share']:.4f} of the wall inside the counted "
        f"calls ({clock})",
        f"soak: {c['train_steps']} train + {c['replay_steps']} replay steps, "
        f"median {ms(rec['train_step_ms_median'])} ms, "
        f"{rec['steps_per_s']:.3f} steps/s of train time; "
        f"{c['predict_batches']} predict batches, median "
        f"{ms(rec['predict_batch_ms_median'])} ms; importance batches "
        f"{c['importance_batches']}, DER capture batches "
        f"{c['capture_batches']}",
        "soak: launches K1={} K1'={} K2={} (the counts imply {}/{}/{}{})"
        .format(*rec["launches"], *rec["expected_launches"],
                "" if rec["device"] == "cuda" else
                "; the CPU runs the plain versions, which launch nothing"),
        "soak: peak device memory "
        + ("not measured (no card)" if peak is None else
           f"{peak} B ({peak / 2 ** 30:.2f} GiB)"),
    ]


def run(full: bool = False, out: str = None, device="cuda", tasks=None,
        verbose: bool = True) -> dict:
    """The soak on ``device`` over the first ``tasks`` tasks (all ten by
    default) → its record; prints as ``main`` does. On a card the train
    and replay steps ``BUSY_SKIP + 1`` … ``BUSY_SKIP + BUSY_STEPS`` run
    under ``torch.profiler`` for the card's busy share
    (``busy_window``)."""
    dev = resolve_device(device)            # no card: raise before any work
    out = out or os.path.join(REPO, "build", "soak")
    cfg = make_config(full, out)
    tok = VLT5Tokenizer()
    t0 = time.perf_counter()
    data = make_data(tok, cfg, full,
                     None if tasks is None else ALL_TASKS[:tasks])
    print(f"data built in {time.perf_counter() - t0:.1f}s", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    trainer = VQACLTrainer(cfg, data, tok, verbose=verbose,
                           dtype=torch.bfloat16, device=dev)
    win = busy_window(trainer, BUSY_STEPS) if dev.type == "cuda" else {}
    metrics = trainer.train()
    dt = time.perf_counter() - t0
    rec = record(trainer, metrics, dt,
                 [b - a for a, b in zip(before, launch_counts())])
    rec["busy_window"] = win or None
    for line in report(rec):
        print(line, flush=True)
    if win:
        print(f"soak: the card's busy share over train and replay steps "
              f"{BUSY_SKIP + 1}-{BUSY_SKIP + win['steps']} "
              f"(torch.profiler): {win['busy_share']} ("
              f"{win['device_s']:.4f} s of kernels in {win['wall_s']:.4f} "
              f"s; reading the trace took {win['read_s']:.3f} s of the "
              f"wall)", flush=True)
    print(f"\nSOAK {'full' if full else 'small'}: {dt:.1f}s "
          f"wall-clock; Avg_acc={metrics['Avg_acc']:.2f} "
          f"Avg_forget={metrics['Avg_forget']:.2f}", flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="published-protocol scale")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "soak"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain versions)")
    ap.add_argument("--tasks", type=int, default=None,
                    help="run the first N tasks only (default: all ten)")
    args = ap.parse_args(argv)
    return run(args.full, args.out, args.device, args.tasks)


if __name__ == "__main__":
    main()
