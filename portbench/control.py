"""The readings that set the limits of ``correct``: the program and the
control on several seeds.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 5] [--fault half_batch]

For each seed, one run of the cell (set-up, a window of ``--seconds``,
the check) whose check also runs the control: the reference in the
program's place at the precision below the configuration's (fp8 e4m3
for bf16). Both sides are judged against the cell's limits by the
harness's own ``verdict``: one JSON line per seed with each compared
number's program and control reading, ``correct`` (the program, or the
program with ``--fault`` planted) and ``control_correct``. A last
``summary`` line counts the seeds on which each came out correct. The
benchmark's own runs never run it.

Each seed runs in a process of its own: a run leaves the port's loader
threads (``data/partition.py::BatchLoader``) blocked in the middle of an
epoch, and they keep the run's traffic alive until the process ends (in
the VQA cell 24 GB of host features, so a second seed in the same
process runs the host out of memory).
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)


def one_seed(args, seed: int) -> dict:
    """One seed's run in this process → its JSON record."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from portbench.run import prepare

    prepare()
    import torch

    from portbench import harness, spec

    cell = spec.load(args.workload)
    if args.fault == "half_batch":
        from vqacl_tpu_torch.cl.trainer import VQACLTrainer
        make = VQACLTrainer._train_step

        def halved(self, use_memory_loss):
            fn = make(self, use_memory_loss)

            def step(state, batch):
                B = batch["input_ids"].shape[0]
                return fn(state, {k: v[:B // 2] if getattr(v, "shape", ())
                                  and v.shape[0] == B else v
                                  for k, v in batch.items()})
            return step
        VQACLTrainer._train_step = halved
    elif args.fault is not None:
        raise SystemExit(f"unknown fault {args.fault!r}")
    t0 = time.perf_counter()
    out = harness.execute(cell, seed, args.seconds, False,
                          torch.device("cuda:0"), t0,
                          precision=args.precision)
    nums = {k: v for k, v in out["numbers"].items() if not k.startswith("_")}
    ok, judged = harness.verdict(nums, cell.limits, out["rec"])
    ctl_ok, ctl_judged = harness.control_verdict(nums, cell.limits)
    return {"workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": ok, "control_correct": ctl_ok, "numbers": nums,
            "judged": judged, "control_judged": ctl_judged,
            "detail": out["numbers"].get("_detail"),
            "failed": out["rec"].get("failed"),
            "setup_s": out["rec"]["setup_s"],
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--precision", default="fp8")
    ap.add_argument("--fault", default=None,
                    help="half_batch: each train and replay step sees the "
                         "first half of its rows (the mean over those)")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) == 1:
        print(json.dumps(one_seed(args, seeds[0])), flush=True)
        return 0
    n_ok = n_ctl_ok = 0
    for seed in seeds:
        cmd = [sys.executable, HERE, "--workload", args.workload,
               "--seeds", str(seed), "--seconds", str(args.seconds),
               "--precision", args.precision]
        if args.fault is not None:
            cmd += ["--fault", args.fault]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        lines = [x for x in p.stdout.splitlines() if x.startswith("{")]
        if p.returncode != 0 or not lines:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "exit": p.returncode}), flush=True)
            continue
        rec = json.loads(lines[-1])
        n_ok += rec["correct"]
        n_ctl_ok += rec["control_correct"]
        print(lines[-1], flush=True)
    print(json.dumps({"summary": args.workload, "fault": args.fault,
                      "seeds": len(seeds), "correct": n_ok,
                      "control_correct": n_ctl_ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
