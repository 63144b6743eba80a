#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
(an H100) and check them.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --base DIR   # phases 1-2, timed against DIR

Seventeen phases run in order, each of which exits non-zero on
failure. Each is a function of a module under ``smoke/``, whose
docstring says what it checks: 1 build, 2 kernel checks and 6 the
``mm_bench`` probe (``kernels.py``); 3 the eval slice, 4 the training
slice and 5 serving (``steps.py``); 7 the continual-learning loop
(``cl.py``); 8 the serving extras (``serving.py``); 9 the model
extensions (``extensions.py``); 10 the training entry points
(``clis.py``); 11 region and video extraction (``extraction.py``); 12
data parallelism (``dp.py``); 13 tensor and pipeline parallelism
(``tppp.py``); 14 the protocol scripts (``protocol.py``); 15 the fused
optimizer (``optimizer.py``); 16 the grouped expert GEMMs (``moe.py``);
17 the train step's CUDA graphs (``graphs.py``).

``smoke/harness.py`` runs them in turn and holds what they share, the
launch accounting among it. The third-to-last line is the summary, the
second-to-last lines are a JSON object of per-kernel numbers (each
kernel's launches over the phases' main-path runs) and the card's name
and power limit; the last line is the run's verdict as JSON. Without a
CUDA device, or outside a checkout, it prints no result and exits
non-zero.

``--base DIR`` compares this checkout's kernels with another's on the
same card in one run: DIR holds that checkout (for example ``git archive
<commit> | tar -x -C build/base``), whose ``vqacl_tpu_torch/csrc`` is
built beside this one's (the kernels whose source it has: N1 is left out
when it has no ``nms.cu``). Phases 1 and 2 run; every timed K1, K1′, K2,
N1 and K5 (at the probe's shape: a library from before the wgmma route
takes its own route) is timed through the same wrappers and inputs with
DIR's libraries too,
in the order base, this, this, base, on both measures (device and
``call_ms``). The C signatures must be the same in both. The run then
prints an ``ab`` JSON line and stops.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def phases() -> tuple:
    """The ordered phase list: (number, phase)."""
    from smoke import (cl, clis, dp, extensions, extraction, graphs, kernels,
                       moe, optimizer, protocol, serving, steps, tppp)

    return ((1, kernels.build), (2, kernels.kernel_checks),
            (3, steps.eval_slice), (4, steps.train_slice),
            (5, steps.serving), (6, kernels.mm_probe), (7, cl.cl_loop),
            (8, serving.serving_extras), (9, extensions.model_extensions),
            (10, clis.training_entry_points), (11, extraction.extraction),
            (12, dp.data_parallel), (13, tppp.tensor_pipeline),
            (14, protocol.protocol_runs), (15, optimizer.fused_optimizer),
            (16, moe.grouped_experts), (17, graphs.graph_replay))


def rank_main(args) -> int:
    """Rank mode (``--rank``): join the group of ``--world`` ranks
    through the file store ``--store`` over gloo on the card (as the
    spec's mesh, phase 12's dp by default), run phase 12's ``p12_rank``
    or phase 13's ``p13_rank`` (or, alone, one of phase 14's surrogate
    rows) and write its record to ``--out`` as JSON."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from smoke.dp import p12_rank
    from smoke.harness import P12_TIMEOUT
    from smoke.protocol import p14_row
    from smoke.tppp import p13_rank
    from vqacl_tpu_torch.parallel.mesh import make_mesh

    with open(args.spec) as f:
        spec = json.load(f)
    if spec.get("phase") == 14:       # a surrogate row: no group
        with open(args.out, "w") as f:
            json.dump(p14_row(spec, args.rank), f)
        return 0
    ctx = make_mesh(**spec.get("mesh", {"dp": args.world}),
                    device="cuda:0", backend="gloo",
                    init_method=f"file://{args.store}", rank=args.rank,
                    world_size=args.world, timeout_s=P12_TIMEOUT)
    rec = p13_rank(ctx, spec) if spec.get("phase") == 13 else \
        p12_rank(ctx, spec)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", metavar="DIR",
                    help="another checkout: time its kernels beside these "
                         "(phases 1-2 only)")
    # rank mode: one rank of phase 12's group, started by the script itself
    for name, kind in (("--rank", int), ("--world", int), ("--store", str),
                       ("--spec", str), ("--out", str)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vqacl_tpu_torch")):
        print("chip_smoke: run from a checkout (vqacl_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.rank is not None:
        return rank_main(args)
    from smoke import harness as h

    if args.base:
        h.BASE_CSRC = os.path.join(os.path.abspath(args.base),
                                   "vqacl_tpu_torch", "csrc")
        if not os.path.isdir(h.BASE_CSRC):
            print(f"chip_smoke: --base {args.base}: no vqacl_tpu_torch/csrc",
                  file=sys.stderr)
            return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = h.card_line()
    h.log(f"card: {card}")
    h.log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    h.log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    ctx = h.Context(card)
    h.run(phases()[:2] if args.base else phases(), ctx)
    if args.base:
        return 0
    h.log("summary " + json.dumps({**ctx.summary, "card": card}))
    h.log(json.dumps({"kernels": h.kernels_line(ctx)}))
    h.log(card)
    h.log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
