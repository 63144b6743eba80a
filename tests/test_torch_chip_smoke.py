"""chip_smoke.py's assembly rehearsed on the CPU (``smoke_rehearsal``):
``main()`` with every phase stood in (the kernels line, its keys and the
sum of the phases' counted launches, the summary, the card line, the
verdict), ``--base`` (phases 1-2 timed against a base checkout, then an
``ab`` line and no verdict), that without CUDA the real script prints no
result and exits non-zero, and phase 14's orderings and launch
accounting. Each phase group is rehearsed in its own
``test_torch_chip_smoke_<group>.py``."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import CARD, REPO, rehearse  # noqa: E402

# every phase stood in: phase n counts n launches of each kernel, n of K1′
# and K2 at a row offset and 2n over a rank's heads as a rank reports
# them, returns one summary entry; phase 2 gives the timed rows
STAND_INS = """
import chip_smoke
from smoke import harness as h
from vqacl_tpu_torch.ops import launches
ROW = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
       "bound_by": "operations", "library_ms": None}

def stand_in(n):
    def phase(ctx):
        w = launches.wrappers()
        ctx.count(h.Launches({(fn, "launches", None): n for fn in w}), w)
        ctx.reported("offset_launches", (n, n))
        ctx.reported("head_offset_launches", (2 * n, 2 * n))
        if n == 2:
            ctx.rows.update({k[0]: dict(ROW) for k in h.KERNELS})
        return {f"phase{n}": {"n": n, "launched": list(ctx.launched().k)}}
    return phase

chip_smoke.phases = lambda: tuple((n, stand_in(n)) for n in range(1, 18))
with R.CudaOnCpu():
    sys.exit(chip_smoke.main(ARGV))
"""


def test_chip_smoke_rehearsal_on_cpu():
    r = rehearse(STAND_INS.replace("ARGV", "[]"), 400)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "rehearsal", "count": 1}}
    assert lines[-2] == CARD
    kernels = json.loads(lines[-3])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    # K1′ and K2 also note the launches at a row offset (phase 12's second
    # rank, phase 13's microbatches) and over a tp rank's heads
    offs = {"offset_launches", "head_offset_launches"}
    assert [set(k) for k in kernels] == [
        keys, keys | offs, keys | offs, keys, keys, keys, keys, keys, keys]
    assert [k["name"] for k in kernels] == [
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd", "dw_splitk", "greedy_nms", "fused_adamw",
        "moe_grouped_gemm", "head_lse", "head_dlogits"]
    for k in kernels:
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes",
                                                          "operations")
        assert os.path.exists(os.path.join(REPO, k["source"]))
    for k in kernels[:3]:
        assert k["replaces"].startswith("vqacl_tpu/ops/fused_attention.py:")
    k1, k1p, k2, k5, n1, opt, m1, h1, h2 = kernels
    for k in (h1, h2):
        assert k["source"] == "vqacl_tpu_torch/csrc/head_loss.cu"
        assert k["replaces"] == "vqacl_tpu/models/vlt5.py:313-350"
    assert m1["source"] == "vqacl_tpu_torch/csrc/moe_grouped_gemm.cu"
    assert m1["replaces"] == "none (no mixture of experts in vqacl_tpu)"
    assert opt["replaces"] == "vqacl_tpu/train/optim.py:191"
    assert k5["replaces"] == \
        "vqacl_tpu/models/vlt5.py:313-350, scripts/mm_bench.py:121"
    assert k5["source"] == "vqacl_tpu_torch/csrc/dw_splitk.cu"
    assert n1["replaces"] == \
        "vqacl_tpu/vision/rpn.py:154, vqacl_tpu/ops/nms.py:83"
    assert n1["source"] == "vqacl_tpu_torch/csrc/nms.cu"
    # each kernel's launches: the sum of what the phases counted
    total = sum(range(1, 18))
    assert all(k["launches"] == total for k in kernels)
    for k in (k1p, k2):
        assert k["offset_launches"] == total
        assert k["head_offset_launches"] == 2 * total
    summary = json.loads(next(l for l in lines if l.startswith("summary "))
                         [len("summary "):])
    assert list(summary) == [f"phase{n}" for n in range(1, 18)] + ["card"]
    assert summary["card"] == CARD
    for n in range(1, 18):
        # what each phase counted is its own, whatever came before
        assert summary[f"phase{n}"]["launched"] == [n, n, n]
        # from phase 8 on a phase's record gets its seconds, and the log
        # line says them
        assert ("phase_s" in summary[f"phase{n}"]) == (n >= 8)
        assert (f"phase {n} in " in r.stdout) == (n >= 8)
    assert summary["phase16"]["phase_s"] >= 0


def test_chip_smoke_base_rehearsal_on_cpu():
    # --base: phases 1-2, every timed attention kernel, N1 and K5 also
    # timed on the base checkout's libraries (here the same checkout),
    # then an "ab" line and no verdict
    code = "import chip_smoke\nwith R.CudaOnCpu():\n" \
        f"    sys.exit(chip_smoke.main(['--base', {REPO!r}]))"
    r = rehearse(code, 300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    ab = json.loads(lines[-1][len("ab "):])
    assert ab["base"] == os.path.join(REPO, "vqacl_tpu_torch", "csrc")
    rows = [k for k in ab if k not in ("base", "card")]
    assert len(rows) == 15
    for k in rows:
        assert {"ms", "base_ms", "bound_ms"} <= set(ab[k]), k
        assert ("call_ms" in ab[k]) == ("base_call_ms" in ab[k]) \
            == k.startswith("K1"), k
    assert {"N1 rpn", "N1 sweep", "K5 probe"} <= set(rows)
    assert sum(l.startswith("  ab device: base ") for l in lines) == 15
    assert '"ok"' not in r.stdout and "eval_step:" not in r.stdout


def test_chip_smoke_without_cuda_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_phase14_orderings():
    """Phase 14's orderings at their real margins, about half the smallest
    single-seed gaps of ABLATION.md's per-seed lines: ABLATION.md's seed-0
    cells pass them, and a gap one point short of each fails it."""
    sys.path.insert(0, REPO)
    from smoke import protocol

    assert protocol.P14_ORDERINGS == (
        ("ours", "vanilla", "Avg_acc", 20.0),
        ("vanilla", "ours", "Avg_forget", 25.0),
        ("er", "vanilla", "Avg_acc", 10.0))
    seed0 = {"vanilla": {"Avg_acc": 39.96, "Avg_forget": 75.0},
             "er": {"Avg_acc": 66.24, "Avg_forget": 35.05},
             "ours": {"Avg_acc": 89.8, "Avg_forget": 12.05}}
    got = protocol.p14_orderings(seed0)
    assert [h for _, h in got] == [True] * 3
    assert got[0][0] == "ours Avg_acc 89.800 >= vanilla 39.960 + 20 " \
        "(gap +49.840)"
    for i, (hi, lo, metric, margin) in enumerate(protocol.P14_ORDERINGS):
        rows = {k: dict(v) for k, v in seed0.items()}
        rows[hi][metric] = rows[lo][metric] + margin - 1.0
        held = [h for _, h in protocol.p14_orderings(rows)]
        assert held[i] is False, (hi, lo, metric)
        rows[lo][metric] = 10.0                           # the edge holds
        rows[hi][metric] = 10.0 + margin
        assert protocol.p14_orderings(rows)[i][1] is True


def test_phase14_launch_accounting():
    """The launches a run's counted calls imply (encoder layers times
    train + replay + importance steps for K1'/K2, predict + capture
    batches for K1) and the soak's matrix check."""
    sys.path.insert(0, REPO)
    from smoke import protocol
    from vqacl_tpu_torch.soak import expected_launches

    counts = {"train_steps": 7, "replay_steps": 5, "predict_batches": 11,
              "importance_batches": 3, "capture_batches": 2}
    assert expected_launches(counts, 2) == [2 * 13, 2 * 15, 2 * 15]
    assert expected_launches({"train_steps": 4}, 12) == [0, 48, 48]
    full = [[50.0 if j <= i else -1.0 for j in range(10)] for i in range(10)]
    assert protocol.p14_matrix_complete(full, 10)
    hole = [row[:] for row in full]
    hole[9][3] = -1.0                   # a cell never evaluated
    assert not protocol.p14_matrix_complete(hole, 10)
    above = [row[:] for row in full]
    above[2][5] = 0.0                   # a task tested before its training
    assert not protocol.p14_matrix_complete(above, 10)
    nan = [row[:] for row in full]
    nan[4][4] = float("nan")
    assert not protocol.p14_matrix_complete(nan, 10)
    assert not protocol.p14_matrix_complete(full[:9], 10)
