"""chip_smoke.py phase 16 (``smoke/moe.py``) rehearsed on the CPU
(``smoke_rehearsal``): the grouped expert GEMMs' wrapper replaced by its
checks and the plain version with the kernels' launch count (2 a
forward, 4 a backward), at tiny widths (96 tokens, D = F = 128; a
3-layer VL-Moonlight of d_model 128): its checks, the two train steps'
12 launches each, the CL run's counts, the fused optimizer's pair in
every update and its kernels row, every launch of the row counted."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_moe_rehearsal_on_cpu():
    r, out, lines = phases_json([16], 300, init=False)
    summary, k = out["summary"], out["launches"]
    p16, row = summary["grouped_experts"], out["rows"]["moe_grouped_gemm"]
    assert row["max_abs_err"] == 0.0
    assert row["bound_by"] in ("bytes", "operations")
    assert p16["all_to_one"]["rows"][3] == 96
    assert sum(p16["cell"]["rows"]) == p16["times"]["rows"]
    assert p16["sync_debug_step"]["launches"] == 12
    c16 = p16["cl"]["counts"]
    assert c16["replay_steps"] > 0 and c16["predict_batches"] > 0
    steps = c16["train_steps"] + c16["replay_steps"]
    assert p16["cl"]["train_step_launches"] == 12 * steps
    assert p16["cl"]["launches"] > p16["cl"]["train_step_launches"]
    assert k["moe_grouped_gemm"]["launches"] == p16["cl"]["launches"] + 2 * 12
    assert k["fused_adamw"]["launches"] == 2 * (2 + steps)
    assert p16["phase_s"] >= 0
