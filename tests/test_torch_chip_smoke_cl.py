"""chip_smoke.py phase 7 (``smoke/cl.py``) rehearsed on the CPU
(``smoke_rehearsal``): the ER, EWC and DER++ runs and the tiny card run,
each one's launches checked against its steps and batches, all strided
(merged projections), and counted."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402

AFTER = """
import os, shutil
from smoke import harness as h
out["p7_ckpt"] = os.path.exists(h.P7_CKPT)
shutil.rmtree(h.P7_DIR)
"""


def test_chip_smoke_cl_rehearsal_on_cpu():
    r, out, lines = phases_json([7], 300, after=AFTER)
    summary, k = out["summary"], out["launches"]
    cl = summary["cl"]
    assert set(cl) == {"er", "ewc", "derpp"}
    cl_k = [sum(r_["launches"][i] for r_ in cl.values())
            + summary["cl_tiny"]["launches"][i] for i in range(3)]
    for name, run in cl.items():
        c = run["counts"]
        steps = c["train_steps"] + c.get("replay_steps", 0)
        assert run["launches"] == run["expected_launches"] == [
            2 * (c["predict_batches"] + c.get("capture_batches", 0)),
            2 * (steps + c.get("importance_batches", 0)),
            2 * (steps + c.get("importance_batches", 0))], name
        assert c.get("replay_steps", 0) > 0 and min(run["launches"]) > 0
        # the fused optimizer's pair in every train and replay step
        assert run["adamw_launches"] == 2 * steps, name
        line = next(l for l in lines
                    if l.startswith(f"cl_{name}: wall shares"))
        k1_, k1p_, _ = run["launches"]
        assert f"launches K1={k1_} K1'={k1p_} K2={k1p_} (expected " \
            f"{k1_}/{k1p_}/{k1p_})" in line
        assert set(run["wall_share"]) == {"train", "predict", "loader",
                                          "checkpoint"}
        assert len(run["task_wall_s"]) == 2
        assert run["train_step_ms_median"] > 0
        assert len(run["checkpoint_save_ms"]) == 2
        assert len(run["losses"]) == steps
        # the trainer resolves "auto" to merged projections: every launch
        # of its loops strided
        assert run["merged_qkv"] and run["strided_launches"] == \
            run["launches"], name
        assert f"cl_{name}: t5-base bf16 compute" in r.stdout
    assert "merged_qkv True (the trainer's resolve of 'auto')" in r.stdout
    assert cl["ewc"]["counts"]["importance_batches"] == 2 * 2
    assert len(cl["ewc"]["importance_batch_ms"]) == 2 * 2
    assert cl["derpp"]["counts"]["capture_batches"] > 0
    assert len(cl["derpp"]["capture_batch_ms"]) == \
        cl["derpp"]["counts"]["capture_batches"]
    tiny = next(l for l in lines if l.startswith("cl tiny f32 "))
    assert '"result_matrix": true, "comp": true, "noncomp": true, ' \
        '"answers": true' in tiny
    assert summary["cl_tiny"]["loss_rel_err"] <= 1e-5
    assert min(summary["cl_tiny"]["launches"]) > 0
    # the kernels line's count of the phase: its four card runs
    assert [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")] == cl_k
    assert cl_k[1] == cl_k[2]
    assert k["fused_adamw"]["launches"] >= 2 * sum(
        r_["counts"]["train_steps"] + r_["counts"]["replay_steps"]
        for r_ in cl.values())
    assert k["fused_adamw"]["launches"] % 2 == 0
    # the ER run's last checkpoint, kept for phase 9
    assert out["p7_ckpt"]
