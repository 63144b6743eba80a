"""chip_smoke.py phase 8 (``smoke/serving.py``) rehearsed on the CPU
(``smoke_rehearsal``): the beam, device-cache, cached-CL, HTTP and pack
checks and their launches, counted, at a cache of a few hundred
images."""

import os

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import REPO, phases_json  # noqa: E402


def test_chip_smoke_serving_rehearsal_on_cpu():
    r, out, lines = phases_json([8], 300, attrs=", eval_step_ms=1.0")
    summary, k = out["summary"], out["launches"]
    p8 = summary["serving_extras"]
    p8_k = summary["serving_extras_launches"]
    assert p8_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    ext_cl = [p8["cl_er_cached"]["launches"][i]
              + p8["cl_er_host"]["launches"][i]
              + p8["cl_tiny_int8_cache"]["launches"][i] for i in range(3)]
    # K1: 3 beam steps, one cached eval step, the HTTP batches and the
    # pack predictor's two batches, 2 layers each
    assert p8_k[0] == 2 * (3 + 1 + p8["http"]["batches"] + 2) + ext_cl[0]
    # K1'/K2: one cached train step of 2 layers
    assert p8_k[1] == p8_k[2] == 2 + ext_cl[1]
    assert "beam: bs 4 x 5 beams bf16 eval_step_ms=" in r.stdout
    assert "launches over 3 steps: K1=6 K1'=0 K2=0" in r.stdout
    assert len(p8["beam"]["eval_step_ms"]) == 3
    assert p8["beam"]["min_logp_gap"] >= -1e-3
    assert all(p8["tiny_card_equals_cpu"].values())
    assert len(p8["tiny_card_equals_cpu"]) == 5
    assert "bf16 table == features rounded to bf16, bit for bit: True" \
        in r.stdout
    assert "slot -1 and out of range give zeros: True" in r.stdout
    assert p8["cache"]["eval_tokens_equal"]
    assert p8["cache"]["train_loss_rel"] <= 1e-6
    assert p8["cache"]["int8_worst_err_over_scale"] <= 0.5 + 2e-5
    h2d = p8["cache"]["h2d_bytes"]
    assert h2d["eval_cached"] == 4 * 20 * 4 + 4 * 4
    assert h2d["eval_host"] - h2d["eval_cached"] == 4 * 36 * (2048 + 4) * 4 \
        - 4 * 4
    assert h2d["train_host"] - h2d["train_cached"] == \
        8 * 36 * (2048 + 4) * 4 - 8 * 4
    er = p8["cl_er_cached"]
    assert er["launches"] == er["expected_launches"] and min(
        er["launches"]) > 0 and er["counts"]["replay_steps"] > 0
    assert p8["cl_er_host"]["launches"] == er["launches"]
    assert "cl_er_cached: phase 7's ER run, data.device_cache=True" \
        in r.stdout
    assert "cl_er cached vs host: " in r.stdout
    assert "objects tracked by gc" in r.stdout
    tiny8 = p8["cl_tiny_int8_cache"]
    assert all(tiny8["equal"].values()) and tiny8["loss_rel_err"] <= 1e-5
    assert min(tiny8["launches"]) > 0
    http = p8["http"]
    assert http["stats"]["errors"] == 0
    assert http["stats"]["requests"] == 16 * 3 + 8 + 1
    assert "answers == predictor.answer: True" in r.stdout
    assert "predictor over the pack answers as over the memory store: " \
        "True" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase8.vfpack"))
    assert p8["phase_s"] >= 0
