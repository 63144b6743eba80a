"""chip_smoke.py phases 3, 4 and 5 (``smoke/steps.py``) rehearsed on the
CPU (``smoke_rehearsal``): the launches per eval step, per train step
with the plain and with the fused decoder, per loss-eval step and per
remat mode, those of the timed steps counted; serving."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_steps_rehearsal_on_cpu():
    r, out, lines = phases_json([3, 4, 5], 300, init=False,
                                attrs=", dec_times={}")
    summary, k = out["summary"], out["launches"]
    # K1: 2 layers x 3 timed eval steps, plus one fused-decoder loss-eval
    # step (2 encoder + 2 x 2 decoder attentions)
    assert "fused_attention launches=6 (2/step)" in r.stdout
    assert k["fused_attention_fwd"]["launches"] == 2 * 3 + 6
    # K1'/K2: 4 train steps x 2 encoder layers, and 4 fused-decoder
    # steps x (2 encoder + 2 x 2 decoder) attentions
    assert k["fused_attention_fwd_train"]["launches"] == \
        k["fused_attention_bwd"]["launches"] == 2 * 4 + 6 * 4
    assert "train_step: bs 8 bf16" in r.stdout
    assert "launches over 4 steps: K1=0 K1'=8 K2=8" in r.stdout
    assert "launches over 4 steps: K1=0 K1'=24 K2=24" in r.stdout
    for dname in ("bfloat16", "float32"):
        assert f"loss_eval fused decoder {dname}" in r.stdout
    assert r.stdout.count("launches K1=6 K1'=0 K2=0") == 2
    # remat: every fused block's forward replays once
    assert "remat=False: " in r.stdout
    for mode in ("full", "dots"):
        assert f"remat={mode}: " in r.stdout
        assert f"remat={mode} vs none: loss equal True" in r.stdout
    assert r.stdout.count("launches K1=0 K1'=12 K2=6") == 2
    assert set(summary["remat"]) == {"False", "full", "dots"}
    # the fused optimizer's pair in each of the 2 x 4 train steps and the 3
    # remat steps, all counted
    assert k["fused_adamw"]["launches"] == 2 * (2 * 4 + 3)
    assert summary["launches_per_train_step"] == {"K1": 0.0, "K1p": 2.0,
                                                  "K2": 2.0}
    assert summary["fused_decoder"]["kernel_times"] == {}
    # serving: every submit answered, K1 per layer per batch, not counted
    assert summary["serve"]["errors"] == 0
    assert "serving: 48 answers from 16 clients x 3" in r.stdout
