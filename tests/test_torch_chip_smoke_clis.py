"""chip_smoke.py phase 10 (``smoke/clis.py``) rehearsed on the CPU
(``smoke_rehearsal``): the VQA CLI's ten-task run from a tsv-converted
pack (the files it leaves, launches against its steps, ``Test()`` equal
to the training matrix), the backbone start bit-equal to the file,
NExT-QA's launches against its steps at the 39-position encoder, the
tiny card-vs-CPU CLI pair and the phase's counted launches.
``torch.device("cuda")`` is left naming the card, so the trainers that
``--platform auto`` makes time their calls as on the card."""

import os

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import REPO, phases_json  # noqa: E402


def test_chip_smoke_clis_rehearsal_on_cpu():
    r, out, lines = phases_json([10], 300)
    summary, k = out["summary"], out["launches"]
    p10 = summary["training_cli"]
    p10_k = summary["training_cli_launches"]
    runs10 = [p10["vqa"], p10["nextqa"]]
    for run in runs10:
        c = run["counts"]
        steps = c["train_steps"] + c["replay_steps"]
        assert run["launches"] == run["expected_launches"] == [
            2 * c["predict_batches"], 2 * steps, 2 * steps]
        assert run["strided_launches"] == run["launches"]
        assert c["replay_steps"] > 0
    assert len(p10["vqa"]["task_wall_s"]) == 10
    assert len(p10["vqa"]["checkpoint_save_ms"]) == 10
    test10 = p10["vqa_test"]
    assert test10["equal_to_training"]
    assert test10["result_matrix"] == p10["vqa"]["result_matrix"]
    assert test10["launches"] == test10["strided_launches"] == [
        2 * test10["predict_batches"], 0, 0]
    assert test10["predict_batches"] == 55
    assert p10["backbone"] == {"bit_equal": True, "scratch_differs": True,
                               "start_s": p10["backbone"]["start_s"]}
    nq = p10["nextqa"]
    assert nq["encoder_len"] == 39 and len(nq["task_wall_s"]) == 2
    assert nq["wups_backend"] == ["vendored-taxonomy"]
    assert 0.0 <= nq["wups_vocab_coverage"][0] <= 1.0
    for name, cls in (("vqa", "CompVQACLTrainer"),
                      ("nextqa", "VQACLTrainer")):
        t = p10["tiny"][name]
        assert t["cls"] == cls and all(t["equal"].values())
        assert t["loss_rel_err"] <= 1e-5 and min(t["launches"]) > 0
        assert f"cli tiny f32 {name} ({cls}), --platform auto on cuda vs " \
            f"cpu on cpu" in r.stdout
    assert p10_k == [sum(x["launches"][i] for x in runs10
                         + [test10] + list(p10["tiny"].values()))
                     for i in range(3)]
    assert p10_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    assert "feature store PackedFeatureStore" in r.stdout
    assert "cli_vqa: Test() matrix == the training run's: True" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase10"))
