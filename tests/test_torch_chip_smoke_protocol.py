"""chip_smoke.py phase 14 (``smoke/protocol.py``) rehearsed on the CPU
(``smoke_rehearsal``): the Table-1 surrogate's three rows at a few items
per task, each a process of the rehearsal in rank mode (each row's
launches against its counts, all on the scalar f32 route; the
orderings' margins lowered, as only the real size can show them:
``test_phase14_orderings`` holds the real ones), the cut row on the
"card" against the CPU at both learning rates and a ten-task soak at
tiny widths (its 55-cell matrix and launches), all counted."""

import os

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import REPO, phases_json  # noqa: E402


def test_chip_smoke_protocol_rehearsal_on_cpu():
    r, out, lines = phases_json([14], 300, init=False)
    summary, k = out["summary"], out["launches"]
    # (a) the surrogate's rows, each row's launches what its counts imply,
    # all on the scalar f32 route, the orderings checked; (b) the cut row
    # on the card == on the CPU; (c) the ten-task soak's 55-cell matrix and
    # its launches, all on the bf16 route
    p14 = summary["protocol_runs"]
    p14_k = summary["protocol_runs_launches"]
    rows14 = p14["surrogate"]["rows"]
    assert list(rows14) == ["vanilla", "er", "ours"]
    for name, row in rows14.items():
        c = row["counts"]
        steps = c["train_steps"] + c.get("replay_steps", 0) \
            + c.get("importance_batches", 0)
        assert row["launches"] == row["expected_launches"] == [
            2 * c["predict_batches"], 2 * steps, 2 * steps], name
        assert [r_["scalar"] for r_ in row["route_launches"]] == \
            row["launches"], name
        assert [r_["mma"] for r_ in row["route_launches"]] == [0, 0, 0]
        assert (c.get("replay_steps", 0) > 0) == (name != "vanilla")
        assert row["seed"] == 0 and row["wall_s"] > 0
        assert {"Avg_acc", "Avg_forget", "diag_acc"} <= set(row)
        assert f"p14_{name}: Avg_acc {row['Avg_acc']} Avg_forget " in r.stdout
        assert row["route_launches"][0]["scalar"] == row["launches"][0]
    assert [t[1] for t in p14["surrogate"]["orderings"]] == [True] * 3
    assert sum(l.startswith("p14 ordering: ") for l in lines) == 3
    cut = p14["cut"]
    assert list(cut) == ["surrogate_lr", "lr_0.001"]
    for tag, run in cut.items():
        assert all(run["equal"].values()), tag
        assert run["launches"] == run["expected_launches"], tag
        assert min(run["launches"]) > 0 and run["counts"]["replay_steps"] > 0
    # the losses are held to CL_LOSS_RTOL at lr 1e-3, recorded at 1e-2
    assert cut["lr_0.001"]["equal"]["losses"]
    assert cut["lr_0.001"]["loss_rel_err"] <= 1e-5
    assert "losses" not in cut["surrogate_lr"]["equal"]
    soak = p14["soak"]
    assert soak["matrix_complete"] and len(soak["task_wall_s"]) == 10
    assert soak["launches"] == soak["expected_launches"]
    assert min(soak["launches"]) > 0
    assert [r_["mma"] for r_ in soak["route_launches"]] == soak["launches"]
    assert "p14 soak: 10 tasks, 55-cell matrix complete True" in r.stdout
    assert any(l.startswith("SOAK small: ") for l in lines)
    assert p14_k == [sum(x["launches"][i] for x in [*rows14.values(),
                                                     *cut.values(), soak])
                     for i in range(3)]
    assert p14_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    # the rows ran as processes of the script in rank mode, side by side
    for name in rows14:
        assert any(l.startswith(f"rank {list(rows14).index(name)}: p14_"
                                f"{name}: Avg_acc ") for l in lines), name
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase14"))
