"""chip_smoke.py phase 13 (``smoke/tppp.py``) rehearsed on the CPU
(``smoke_rehearsal``): the tp, pp and tp x pp groups (two, two and four
ranks of the rehearsal in rank mode, 2 layers of 2 heads) against their
one-process steps, the tiny tp and pp ER runs (8/8/8 items) against the
CPU's and one process's, and the launches the ranks report, counted;
phase 2's head-offset check (a stand-in here) in its record."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_tppp_rehearsal_on_cpu():
    r, out, lines = phases_json([13], 300, init=False,
                                attrs=", head_off={'stand_in': True}")
    summary, k = out["summary"], out["launches"]
    # (a) tp = 2, 3 steps at dropout 0 and 0.1, 2 K1′ + 2 K2 per step per
    # rank, rank 1's over its head; (b) pp = 2, 2 steps, one layer per
    # stage x 4 microbatches; (c) tp x pp on four ranks; (d) the tiny runs
    # equal the CPU's and one process's, rank 0's checkpoint loaded
    p13 = summary["tensor_pipeline"]
    p13_k = summary["tensor_pipeline_launches"]
    assert p13["head_offset_check"] == {"stand_in": True}
    for part, keys_ in (("tp", ("d0", "d0.1")), ("pp", ("d0",)),
                        ("tppp", ("d0",))):
        for key in keys_:
            run = p13[part][key]
            assert run["rel_to_one"] <= 0.25 and run["loss_rel_err"] <= 1e-2
            assert len(run["step_ms"]) == (4 if part == "tppp" else 2)
    assert p13["tp"]["d0"]["all_reduce_per_step"]["all_reduce_tp_bytes"] > 0
    assert "all_reduce_dpp_bytes" not in p13["tp"]["d0"][
        "all_reduce_per_step"]
    assert p13["tp"]["d0"]["state_ratio"] < 1
    assert p13["pp"]["ticks"] == 5 and p13["pp"]["bucket_bytes"] > 0
    assert p13["pp"]["d0"]["all_reduce_per_step"][
        "all_reduce_dpp_bytes"] == p13["pp"]["bucket_bytes"]
    for part in ("tp", "pp"):
        assert all(p13[part]["tiny"]["equal"].values()), part
    tiny13 = p13["tp"]["tiny"]["launches"] + p13["pp"]["tiny"]["launches"]
    # per rank: tp 2 x 3 steps x 2 layers; pp 2 steps x 4 microbatches;
    # tp x pp 2 steps x 4 microbatches on four ranks
    assert p13_k == [sum(t[0] for t in tiny13),
                     2 * 12 + 2 * 8 + 4 * 8 + sum(t[1] for t in tiny13),
                     2 * 12 + 2 * 8 + 4 * 8 + sum(t[2] for t in tiny13)]
    assert p13_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    head13 = summary["tensor_pipeline_head_offset_launches"]
    assert head13[0] == head13[1] == \
        k["fused_attention_fwd_train"]["head_offset_launches"] == \
        k["fused_attention_bwd"]["head_offset_launches"] == \
        12 + 2 * 8 + p13["tp"]["tiny"]["launches"][1][1]
    assert summary["tensor_pipeline_offset_launches"] == [
        k["fused_attention_fwd_train"]["offset_launches"],
        k["fused_attention_bwd"]["offset_launches"]]
    for part in ("tp", "pp"):
        for where in ("cuda", "cpu"):
            assert any(l.startswith(f"rank 0: p13_tiny_{part}_{where}_rank0:"
                                    f" wall ") for l in lines), (part, where)
    assert any(l.startswith("p13_tiny_one: wall ") for l in lines)
