"""chip_smoke.py phase 12 (``smoke/dp.py``) rehearsed on the CPU
(``smoke_rehearsal``): the one-rank mesh (over gloo here, as NCCL needs a
card) against the meshless steps, and its two ranks started by the
script (each the rehearsal in rank mode, over gloo on the CPU): the
replicated and FSDP steps, the kernels at the second rank's row offset
(the plain versions here), the tiny CL run with the sharded cache on the
"card" and on the CPU, and their launches and offset launches counted —
2 steps per run and 16/8/8 items per task in the tiny run."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_dp_rehearsal_on_cpu():
    r, out, lines = phases_json([12], 300, init=False)
    summary, k = out["summary"], out["launches"]
    # (a) 2 steps of 2 layers on a one-rank mesh, bit-equal to the
    # meshless steps; (b)-(c) 2 steps per rank of each of the three runs
    # (dropout 0, 0.1, FSDP), the second rank's at its row offset; (d) the
    # tiny runs' launches on the card
    p12 = summary["data_parallel"]
    p12_k = summary["data_parallel_launches"]
    assert p12["one_rank"]["bit_equal"]
    assert p12["one_rank"]["launches"] == [0, 4, 4]
    tiny12 = p12["tiny"]["launches"]
    assert p12_k == [sum(t[0] for t in tiny12),
                     4 + 2 * 3 * 4 + sum(t[1] for t in tiny12),
                     4 + 2 * 3 * 4 + sum(t[2] for t in tiny12)]
    assert p12_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    assert min(min(t) for t in tiny12) > 0
    # rank 1 runs every step at its offset: 3 runs x 2 steps x 2 layers
    # and its tiny run's train and replay steps
    assert summary["data_parallel_offset_launches"] == [
        3 * 4 + tiny12[1][1], 3 * 4 + tiny12[1][2]]
    assert summary["data_parallel_offset_launches"] == [
        k["fused_attention_fwd_train"]["offset_launches"],
        k["fused_attention_bwd"]["offset_launches"]]
    assert all(p12["offset_check"]["same"].values())
    assert p12["rel_to_one_process"] <= 3e-2
    assert p12["fsdp_rel_to_replicated"] <= 3e-2
    assert p12["tiny"]["equal"] == {"result_matrix": True, "answers": True,
                                    "ranks": True}
    assert p12["tiny"]["loss_rel_err"] <= 1e-5
    assert p12["tiny"]["lookups"] > 0
    assert p12["all_reduce_bytes_per_step"] > 0
    # the tiny model shards its embedding alone: 0.518 of the state here,
    # ~0.500 at t5-base
    assert p12["state_bytes"]["fsdp"] / p12["state_bytes"]["replicated"] \
        <= 0.52
    assert "bit-equal to the meshless step: True" in r.stdout
    assert "dp all_reduce: one flat f32 bucket of" in r.stdout
    assert sum(l.startswith("rank 1: offset_check:") for l in lines) == 1
