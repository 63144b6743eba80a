"""chip_smoke.py phase 17 (``smoke/graphs.py``) rehearsed on the CPU
(``smoke_rehearsal``), the train step's graphs through
``tests/torch_graph_fake.py`` (a capture that leaves no trace, replays
that count nothing themselves): eager and graphed steps in turns, bit
for bit after each, one capture and replays, K1'/K2 2 each a step (2
layers) and the head loss's H1, H2 and two K5 products counted on replays
as on eager steps, the fused optimizer's pair in every update, then the
timed steps of each."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_graph_rehearsal_on_cpu():
    r, out, lines = phases_json([17], 300, attrs=", fake=R.graph_fake")
    summary, k = out["summary"], out["launches"]
    p17 = summary["graph_replay"]
    steps, timed = p17["steps"], 20
    assert p17["mismatched"] == [0] * steps
    assert (p17["captures"], p17["eager_steps"]) == (1, 1)
    assert p17["replays"] == steps - 1 + timed
    assert p17["launches"] == [0, 2 * 2 * steps, 2 * 2 * steps]
    assert summary["graph_replay_launches"] == \
        [0] + [2 * 2 * (steps + timed)] * 2
    assert summary["graph_replay_launches"] == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    assert k["fused_adamw"]["launches"] == 2 * 2 * steps + 2 * 2 * timed
    # the head loss's H1 (2 launches), H2 (1) and its two K5 products on
    # the wgmma route a step in each run, replays included
    assert p17["head_launches"] == {"eager": [2 * steps, steps, 2 * steps],
                                    "graphed": [2 * steps, steps, 2 * steps]}
    assert k["head_lse"]["launches"] == 2 * 2 * (steps + timed)
    assert k["head_dlogits"]["launches"] == 2 * (steps + timed)
    assert k["dw_splitk"]["launches"] == 2 * 2 * (steps + timed)
    assert set(p17["timed"]) == {"eager", "graphed"}
    assert "graph_replay: bs 8 bf16, 8 train/replay steps" in r.stdout
