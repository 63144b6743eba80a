"""chip_smoke.py phase 9 (``smoke/extensions.py``) rehearsed on the CPU
(``smoke_rehearsal``): the strided kernel checks, the merged and folded
paths, the classifier head, weight import/export, the directory
checkpoint and VL-BART (tiny BART widths), from a checkpoint of phase 3's
model standing in for phase 7's."""

import os

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import REPO, phases_json  # noqa: E402

def test_chip_smoke_extensions_rehearsal_on_cpu():
    r, out, lines = phases_json(
        [9], 300, attrs=", p7=R.p7_checkpoint, dcp=R.serial_dcp_writer",
        after="import os\nfrom smoke import harness as h\n"
              "out['p7_left'] = os.path.exists(h.P7_DIR)")
    summary, k = out["summary"], out["launches"]
    # K1 in 6 eval steps (greedy and beam, separate, merged and folded)
    # and 3 classifier evals; K1'/K2 in 3 rounds of 4 train steps with the
    # plain (2 layers) and the fused decoder (6 attentions), and in 5
    # classifier steps
    p9 = summary["model_extensions"]
    p9_k = summary["model_extensions_launches"]
    assert p9_k[0] == 2 * (6 + 3)
    assert p9_k[1] == p9_k[2] == 3 * 4 * (2 + 6) + 5 * 2
    assert p9_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    # the fused optimizer's pair in each of the 3 rounds of 4 merged and
    # separate train steps of both paths
    assert k["fused_adamw"]["launches"] == 2 * 3 * 4 * 2
    # strided K1/K1'/K2 bit-equal to dense at every shape and layout, the
    # bad stride refused, merged/folded steps, tokens, the classifier
    # head, weights through .pth/.safetensors/export/DCP, VL-BART
    checks = [l for l in lines if l.startswith("strided_check ")
              and "refused" not in l]
    assert len(checks) == 2 * 6 + 3
    assert all('"K1\'": true, "K2": true, "K2 merged buffer": true' in l
               and "strided launches K1/K1'/K2 [" in l for l in checks)
    assert sum("layout=folded" in l for l in checks) == 2
    assert sum(l.startswith("strided_time ") for l in lines) == \
        3 * 2 + 1 + 2
    assert "K1, K1' and K2 raise ValueError before any launch" in r.stdout
    for label, per_step in (("encoder", 2), ("fused_decoder", 6)):
        t = p9["train"][label]
        assert t["launches_per_merged_step"] == [[0, per_step, per_step]] * 2
        assert t["grad_rel"] <= 3e-2 and t["loss_rel"] <= 3e-2
        assert len(t["train_step_ms_all"]["merged"]) == 2 * 2
    assert p9["decode_tokens_equal"] == {
        "greedy": {"merged": True, "folded": True},
        "beam5": {"merged": True, "folded": True}}
    assert all(t["tokens_equal"] and t["loss_rel_err"] <= 1e-5
               for t in p9["tiny_merged_folded"].values())
    cls = p9["classifier"]
    assert len(cls["losses"]) == 5 and cls["losses"][-1] < cls["losses"][0]
    assert cls["eval_launches"] == [[6, 0, 0], [6, 0, 0]]
    assert all(p9["io_equal"].values()) and set(p9["io"]) == {
        "pth", "safetensors", "export_pth", "dcp"}
    assert all(r_["bytes"] > 0 for r_ in p9["io"].values())
    assert p9["bart"]["finite"] and p9["bart"]["shape_ok"]
    assert p9["bart"]["tiny_f32_err_over_tol"] <= 1.0
    # phase 7's checkpoint and phase 9's files are gone
    assert not out["p7_left"]
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase9"))
