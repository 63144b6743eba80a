"""chip_smoke.py phase 11 (``smoke/extraction.py``) rehearsed on the CPU
(``smoke_rehearsal``): the detector and the 3D ResNeXt at reduced depth
(one narrow block per stage, C4 1024, res5 and the motion features 2048
wide), a 64-px resize, 40 proposals and 32-px videos: the per-image stage
times, two N1 launches per image, the CLI's record generator into a pack
read back bit for bit and answered through K1, the f32 stage checks and
both motion halves; N1 and K1 counted."""

import os

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import REPO, phases_json  # noqa: E402


def test_chip_smoke_extraction_rehearsal_on_cpu():
    r, out, lines = phases_json([11], 300)
    summary, k = out["summary"], out["launches"]
    p11 = summary["extraction"]
    p11_k = summary["extraction_launches"]
    assert len(p11["images"]) == 4 and p11["n1_per_image"] == 2
    assert len({tuple(i["bucket"]) for i in p11["images"]}) >= 2
    for im in p11["images"]:
        assert list(im["stage_ms"]) == ["backbone", "rpn", "roi_align",
                                        "res5_heads", "nms36", "attr"]
    assert p11["cli"] == {"records": 4, "write_s": p11["cli"]["write_s"],
                          "answers": 16, "k1": 2}
    assert p11_k == [2, 0, 0]
    assert p11_k == [k[n]["launches"] for n in (
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd")]
    assert "bit for bit: True" in r.stdout
    assert all(p11["f32"]["bit_equal"].values())
    assert max(p11["f32"]["rel_err"].values()) <= 1e-4
    assert p11["batch"]["c4_rel_err"] <= 1e-4
    assert set(p11["video"]) == {"rgb_diff", "resnext3d"}
    assert set(p11["video"]["resnext3d"]["parts"]) == {
        "load_clips_ms", "resize_ms", "resnext3d_ms"}
    assert all(i["resize_ms"] > 0 for i in p11["images"])
    assert all(len(v["ms"]) == 2 for v in p11["video"].values())
    # N1 on the main path: four warm-up and four timed images, the CLI's
    # four records, two launches each
    assert summary["extraction_n1_launches"] == \
        k["greedy_nms"]["launches"] == 2 * 12
    assert "phase 11: TF32 flags restored" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase11"))
