"""chip_smoke.py phases 1, 2 and 6 (``smoke/kernels.py``) rehearsed on
the CPU (``smoke_rehearsal``): every kernel check against its plain
version, on its route, bit-equal on a second launch; the timed rows of
the kernels line; K5 in the ``mm_bench`` probe, counted."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_kernels_rehearsal_on_cpu():
    r, out, lines = phases_json([1, 2, 6], 300, init=False)
    summary, rows = out["summary"], out["rows"]
    # K1/K1′/K2 name their route; every check launches twice with equal
    # bits
    checks = [l for l in lines if l.startswith("kernel_check ")
              and not l.startswith("kernel_check dw_")
              and not l.startswith("kernel_check head_")
              and not l.startswith("kernel_check refused")]
    assert all("second launch equal: True" in l for l in checks
               if "rate=" not in l)
    assert all(("route=mma.sync bf16" in l) == ("bfloat16" in l)
               and ("route=scalar f32" in l) == ("float32" in l)
               for l in checks)
    assert all("K2 route=mma.sync bf16" in l or "K2 route=scalar f32" in l
               for l in checks if "rate=" in l)
    assert all("second launch equal: K1' True, K2 True" in l
               for l in checks if "rate=" in l)
    assert "rate=0.1 kept=0.9" in r.stdout
    # K1 at the DER capture's shape (the train batch), bf16
    assert sum(l.startswith("kernel_check capture_shape:") and "bfloat16" in l
               for l in checks) == 1
    # the bf16 routes' edges: K1 once, K1′ and K2 at rates 0 and 0.1
    for name in ("ragged_bf16", "keys128_bf16", "keys300_bf16",
                 "dk128_bf16"):
        assert sum(l.startswith(f"kernel_check {name}:") for l in checks) \
            == 3, name
        assert sum(l.startswith(f"kernel_check {name}:") and "dv=" in l
                   for l in checks) == 2, name
    assert "kernel_check refused_bf16_dk8: K1 and K1' raise ValueError" \
        in r.stdout
    assert "kernel_check refused_bwd_keys512_bf16: a training call raises " \
        "ValueError before K1' launches" in r.stdout
    # NExT-QA's 39 x 39 shape: K1 at the eval batch, K1' and K2 at rates 0
    # and 0.1, dense and strided, each timed once
    for name, n in (("nextqa_eval_shape", 1), ("nextqa_train_shape", 2)):
        assert sum(l.startswith(f"kernel_check {name}:") and "Tq=39 Sk=39"
                   in l and "L=23" in l for l in lines) == n, name
        assert sum(l.startswith(f"strided_check {name}:") for l in lines) \
            == n, name
    assert set(summary["nextqa_kernel_times"]) == {"K1", "K1p", "K2"}
    strided = [l for l in lines if l.startswith("strided_check ")]
    assert len(strided) == 3 and all(
        '"K1\'": true, "K2": true, "K2 merged buffer": true' in l
        and "strided launches K1/K1'/K2 [" in l for l in strided)
    # the surrogate's encoder (4 heads of 8 over 10 positions) in f32, K1
    # once and K1'/K2 at rates 0 and 0.1
    assert sum(l.startswith("kernel_check surrogate_f32:") and "Tq=10 Sk=10"
               in l and "float32" in l for l in lines) == 3
    # a second tp rank's heads (phase 13's record): bit-equal to those of
    # the one launch
    assert all(out["head_off"]["same"].values())
    assert out["head_off"]["heads"] == [1, 2]
    assert any(l.startswith("head_offset_check: heads 1..1 of 2")
               for l in lines)
    # K5: the ladder, the probe, the odd shapes (bf16 and f32) and the f32
    # probe, each on its route; launched by mm_bench on the wgmma route
    # (3 input sets warmed up + 2 timed calls), those launches counted
    dw_lines = [l for l in lines if l.startswith("kernel_check dw_")]
    assert len(dw_lines) == 2 + 1 + 4 + 1
    assert all(l.endswith("-> ok") for l in dw_lines)
    assert sum("route=wgmma N=256 (plan: " in l
               for l in dw_lines) == 2 + 1 + 1
    assert [l.split()[1] for l in dw_lines if "route=mma" in l] == \
        ["dw_odd:"]
    assert sum("route=f32" in l for l in dw_lines) == 3
    assert "kernel_time dw_probe (wgmma): " in r.stdout
    assert "mlp_wi dW dw_splitk (CUDA, K5)" in r.stdout
    assert out["launches"]["dw_splitk"]["launches"] == 5
    assert summary["mm_bench_dw_route_launches"] == {"wgmma": 5, "mma": 0,
                                                     "f32": 0}
    assert {"ms", "library_ms", "library_bf16_ms", "bound_ms"} <= \
        set(summary["k5_probe"])
    assert len(summary["mm_bench"]) == 12
    # N1: the RPN, sweep, all-invalid and scarce cases, bit-equal to its
    # plain version twice; the RPN and sweep shapes timed; no check counted
    n1_checks = [l for l in lines if l.startswith("kernel_check nms_")]
    assert len(n1_checks) == 4
    assert all("differing from plain=0" in l and "second launch equal: True"
               in l for l in n1_checks)
    assert sum(l.startswith("kernel_time nms_") for l in lines) == 2
    assert set(summary["nms_kernel_times"]) == {"rpn", "sweep"}
    # the head loss at VL-T5's tied and VL-Moonlight's untied shapes: its
    # route, each launch counted, a second run equal, timed
    head = [l for l in lines if l.startswith("kernel_check head_")]
    assert [l.split(":")[0] for l in head] == [
        "kernel_check head_vlt5", "kernel_check head_moonlight"]
    assert all("route=wgmma" in l and l.endswith("-> ok") and
               "second launch equal: True" in l and '"head_lse": 2, '
               '"head_dlogits": 1, "dw_splitk wgmma": 2' in l and
               "K5 dh/dshared max_abs_err " in l and "+ 1e-6: True;" in l
               for l in head)
    assert sum(l.startswith("kernel_time head_") for l in lines) == 2
    # K5's row of the kernels line: its two products at the last shape
    moon = summary["head_loss"]["head_moonlight"]
    assert rows["dw_splitk"] == moon["k5"]
    assert rows["dw_splitk"]["ms"] == sum(moon["k5_ms"].values())
    assert moon["bound3_by"] in ("bytes", "operations")
    assert set(summary["head_loss"]) == {"head_vlt5", "head_moonlight"}
    # the kernels line's timed rows; nothing of phase 2 is counted
    assert set(rows) == {"fused_attention_fwd", "fused_attention_fwd_train",
                         "fused_attention_bwd", "dw_splitk", "greedy_nms",
                         "head_lse", "head_dlogits"}
    for row in rows.values():
        assert row["bound_by"] in ("bytes", "operations")
    assert rows["greedy_nms"]["library_ms"] is None
    assert all(v == {"launches": 0, "offset_launches": 0,
                     "head_offset_launches": 0}
               for k, v in out["launches"].items() if k != "dw_splitk")
    assert set(summary["kernel_call_ms"]) == {"K1", "K1p"}
    assert set(summary["kernel_bytes_flops"]) == {"K1p", "K2", "K5"}
