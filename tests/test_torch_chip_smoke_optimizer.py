"""chip_smoke.py phase 15 (``smoke/optimizer.py``) rehearsed on the CPU
(``smoke_rehearsal``), the fused optimizer's wrapper replaced by its
checks and plan plus the plain version and a launch counter (every
update takes it, as every update on the card takes the kernels): its 16
combinations, Adam counts, strided gradients, norm and
``_apply_update`` record, and its row of the kernels line."""

import pytest

pytest.importorskip("torch")

from smoke_rehearsal import phases_json  # noqa: E402


def test_chip_smoke_optimizer_rehearsal_on_cpu():
    r, out, lines = phases_json([15], 300)
    summary, k = out["summary"], out["launches"]
    # the 16 combinations and Adam counts bit for bit (here the stand-in is
    # the plain version itself), its norm, _apply_update's two kernels of
    # the pair (counted), times against the bound
    p15 = summary["fused_optimizer"]
    assert len(p15["combos"]) == 16
    for name, c in p15["combos"].items():
        assert c["mismatched"] == 0, name
        assert all((x >= 5.0) == name.endswith("clip=on")
                   for x in c["grad_norms"]), name
    assert p15["powf_mismatched"] == {} and p15["powf_counts"] == 71
    assert p15["strided"]["leaves"] > 0 and p15["strided"]["mismatched"] == 0
    assert p15["norm"]["rel"] <= 2e-6 and p15["norm"]["same_bits_3_launches"]
    au = p15["apply_update"]
    assert au["sync_error"] is None and au["kernel_pair_launches"] == 2
    assert au["counters"]["optim.fused_leaves"] == p15["n_leaves"]
    assert p15["bound_by"] == "bytes" and p15["bytes"] == 24 * p15["n_params"]
    assert k["fused_adamw"]["launches"] == 2
    assert sum(l.startswith("fused_adamw ") for l in lines) == 16 + 4
    assert any(l.startswith("kernel_time fused_adamw: ") for l in lines)
    # its record is the kernels line's fused_adamw row
    opt = out["rows"]["fused_adamw"]
    assert opt["library_ms"] is None and opt["max_abs_err"] == 0.0
    assert p15["phase_s"] >= 0
