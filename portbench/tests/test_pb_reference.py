"""The reference against the port at tiny widths on the CPU, in float32:
the same dropout masks (the trainer's stream and the kernels' Philox
bits), so the first three steps agree to rounding."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("name", ["vqa_cl_train", "nextqa_cl_train"])
def test_first_steps_agree(name):
    torch.manual_seed(0)
    out = harness.execute(tiny.cell(name), SEED, 0.5, False,
                          torch.device("cpu"), 0.0)
    n = out["numbers"]
    assert n["loss"]["value"] < 1e-5
    # the program's first gradient comes back through a bf16 moment
    assert n["grad1"]["value"] < 8e-3
    assert n["change3"]["value"] < 1e-3
    assert out["rec"]["failed"] == 0 and out["rec"]["rows"] > 0


def test_control_reads_far_above_the_program():
    out = harness.execute(tiny.cell("vqa_cl_train"), SEED + 1, 0.0, False,
                          torch.device("cpu"), 0.0, precision="fp8")
    n = out["numbers"]
    for k in ("loss", "grad1", "change3"):
        assert n[k]["control"] > 5 * n[k]["value"], (k, n[k])
    # judged as the program is, the control fails limits the program meets
    limits = {"loss": 1e-5, "grad1": 8e-3, "change3": 1e-3}
    assert harness.verdict(n, limits, out["rec"])[0]
    assert not harness.control_verdict(n, limits)[0]


@pytest.mark.card
def test_control_at_the_cells_size(card):
    """The control on the card at the cell's own size: the fp8 reference
    in the program's place fails the cell's limits."""
    from portbench import spec
    for name in ("vqa_cl_train", "nextqa_cl_train"):
        cell = spec.load(name)
        out = harness.execute(cell, SEED, 0.0, False, card, 0.0,
                              precision="fp8")
        n = out["numbers"]
        assert any(n[k]["control"] > cell.limits[k] for k in cell.limits)
        assert all(n[k]["value"] <= cell.limits[k] for k in cell.limits)
