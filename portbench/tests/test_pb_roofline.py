"""The roofline bytes against the kernel bounds of ``PERF.md`` §6: K1
34.4 MB at the eval shape, K1' 39.6 MB and K2 60.2 MB at the train
shape; at NExT-QA's 39 x 39, 24.0 / 25.0 / 39.4 MB."""

import pytest

from portbench import spec
from portbench.roofline import encoder_attention as ea


@pytest.mark.parametrize("cell,kind,batch,mb", [
    ("vqa_cl_train", "fwd", 100, 34.4),
    ("vqa_cl_train", "fwd_train", 80, 39.6),
    ("vqa_cl_train", "bwd", 80, 60.2),
    ("nextqa_cl_train", "fwd", 100, 24.0),
    ("nextqa_cl_train", "fwd_train", 80, 25.0),
    ("nextqa_cl_train", "bwd", 80, 39.4),
])
def test_bytes(cell, kind, batch, mb):
    m = spec.load(cell).config
    nbytes, _ = ea.work(kind, *ea.shape(m, batch), "bfloat16")
    assert round(nbytes / 1e6, 1) == mb


def test_bound_is_bytes_at_these_shapes():
    m = spec.load("vqa_cl_train").config
    for kind in ("fwd", "fwd_train", "bwd"):
        nbytes, flops = ea.work(kind, *ea.shape(m, 80), "bfloat16")
        assert ea.bound_s(kind, m, 80, "bfloat16") == \
            nbytes / ea.HBM_BYTES_PER_S
        assert flops / ea.PEAK_FLOPS["bfloat16"] < \
            nbytes / ea.HBM_BYTES_PER_S
    # K1 at the eval shape: 0.01028 ms (PERF.md §6)
    assert abs(ea.bound_s("fwd", m, 100,
                          "bfloat16") * 1e3 - 0.01028) < 1e-5
