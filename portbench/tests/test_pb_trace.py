"""The trace's arithmetic on made-up events, and a traced run of a tiny
cell on the CPU: a device-only sub-window for the numbers and a host
sub-window for the idle gaps."""

import pytest
import torch

from portbench import harness, trace
from portbench.tests import tiny


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("kernel", "k_a", 0, 10), ev("kernel", "k_b", 5, 10),   # overlap
    ev("gpu_memcpy", "Memcpy HtoD", 30, 5),
    ev("kernel", "k_a", 50, 10),
    ev("cpu_op", "aten::mul", 12, 30), ev("cpu_op", "aten::copy_", 40, 5),
    ev("user_annotation", "bench.train_step", 0, 100),
    ev("user_annotation", "other", 0, 100),
]


def test_union_launches_and_op_time():
    t = trace.Trace(EVENTS, 1e-4)
    assert t.busy == [(0.0, 15.0), (30.0, 35.0), (50.0, 60.0)]
    assert t.busy_s == pytest.approx(30e-6)
    assert t.launches == 3
    assert t.op_time_s(["^k_a$"]) == (2, pytest.approx(20e-6))


def test_device_ops_and_idle_gaps():
    t = trace.Trace(EVENTS, 1e-4)
    # kernels only: the copy counts as busy time, not as an op
    assert t.device_ops() == [["k_a", pytest.approx(20e-6)],
                              ["k_b", pytest.approx(10e-6)]]
    gaps = dict(t.idle_gaps())
    # 15 → 30 starts inside aten::mul, 35 → 50 inside aten::mul as well
    assert gaps == {"train_step: aten::mul": pytest.approx(30e-6)}
    b = trace.breakdown(t, None)
    assert b["idle_gaps"] == [] and len(b["device_ops"]) == 2


def test_traced_tiny_run_has_both_sub_windows():
    cell = tiny.cell("vqa_cl_train")
    out = harness.execute(cell, 2 ** 31 + 11, 0.2, True,
                          torch.device("cpu"), 0.0)
    rec = out["rec"]
    assert rec["trace_steps"] == 2
    assert rec["trace"].wall_s > 0 and rec["host_trace"].wall_s > 0
    # the host sub-window carries the benchmark's labels
    assert any(n == "train_step" for _, n in rec["host_trace"].labels)
    b = trace.breakdown(rec["trace"], rec["host_trace"])
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_idle_at_the_windows_pace():
    from portbench.harness import reader
    t = trace.Trace(EVENTS, 1e-4)            # 30 us busy over 2 steps
    rec = {"trace": t, "trace_steps": 2, "window_s": 1e-3, "steps": 20}
    # 15 us busy per step of 50 us: idle 70 %, whatever the sub-window's
    # own wall
    assert reader("device_idle.train")(rec, None) == pytest.approx(70.0)
    assert reader("device_idle.train")({}, None) is None
