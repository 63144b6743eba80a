"""``BENCHMARK.json`` against the contract's form: keys, names, units,
lengths, and a file for every configuration, cell, mix and metric."""

import json
import os
import re

import pytest

from portbench import spec

ROOT = spec.ROOT
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == KEYS
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in
                       ("d_model", "d_ff", "d_kv", "num_heads")
                       for k in c["reduced"])


def test_workloads():
    names = {c["name"] for c in B["configs"]}
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load(w["name"], B)
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(ROOT, "portbench", "entries",
                                           f"{cell.entry}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{cell.traffic['generator']}.py"))
    used = {w["config"] for w in B["workloads"]}
    assert used == names


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B[group]:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) <= allowed
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           f"{m['name']}.py"))
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert line(m["layer"]) and m["moves"] in e2e
            moved = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert "setup_s" in e2e


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        cell = spec.load(w["name"], B)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert any("mfu" in m["name"] for m in cell.per_layer)


def test_layer_names_one_spelling():
    by = {}
    for m in B["per_layer"]:
        by.setdefault(m["layer"].split()[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in by.items() if k != "train/step.py")
