"""The VL-Moonlight cell: its files through ``spec.load``, its reference
importing nothing of the port, the reference's tree against the
program's, the FLOPs count and the grouped GEMMs' roofline against sums
by hand, the reference routed by held choices, and the cell's entry at
tiny widths on the CPU in float32 (the first steps agree with the
reference, routed on its own and by the program's choices; half a batch
does not)."""

import copy
import json
import os

import pytest
import torch

from portbench import harness, spec
from portbench.entries import cl_train_moonlight as E
from portbench.reference import moonlight as RM
from portbench.roofline import moe_experts
from portbench.tests import test_pb_imports
from portbench.tests.test_pb_faults import broken_step

CELL = "vqa_cl_train_moonlight"
SEED = 2 ** 31 + 123
TINY = dict(hidden_size=32, num_attention_heads=2, num_hidden_layers=3,
            intermediate_size=48, moe_intermediate_size=16,
            n_routed_experts=4, router_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, feat_dim=16)
LIMITS = {"loss": 1e-5, "grad1": 1e-3, "change3": 1e-3}


def tiny_cell(limits=None):
    c = spec.load(CELL)
    cfg = copy.deepcopy(c.config)
    cfg.update(TINY)
    cfg.update(n_boxes=4, max_text_length=8, target_max_length=5,
               gen_max_length=6)
    cfg["precision"] = dict(cfg["precision"], compute="float32")
    cfg["train"] = dict(cfg["train"], batch_size=8, valid_batch_size=8,
                        m_size=40)
    mix = copy.deepcopy(c.traffic)
    mix["images"] = 64
    mix["splits"] = [dict(s, qa=min(s["qa"], 160)) for s in mix["splits"]]
    wl = copy.deepcopy(c.workload)
    wl["params"] = dict(wl.get("params", {}), trace_pairs=1)
    if limits is not None:
        wl["limits"] = limits
    return spec.Cell(CELL, wl, cfg, mix, c.end_to_end, c.per_layer)


def test_the_cells_files_load():
    cell = spec.load(CELL)
    assert cell.workload["config"] == "vl_moonlight_a3b_vqa"
    assert cell.traffic["generator"] == "qa" and cell.chips == 1
    assert cell.config["arch"] == "moonlight"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "train_qa_per_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "train_mfu", "launches_per_step.train", "device_idle.train",
        "loader_wait.train", "moe_gemm_roofline.train",
        "moe_device_ms.train", "mla_device_ms.train"}
    assert set(cell.limits) == {"loss", "grad1", "change3", "grad1_held",
                                "change3_held"}


def test_the_configuration_keeps_the_catalog_row():
    """Every key of the published config.json, as published, but the two
    that ``reduced`` lists, whose published values it states."""
    path = os.path.join(spec.HERE, "configs", "vl_moonlight_a3b_vqa.json")
    body = json.load(open(path))
    published = dict(body["published"])
    assert sorted(published) == sorted(body["reduced"])
    assert published == {"num_hidden_layers": 27, "n_routed_experts": 64}
    assert body["num_hidden_layers"] == 14 and body["n_routed_experts"] == 8
    assert body["router_experts"] == 64 and body["num_experts_per_tok"] == 6
    assert body["hidden_size"] == 2048 and body["vocab_size"] == 163840
    assert body["moe_intermediate_size"] == 1408
    assert body["tie_word_embeddings"] is False


def test_reference_imports_nothing_of_the_port():
    path = os.path.join(spec.HERE, "reference", "moonlight.py")
    mods = set(test_pb_imports.imports(path))
    assert not mods & {"vqacl_tpu_torch", "vqacl_tpu", "jax", "flax"}


def test_reference_tree_is_the_programs():
    from vqacl_tpu_torch.models import moonlight as ML
    c = spec.load(CELL).config
    cfg = E.port_config(c, 0).model
    ref = [(p, tuple(s)) for p, s, _ in RM.layout(RM.sizes(c))]
    prog = [(p, tuple(s)) for p, s, _ in ML.layout(cfg)]
    assert ref == prog
    assert len(ref) == 202
    n = sum(torch.Size(s).numel() for _, s in ref)
    assert 2.05e9 < n < 2.07e9


def test_reference_routes_by_held_choices():
    # the first tokens take the held choices, the rest their own top k
    from portbench.reference import precision as P
    c = RM.sizes(dict(spec.load(CELL).config, **TINY))
    torch.manual_seed(0)
    D, E = c.d_model, c.router_experts
    p = {"router": torch.randn(E, D),
         "experts": {k: torch.randn(c.experts_held, *s) * 0.1
                     for k, s in (("w_gate", (D, 16)), ("w_up", (D, 16)),
                                  ("w_down", (16, D)))},
         "shared": {k: torch.randn(*s) * 0.1
                    for k, s in (("w_gate", (D, 16)), ("w_up", (D, 16)),
                                 ("w_down", (16, D)))}}
    x = torch.randn(2, 5, D)
    bias = torch.zeros(E)
    _, _, _, own = RM.moe(P.F32, p, c, x, bias)
    held = torch.stack([torch.arange(2), torch.arange(2, 4)]).repeat(3, 1)
    _, _, load, idx = RM.moe(P.F32, p, c, x, bias, held)
    assert torch.equal(idx[:6], held) and torch.equal(idx[6:], own[6:])
    assert load.sum() == 10 * c.num_experts_per_tok
    assert load[:4].tolist() == [3 + int((own[6:] == e).sum())
                                 for e in range(4)]


def test_flops_by_hand():
    m = spec.load(CELL).config
    S, D, H, V = 66, 2048, 16, 163840
    mla = (2 * S * D * H * 192 + 2 * S * D * 576 + 2 * S * 512 * H * 256
           + 2 * S * S * H * 192 + 2 * S * S * H * 128 + 2 * S * 2048 * D)
    dense = 6 * S * D * 11264
    moe = 2 * S * D * 64 + 6 * S * D * 2816 + 0.75 * 6 * S * D * 1408
    vis = 2 * 36 * 2048 * D + 2 * 36 * 5 * D
    fwd = vis + 14 * mla + dense + 13 * moe + 2 * 10 * D * V
    assert E.train_qa(m) == int(round(3 * fwd))
    # ~250 GFLOP a QA, ~20 TFLOP an 80-row step; MoE ~49 %, MLA ~31 %
    assert 245e9 < E.train_qa(m) < 255e9
    assert 0.45 < 13 * moe / fwd < 0.53 and 0.28 < 14 * mla / fwd < 0.34


def test_grouped_gemm_roofline_by_hand():
    n, D, F, E_ = 3960, 2048, 1408, 8
    b, f = moe_experts.work("fwd_gate_up", n, D, F, E_)
    assert f == 2 * n * D * 2 * F
    assert b == 2 * (n * D + E_ * D * 2 * F + n * 2 * F + n * F) + 4 * n
    b, f = moe_experts.work("dw_down", n, D, F, E_)
    assert f == 2 * n * F * D and b == 2 * (n * F + n * D) + 4 * E_ * F * D
    flops = sum(moe_experts.work(k, n, D, F, E_)[1]
                for k in moe_experts.KINDS)
    # forward 2·n·D·2F + 2·n·F·D, backward twice that
    assert flops == 3 * (2 * n * D * 2 * F + 2 * n * F * D)
    m = spec.load(CELL).config
    want = sum(max(moe_experts.work(k, n, D, F, E_)[0] / 3.35e12,
                   moe_experts.work(k, n, D, F, E_)[1] / 989e12)
               for k in moe_experts.KINDS)
    assert moe_experts.layer_bound_s(n, m) == pytest.approx(want)
    # compute-bound at the cell's rows: ~0.2 ms a layer a step
    assert 1.5e-4 < want < 2.5e-4


def test_first_steps_agree_and_the_trace_reads():
    torch.manual_seed(0)
    cell = tiny_cell(LIMITS)
    out = harness.execute(cell, SEED, 0.3, True, torch.device("cpu"), 0.0)
    n, rec = out["numbers"], out["rec"]
    assert n["loss"]["value"] < 1e-5
    # the program's first gradient comes back through a bf16 moment
    assert n["grad1"]["value"] < 1e-3
    assert n["change3"]["value"] < 1e-3
    assert n["choice_diff"]["value"] == 0.0
    # the same choices on both sides: routing held equal changes nothing
    for k in ("loss", "grad1", "change3"):
        assert n[f"{k}_held"]["value"] == n[k]["value"]
    assert harness.verdict(n, cell.limits, rec)[0]
    assert rec["failed"] == 0 and rec["rows"] > 0
    # every traced step routed each token to k experts, in every layer
    rows = cell.config["train"]["batch_size"] * 22
    assert len(rec["moe_rows"]) == 2
    assert all(0 < r <= rec["trace_steps"] * rows * 2 for r in rec["moe_rows"])
    assert {"mla", "moe.router", "moe.dispatch", "moe.experts",
            "moe.shared", "moe.combine", "step.backward"} <= set(
                rec["span_names"])
    assert harness.read_metrics(cell.per_layer, rec, cell).keys() >= {
        "train_mfu", "loader_wait.train"}


def test_half_batch_is_not_correct(monkeypatch):
    broken_step(monkeypatch, "half_batch")
    cell = tiny_cell(LIMITS)
    out = harness.execute(cell, SEED, 0.0, False, torch.device("cpu"), 0.0)
    assert not harness.verdict(out["numbers"], cell.limits, out["rec"])[0]
