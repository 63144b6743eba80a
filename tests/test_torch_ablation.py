"""The port's Table-1 surrogate (``vqacl_tpu_torch/ablation.py``) against
``scripts/ablation.py``.

The resume cache and the buffer-regime sensitivity rendering take the
cases of ``test_ablation_cache.py`` and ``test_ablation_sensitivity.py``,
each run on the same inputs against both modules, which must also give
the same output. ``run_row`` for the rows the trainer parity does not
cover (vanilla, mas, der, ours) on a cut config (2 tasks, 48 train and 16
test QA per task, 1 epoch, M 16), with both trainers handed the same
initial parameters at dropout 0 (the JAX trainer on one CPU device, the
port on the plain versions of its kernels), gives the same result
matrix, Avg_acc, Avg_forget and diag_acc. ``write_doc`` renders the same
tables, claim lines and power analysis from the same results. The
port's defaults: ``--md`` is ``docs/ablation_torch.md``, no sensitivity
file, the card, which raises without one.
"""

import importlib.util
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params  # noqa: E402
from vqacl_tpu_torch import ablation as port  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny CL runs here are bound by the host's dispatch: one
    intra-op thread each (a thread per core, the default, oversubscribes
    a host that other test workers share and slows them many times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ablation_script", os.path.join(REPO, "scripts", "ablation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


script = _load_script()
MODS = {"jax": script, "port": port}


# ---- the resume cache (test_ablation_cache.py's cases) --------------------
def make_args(cache, **over):
    base = dict(tasks=5, n_train=1000, n_eval=500, epochs=3, m_size=500,
                answer_vocab=10, residue_centroids=True,
                lambda_q=0.01, lambda_v=0.1, ewc_lambda=100.0,
                mas_lambda=1.0, der_alpha=50.0, fisher_batches=10)
    base.update(over)
    return SimpleNamespace(cache=cache, **base)


def write_cells(mod, path, args, rows):
    with open(path, "w") as f:
        for row, seed in rows:
            rec = {"row": row, "seed": seed, "Avg_acc": 50.0,
                   "Avg_forget": 10.0, "cfg": mod.cfg_key(args, row)}
            f.write(json.dumps(rec) + "\n")


def case_row_hyperparam_retune_keeps_other_rows(mod, tmp_path, capsys):
    cache = str(tmp_path / "cells.jsonl")
    old = make_args(cache, der_alpha=0.5)
    write_cells(mod, cache, old, [("vanilla", 0), ("er", 0), ("ours", 0),
                                  ("der", 0), ("ewc", 0), ("mas", 0)])
    cells = mod.load_cache(make_args(cache, der_alpha=50.0))   # the retune
    assert set(cells) == {("vanilla", 0), ("er", 0), ("ours", 0),
                          ("ewc", 0), ("mas", 0)}   # only der invalidated
    return sorted(cells.items())


def case_shared_field_change_invalidates_every_row(mod, tmp_path, capsys):
    cache = str(tmp_path / "cells.jsonl")
    write_cells(mod, cache, make_args(cache, n_train=600),
                [("vanilla", 0), ("der", 0)])
    cells = mod.load_cache(make_args(cache, n_train=1000))
    assert not cells
    return cells


def case_legacy_full_config_records_still_load(mod, tmp_path, capsys):
    """Pre-per-row records carry ALL fields in cfg; comparison must use
    only the fields relevant to that record's row."""
    cache = str(tmp_path / "cells.jsonl")
    args = make_args(cache, der_alpha=0.5)
    legacy_cfg = {f: getattr(args, f) for f in mod.CFG_FIELDS}
    for row, fields in mod.ROW_CFG_FIELDS.items():
        legacy_cfg.update({f: getattr(args, f) for f in fields})
    with open(cache, "w") as f:
        f.write(json.dumps({"row": "vanilla", "seed": 3, "Avg_acc": 40.0,
                            "Avg_forget": 75.0, "cfg": legacy_cfg}) + "\n")
    cells = mod.load_cache(make_args(cache, der_alpha=50.0))
    assert ("vanilla", 3) in cells
    return sorted(cells.items())


def case_missing_cache_file_is_empty(mod, tmp_path, capsys):
    cells = mod.load_cache(make_args(str(tmp_path / "nope" / "cells.jsonl")))
    assert cells == {}
    return cells


def case_malformed_cache_lines_skipped(mod, tmp_path, capsys):
    """A sweep killed mid-append leaves a truncated final line; resume
    must skip it (and a record without a seed) with a warning."""
    cache = str(tmp_path / "cells.jsonl")
    args = make_args(cache)
    write_cells(mod, cache, args, [("vanilla", 0)])
    with open(cache, "a") as f:
        f.write('{"row": "er", "seed": 1, "Avg')          # truncated
        f.write("\n")
        f.write(json.dumps({"row": "vanilla",             # no "seed"
                            "cfg": mod.cfg_key(args, "vanilla")}) + "\n")
    cells = mod.load_cache(args)
    assert ("vanilla", 0) in cells and len(cells) == 1
    err = capsys.readouterr().err
    assert err.count("skipping malformed cache line") == 2
    return sorted(cells.items())


# ---- the sensitivity section (test_ablation_sensitivity.py's cases) -------
def _cell(row, seed, acc, fgt, m_size=500):
    return {"row": row, "seed": seed, "Avg_acc": acc, "Avg_forget": fgt,
            "diag_acc": 99.0, "cfg": {"m_size": m_size}}


def _write(path, cells):
    with open(path, "w") as f:
        for c in cells:
            f.write(json.dumps(c) + "\n")


def case_missing_file_renders_nothing(mod, tmp_path, capsys):
    a = SimpleNamespace(sensitivity=str(tmp_path / "nope.jsonl"),
                        n_train=1000, m_size=100)
    assert mod._sensitivity_lines(a) == []
    a.sensitivity = None
    assert mod._sensitivity_lines(a) == []
    return []


def case_stats_computed_from_file(mod, tmp_path, capsys):
    path = str(tmp_path / "cells.jsonl")
    er = [(0, 80.0, 20.0), (1, 90.0, 10.0), (2, 85.0, 15.0)]
    ours = [(0, 82.0, 18.0), (1, 94.0, 6.0), (2, 88.0, 12.0)]
    _write(path, [_cell("er", s, a, f) for s, a, f in er]
                 + [_cell("ours", s, a, f) for s, a, f in ours])
    a = SimpleNamespace(sensitivity=path, n_train=1000, m_size=100)
    lines = mod._sensitivity_lines(a)
    text = "\n".join(lines)
    m, sd = mod._stats([x[1] for x in er])
    assert f"| er | 3 | {m:.2f} ± {sd:.2f}" in text
    m, sd = mod._stats([x[1] for x in ours])
    assert f"| ours | 3 | {m:.2f} ± {sd:.2f}" in text
    # paired delta: ours−er = +2, +4, +3 → mean +3, SEM = std/√2
    dm, dsd = mod._stats([2.0, 4.0, 3.0])
    assert f"{dm:+.2f} ± {dsd / math.sqrt(2):.2f} (SEM, n=3)" in text
    assert "SEPARATES (paired)" in text
    assert "M=500" in text and "50%" in text
    return lines


def case_paired_delta_uses_matching_seeds_only(mod, tmp_path, capsys):
    path = str(tmp_path / "cells.jsonl")
    _write(path, [_cell("er", 0, 80.0, 20.0), _cell("er", 1, 90.0, 10.0),
                  _cell("ours", 1, 95.0, 5.0), _cell("ours", 7, 10.0, 90.0)])
    a = SimpleNamespace(sensitivity=path, n_train=1000, m_size=100)
    lines = mod._sensitivity_lines(a)
    text = "\n".join(lines)
    # one pair has a degenerate SEM: no separation verdict from it
    assert "(n=1 — too few pairs for a verdict)" in text
    assert "SEPARATES" not in text and "REVERSED" not in text
    assert "AP (ours − er): +5.00" in text
    return lines


def case_repo_m500_cells_render_the_committed_tie(mod, tmp_path, capsys):
    path = os.path.join(REPO, "docs", "ablation_m500_cells.jsonl")
    a = SimpleNamespace(sensitivity=path, n_train=1000, m_size=100)
    lines = mod._sensitivity_lines(a)
    text = "\n".join(lines)
    assert text.count("not separated even paired") == 2
    assert "| ours | 5 | 92.73 ± 7.38 | 8.45 ± 8.69 |" in text
    return lines


def case_coverage_uses_the_files_own_n_train(mod, tmp_path, capsys):
    path = str(tmp_path / "cells.jsonl")
    cells = [_cell("er", s, 80.0, 20.0) for s in (0, 1)]
    for c in cells:
        c["cfg"]["n_train"] = 600
    _write(path, cells)
    a = SimpleNamespace(sensitivity=path, n_train=1000, m_size=100)
    lines = mod._sensitivity_lines(a)
    text = "\n".join(lines)
    assert "covers 83%" in text             # 500/600, not 500/1000
    assert "M=100 (10% coverage)" in text
    return lines


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("mod", sorted(MODS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_and_sensitivity_cases(case, mod, tmp_path, capsys):
    other = "jax" if mod == "port" else "port"
    outs = []
    for m in (mod, other):      # the same inputs give the same output
        (tmp_path / m).mkdir()
        outs.append(json.dumps(CASES[case](MODS[m], tmp_path / m, capsys),
                               default=str).replace(f"/{m}/", "/_/"))
    assert outs[0] == outs[1]


# ---- run_row: the port against the JAX script on the same parameters ------
ROW_ARGS = dict(tasks=2, n_train=48, n_eval=16, epochs=1, m_size=16,
                answer_vocab=4, residue_centroids=1, lambda_q=0.01,
                lambda_v=0.1, ewc_lambda=100.0, mas_lambda=1.0,
                der_alpha=50.0, fisher_batches=2)


def _row(name):
    return dict(port.ROWS)[name]


@pytest.mark.parametrize("name", ["vanilla", "mas", "der", "ours"])
def test_run_row_follows_jax(name, tmp_path, monkeypatch):
    import vqacl_tpu.cl.trainer as JT
    import vqacl_tpu.utils.config as JC
    from vqacl_tpu.parallel import make_mesh

    jm, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200)
    # JAX's run_row on one CPU device, from these parameters at dropout 0
    jtiny, JTrainer = JC.tiny_model_config, JT.VQACLTrainer
    monkeypatch.setattr(JC, "tiny_model_config",
                        lambda **kw: jtiny(**{"dropout_rate": 0.0, **kw}))
    monkeypatch.setattr(JT, "VQACLTrainer", lambda *a, **kw: JTrainer(
        *a, **kw, mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
        init_params=jax.tree.map(jnp.asarray, params)))
    sw = _row(name)
    switches = dict(cl_reg=sw.get("cl_reg", "none"),
                    memloss=sw.get("memloss", False))
    ja = SimpleNamespace(out=str(tmp_path / "jax"), **ROW_ARGS)
    want = script.run_row(name, sw["memory"], sw["prototype"], ja, seed=0,
                          **switches)
    trainers = []

    def drive(trainer):
        trainers.append(trainer)
        return trainer.train()

    pa = SimpleNamespace(out=str(tmp_path / "port"), device="cpu",
                         **ROW_ARGS)
    got = port.run_row(name, sw["memory"], sw["prototype"], pa, seed=0,
                       init_params=from_jax_params(params), dropout_rate=0.0,
                       drive=drive, **switches)
    assert got == want
    # the row ran what it names: replay, prototypes, regularizer
    t = trainers[0]
    assert t.cfg.model.use_prototype == sw["prototype"]
    assert t.cfg.train.use_memory_loss == sw.get("memloss", False)
    assert (t.counts["replay_steps"] > 0) == sw["memory"]
    assert (t.counts["importance_batches"] > 0) == (name == "mas")
    assert (t.counts["capture_batches"] > 0) == (name == "der")
    mat = t.result_matrix.matrix()
    assert mat.shape == (2, 2) and np.isfinite(mat).all()


def _cut_losses(params, out, lr=None):
    """Per-step losses of the "ours" row cut to 2 tasks x 64 train QA, one
    epoch, on the CPU from ``params`` at dropout 0."""
    a = port.parse_args(["--device", "cpu", "--tasks", "2", "--n_train",
                         "64", "--epochs", "1", "--out", str(out)])
    losses = []

    def drive(trainer):
        m = trainer.train()
        losses.extend(trainer.step_losses["train"]
                      + trainer.step_losses["replay"])
        return m

    sw = _row("ours")
    port.run_row("ours", sw["memory"], sw["prototype"], a, 0,
                 memloss=True, init_params=params, dropout_rate=0.0, lr=lr,
                 drive=drive)
    return losses


def test_cut_row_amplifies_rounding_at_the_surrogates_lr(tmp_path):
    """The surrogate's lr of 1e-2 amplifies f32 rounding through training:
    a 1e-7 relative change of the initial parameters moves the cut row's
    per-step losses by more than 1e-5 (chip_smoke.py's CL_LOSS_RTOL) on
    the CPU alone, while at lr 1e-3 they stay within 1e-6. So phase 14
    holds the card's losses to the CPU's at lr 1e-3, and at 1e-2 only the
    result matrix, answers and metrics."""
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.train.optim import tree_map
    from vqacl_tpu_torch.utils.config import tiny_model_config

    init = vlt5.init_vlt5_params(0, tiny_model_config(vocab_size=32200),
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda p: p * (1 + 1e-7 * torch.randn(
        p.shape, generator=g)), init)
    worst = {}
    for lr in (None, 1e-3):
        a = _cut_losses(init, tmp_path / "a", lr)
        b = _cut_losses(nudged, tmp_path / "b", lr)
        assert len(a) == len(b) == 17
        worst[lr] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    assert worst[None] > 1e-5
    assert worst[1e-3] < 1e-6


# ---- write_doc: the same tables and claims from the same results ----------
def _results(mod):
    rng = np.random.default_rng(3)
    out = {}
    for (name, sw), ap in zip(mod.ROWS, (40, 40, 33, 70, 52, 88)):
        accs = [round(float(ap + rng.normal(0, 4)), 2) for _ in range(5)]
        fgts = [round(float(100 - ap + rng.normal(0, 5)), 2)
                for _ in range(5)]
        out[name] = (sw, accs, fgts)
    return out


@pytest.mark.parametrize("rows", ["all", "vanilla,er,ours", "vanilla,der"])
def test_write_doc_same_tables_and_claims(rows, tmp_path):
    docs = {}
    for key, mod in MODS.items():
        res = _results(mod)
        if rows != "all":
            res = {k: v for k, v in res.items() if k in rows.split(",")}
        a = SimpleNamespace(md=str(tmp_path / f"{key}.md"), tasks=5,
                            n_train=1000, n_eval=500, epochs=3, m_size=100,
                            ewc_lambda=100.0, mas_lambda=1.0, der_alpha=50.0,
                            lambda_q=0.01, lambda_v=0.1, repeats=5,
                            residue_centroids=1, sensitivity=None,
                            device="cpu")
        mod.write_doc(a, res)
        docs[key] = open(a.md).read().splitlines()

    def kept(lines):
        return [ln for ln in lines if ln.startswith(("|", "- ", "## "))
                or "claims hold" in ln]

    assert kept(docs["port"]) == kept(docs["jax"])
    assert sum(ln.startswith("- PASS") for ln in docs["port"]) > 0
    assert len(kept(docs["port"])) > 5
    # the port's header names where its cells ran
    assert any(ln.startswith("Measured on: ") for ln in docs["port"])


def test_port_defaults(monkeypatch):
    a = port.parse_args([])
    assert os.path.abspath(a.md) == os.path.join(REPO, "docs",
                                                 "ablation_torch.md")
    assert os.path.abspath(a.md) != os.path.join(REPO, "ABLATION.md")
    assert a.sensitivity is None and a.device == "cuda"
    assert (a.tasks, a.n_train, a.n_eval, a.epochs, a.m_size, a.repeats) \
        == (5, 1000, 500, 3, 100, 5)
    assert (a.ewc_lambda, a.mas_lambda, a.der_alpha, a.lambda_q,
            a.lambda_v) == (100.0, 1.0, 50.0, 0.01, 0.1)
    # no card: the default device raises before any cell runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "run_row", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["--out", "/nonexistent/never"])


def test_committed_document_renders_from_its_cells(tmp_path, monkeypatch):
    """docs/ablation_torch.md is what the port's main renders from the
    committed cells (JAX's defaults, every cell cached, none run): the
    claim checks in it are computed from docs/ablation_torch_cells.jsonl,
    whose every cell names the card it ran on."""
    cells = os.path.join(REPO, "docs", "ablation_torch_cells.jsonl")
    monkeypatch.setattr(port, "run_row", lambda *a, **k: pytest.fail(
        "a cell was not in the committed cache"))
    md = tmp_path / "doc.md"
    port.main(["--device", "cpu", "--cache", cells, "--out",
               str(tmp_path / "out"), "--md", str(md)])
    with open(os.path.join(REPO, "docs", "ablation_torch.md")) as f:
        assert md.read_text() == f.read()
    with open(cells) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert len(recs) == 6 * 5
    assert {(r["row"], r["seed"]) for r in recs} == {
        (name, s) for name, _ in port.ROWS for s in range(5)}
    assert all(r["card"].startswith("NVIDIA H100") for r in recs)
