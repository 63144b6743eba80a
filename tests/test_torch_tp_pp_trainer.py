"""The port's CL trainer and training CLI under tensor and pipeline
parallelism, on two gloo ranks of the CPU (``tests/torch_dp.py``).

``VQACLTrainer`` (tiny config at 4 + 4 layers, vocab 32200, f32, dropout
0, ER over two tasks, batch 16; ``tests/test_torch_dp_trainer.py``'s
settings) runs at tp = 2 with the "tp" layout (each rank its Megatron
slices of the parameters and moments), at pp = 2 with 4 microbatches
(replicated), with EWC at tp = 2 and DER++ at pp = 2 (the importance,
logits and replay steps under each), and at dp = 2 × tp = 2 with FSDP
over the tp slices. Each run's result matrix must equal the one-process
port run's (of the same ``cl_reg``) within 1e-6 (as ``tests/test_cl_trainer_mesh.py`` holds its
layouts), every predict's answers must be the same, and the final
parameters must be the one-process run's up to reduction order. The
checkpoint rank 0 writes under the "tp" layout holds the full leaves
under the flat keys, and JAX reads it with those parameters.
``cli.vqacl_train.main`` at ``--mesh_tp 2 --param_layout tp`` on the two
ranks writes the one-process CLI run's files and metrics.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dp_trainer import (DATA, MATRIX_ATOL, PARAM_ATOL,  # noqa
                                   TASKS, _cli_args, _configs)
from torch_dp import spawn, trainer_run, w_trainer  # noqa: E402

LAYERS = dict(num_layers=4, num_decoder_layers=4)
# name → (mesh, param_layout, cl_reg)
MESHES = {"tp2": ({"tp": 2}, "tp", "none"),
          "pp2": ({"pp": 2}, "replicated", "none"),
          "tp2_ewc": ({"tp": 2}, "tp", "ewc"),
          "pp2_derpp": ({"pp": 2}, "replicated", "derpp"),
          "dp2tp2_fsdp": ({"dp": 2, "tp": 2}, "fsdp", "none")}


def _tp_pp_configs(out, mesh, layout, cl_reg="none"):
    _, tc, params = _configs("", out, layout)
    from torch_parity import jax_tiny_params

    _, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200,
                                **LAYERS)
    tc.model.num_layers = tc.model.num_decoder_layers = 4
    tc.mesh.tp, tc.mesh.pp = mesh.get("tp", 1), mesh.get("pp", 1)
    tc.train.cl_reg = cl_reg
    return tc, params


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    pytest.importorskip("h5py")
    from test_torch_cli import write_root

    return write_root(tmp_path_factory.mktemp("cli") / "root")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cli_root):
    """The two-rank runs of each mesh (rank order), the tp ranks' CLI
    output and the one-process port run."""
    out = {"one": {}}
    groups = {}                     # the runs of one mesh share its ranks
    for name, (mesh, layout, reg) in MESHES.items():
        tc, params = _tp_pp_configs(tmp_path_factory.mktemp(name), mesh,
                                    layout, reg)
        groups.setdefault(tuple(sorted(mesh.items())), {})[name] = (
            tc, params, DATA)
        if reg not in out["one"]:
            tc1, params = _tp_pp_configs(tmp_path_factory.mktemp("one"), {},
                                         "replicated", reg)
            out["one"][reg] = trainer_run(tc1, params, DATA)
    for key, group in groups.items():
        mesh, kw = dict(key), {}
        if "tp2" in group:
            out["cli_out"] = str(tmp_path_factory.mktemp("cli_tp"))
            kw = dict(cli_argv=_cli_args(cli_root, out["cli_out"], -1)
                      + ["--mesh_tp", "2", "--param_layout", "tp"],
                      cli_tasks=TASKS)
        n = 1
        for v in mesh.values():
            n *= v
        ranks = spawn(w_trainer, n, tmp_path_factory.mktemp("ranks"),
                      timeout=400, mesh=mesh, runs=group, **kw)
        for name, (tc, _, _) in group.items():
            out[name] = (tc, ranks)
    return out


def _matrix_close(got, want):
    assert got.keys() == want.keys()
    for row, cols in want.items():
        assert got[row].keys() == cols.keys()
        for col, v in cols.items():
            assert abs(got[row][col] - v) < MATRIX_ATOL, (row, col)


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_pp_runs_equal_one_process(runs, name):
    r0, *rest = (r[name] for r in runs[name][1])
    one = runs["one"][MESHES[name][2]]
    for r1 in rest:
        assert r0["matrix"] == r1["matrix"]
        assert r0["answers"] == r1["answers"]
        for k in r0["params"]:
            np.testing.assert_array_equal(r0["params"][k], r1["params"][k],
                                          err_msg=k)
    _matrix_close(r0["matrix"], one["matrix"])
    assert r0["answers"] == one["answers"]
    assert len(r0["answers"]) >= 4
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    for k in one["params"]:
        np.testing.assert_allclose(r0["params"][k], one["params"][k],
                                   rtol=1e-6, atol=PARAM_ATOL, err_msg=k)


def test_fsdp_over_tp_slices_holds_its_share(runs):
    from vqacl_tpu_torch.parallel.sharding import param_sharding_rules

    r0 = runs["dp2tp2_fsdp"][1][0]["dp2tp2_fsdp"]
    one = runs["one"]["none"]["params"]
    full = sum(v.nbytes for v in one.values())
    by_tp = sum(v.nbytes for k, v in one.items()
                if "tp" in param_sharding_rules(k.lstrip("/")))
    # the blocks' q/k/v/o and MLP halved by tp, the shared embedding
    # [32200, 32] (the one leaf past 2^14 elements) halved by dp
    assert r0["param_bytes"] == full - by_tp // 2 - one["/shared"].nbytes // 2


def test_tp_checkpoint_loads_in_jax(runs):
    from vqacl_tpu.train.checkpoint import load_checkpoint as jax_load
    from torch_dp import flat_numpy

    tc, ranks = runs["tp2"]
    names = sorted(os.listdir(tc.output))
    assert names == sorted([f"{t}_LAST.npz" for t in TASKS]
                           + ["Q_prototype.npy", "V_prototype.npy",
                              "metrics.json", "train_log.jsonl"])
    jparams, _, _ = jax_load(os.path.join(tc.output, f"{TASKS[-1]}_LAST"))
    got = flat_numpy(jparams)
    r0 = ranks[0]["tp2"]
    assert got.keys() == r0["params"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, r0["params"][k], err_msg=k)
    # full leaves: a wq of all heads, the MLP's whole hidden
    assert got["/encoder/block_0/attn/wq"].shape == (32, 32)
    assert got["/encoder/block_0/mlp/wi"].shape == (32, 64)


def test_cli_at_mesh_tp_2_matches_one_process(runs, cli_root, tmp_path,
                                             monkeypatch):
    import vqacl_tpu_torch.cli.vqacl_train as TVqa
    import vqacl_tpu_torch.data.vqa_module as vm

    orig = vm.VQADataModule.__init__

    def cut(self, root, tok, tasks=None, **kw):
        orig(self, root, tok, tasks=TASKS, **kw)

    monkeypatch.setattr(vm.VQADataModule, "__init__", cut)
    out = str(tmp_path / "one")
    one = TVqa.main(_cli_args(cli_root, out, -1))
    r0, r1 = runs["tp2"][1]
    assert r0["cli"] == r1["cli"] == one
    with open(os.path.join(out, "metrics.json")) as f:
        want = json.load(f)
    cli_out = runs["cli_out"]
    assert sorted(os.listdir(cli_out)) == sorted(os.listdir(out))
    with open(os.path.join(cli_out, "metrics.json")) as f:
        assert json.load(f) == want

