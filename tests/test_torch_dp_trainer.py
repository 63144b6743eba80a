"""The port's CL trainer and training CLI on a two-rank data-parallel mesh
(gloo on the CPU, ``tests/torch_dp.py``).

``VQACLTrainer`` (tiny config, vocab 32200, f32, dropout 0, ER over two
tasks, batch 16 = 8 per rank; the settings of
``tests/test_torch_cl_trainer.py``) runs on two ranks with the
replicated layout, and with FSDP (the shared embedding and its moments
kept as halves) over the row-sharded f32 device cache. Each run's result
matrix must equal the one-process port run's and JAX's one-device
trainer's within 1e-6 (as ``tests/test_cl_trainer_mesh.py`` holds its
layouts), every predict's answers must be the same, and the final
parameters must be the one-process run's up to reduction order. The
checkpoints rank 0 writes (replicated and FSDP) load in JAX with those
parameters. A global batch dp does not divide raises on the ranks; so
do mesh sizes other than the mesh's, an unknown layout, and a microbatch
count, heads or layers the mesh does not divide. ``cli.vqacl_train.main`` at
``--mesh_dp 2`` on the two ranks writes the one-process CLI run's files
and metrics.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_dp import spawn, trainer_run, w_trainer  # noqa: E402
from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

TASKS = ["q_recognition", "q_location"]
DATA = dict(tasks=TASKS, n_train_per_task=48, n_val_per_task=16,
            n_test_per_task=16, feat_dim=16, n_boxes=4, answer_vocab=4,
            seed=0)
# (param_layout, device_cache_sharded)
LAYOUTS = {"replicated": ("replicated", False),
           "fsdp_sharded_cache": ("fsdp", True)}
MATRIX_ATOL = 1e-6
# ~15 Adam steps at lr 1e-3 (tests/test_torch_dp_step.py's reasoning)
PARAM_ATOL = 1e-5


def _configs(out_j, out_t, layout="replicated", sharded=False):
    jm, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200)
    jc = JConfig()
    jc.model = jm
    jc.train.lr = 1e-3
    jc.train.batch_size = jc.train.valid_batch_size = 16
    jc.train.epochs = 1
    jc.train.m_size = 16
    jc.output = str(out_j)
    tc = TConfig()
    tc.model = torch_cfg_like(jm)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    tc.mesh.param_layout = layout
    if sharded:
        tc.data.device_cache = tc.data.device_cache_sharded = True
        tc.data.device_cache_dtype = "float32"
    tc.output = str(out_t)
    return jc, tc, params


def _cli_args(root, out, dp):
    return ["--platform", "cpu", "--dataset_root", root, "--output", out,
            "--tiny_model", "--batch_size", "8", "--valid_batch_size", "8",
            "--epochs", "1", "--m_size", "10", "--memory", "--from_scratch",
            "--lr", "1e-4", "--dtype", "float32", "--now_train",
            "--mesh_dp", str(dp)]


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    pytest.importorskip("h5py")
    from test_torch_cli import write_root

    return write_root(tmp_path_factory.mktemp("cli") / "root")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cli_root):
    """The two-rank runs (rank order), the one-process port run and JAX's
    one-device run."""
    from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer
    from vqacl_tpu.data.synthetic_module import SyntheticDataModule as JData
    from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok
    from vqacl_tpu.parallel import make_mesh

    dp_runs = {}
    for name, (layout, sharded) in LAYOUTS.items():
        _, tc, params = _configs("", tmp_path_factory.mktemp(f"dp_{name}"),
                                 layout, sharded)
        dp_runs[name] = (tc, params, DATA)
    _, bad, params = _configs("", tmp_path_factory.mktemp("bad"))
    bad.train.valid_batch_size = 15
    cli_out = str(tmp_path_factory.mktemp("cli_dp"))
    ranks = spawn(w_trainer, 2, tmp_path_factory.mktemp("ranks"),
                  timeout=400, runs=dp_runs, bad=(bad, params, DATA),
                  cli_argv=_cli_args(cli_root, cli_out, 2),
                  cli_tasks=TASKS)
    jc, tc, params = _configs(tmp_path_factory.mktemp("jax"),
                              tmp_path_factory.mktemp("one"))
    one = trainer_run(tc, params, DATA)
    jt = JTrainer(jc, JData(JTok(), **DATA), JTok(), verbose=False,
                  mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
                  init_params=jax.tree.map(jnp.asarray, params),
                  dtype=jnp.float32)
    janswers = []
    predict = jt.predict
    jt.predict = lambda loader: janswers.append(dict(predict(loader))) \
        or janswers[-1]
    jt.train()
    return {"ranks": ranks, "dp": dp_runs, "one": one, "cli_out": cli_out,
            "jax": {"matrix": jt.result_matrix.to_dict(),
                    "answers": janswers}}


def _matrix_close(got, want):
    assert got.keys() == want.keys()
    for row, cols in want.items():
        assert got[row].keys() == cols.keys()
        for col, v in cols.items():
            assert abs(got[row][col] - v) < MATRIX_ATOL, (row, col)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_rank_runs_equal_one_process_and_jax(runs, layout):
    r0, r1 = (r[layout] for r in runs["ranks"])
    one, jx = runs["one"], runs["jax"]
    # the ranks agree with each other
    assert r0["matrix"] == r1["matrix"] and r0["answers"] == r1["answers"]
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k],
                                      err_msg=k)
    _matrix_close(r0["matrix"], one["matrix"])
    _matrix_close(r0["matrix"], jx["matrix"])
    assert r0["answers"] == one["answers"] == jx["answers"]
    assert len(r0["answers"]) >= 4
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    for k in one["params"]:
        np.testing.assert_allclose(r0["params"][k], one["params"][k],
                                   rtol=1e-6, atol=PARAM_ATOL, err_msg=k)


def test_fsdp_and_sharded_cache_hold_halves(runs):
    r0 = runs["ranks"][0]
    full = sum(v.nbytes for v in runs["one"]["params"].values())
    # the shared embedding [32200, 32] f32, the one leaf past 2^14
    assert r0["fsdp_sharded_cache"]["param_bytes"] == \
        full - 32200 * 32 * 4 // 2
    assert "param_bytes" not in r0["replicated"]
    # 2 tasks × (48 + 16 + 16) images, 80 rows per rank, and one
    # all_reduce per lookup
    assert r0["fsdp_sharded_cache"]["cache_rows"] == 80
    assert r0["fsdp_sharded_cache"]["lookup_bytes"] > 0
    assert "cache_rows" not in r0["replicated"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank0_checkpoint_loads_in_jax(runs, layout):
    from vqacl_tpu.train.checkpoint import load_checkpoint as jax_load

    tc = runs["dp"][layout][0]
    r0 = runs["ranks"][0][layout]
    names = sorted(os.listdir(tc.output))
    assert names == sorted([f"{t}_LAST.npz" for t in TASKS]
                           + ["Q_prototype.npy", "V_prototype.npy",
                              "metrics.json", "train_log.jsonl"])
    jparams, _, _ = jax_load(os.path.join(tc.output, f"{TASKS[-1]}_LAST"))
    from torch_dp import flat_numpy
    got = flat_numpy(jparams)
    assert got.keys() == r0["params"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, r0["params"][k], err_msg=k)


def test_indivisible_batch_and_tp_pp_raise(runs, tmp_path):
    from vqacl_tpu_torch.parallel.mesh import MeshContext

    assert "valid_batch_size=15 is not divisible by dp=2" in \
        runs["ranks"][0]["bad"]
    # tp, pp and the "tp" layout are taken since the tp/pp slice; what
    # still raises: sizes other than the mesh's, a layout nobody knows,
    # and a microbatch count, heads or layers the mesh does not divide
    # (refused before any collective: a context without a group here)
    for mesh, sets, msg in (
            (None, {"mesh.tp": 2}, "mesh.tp=2, but the mesh has tp=1"),
            (None, {"mesh.pp": 2}, "mesh.pp=2, but the mesh has pp=1"),
            (None, {"mesh.param_layout": "tp_fsdp"}, "pick from"),
            ({"pp": 2}, {"mesh.pp": 2, "mesh.pp_micro": 3},
             "batch_size=16 is not divisible by dp=1 x pp_micro=3"),
            ({"tp": 3}, {"mesh.tp": 3},
             "model.num_heads=4 is not divisible by tp=3"),
            ({"pp": 2}, {"mesh.pp": 2, "model.num_layers": 3},
             "model.num_layers=3 is not divisible by pp=2")):
        _, tc, params = _configs(tmp_path, tmp_path)
        for key, value in sets.items():
            part, name = key.split(".")
            setattr(getattr(tc, part), name, value)
        ctx = None if mesh is None else MeshContext(**mesh)
        with pytest.raises(ValueError, match=msg):
            trainer_run(tc, params, DATA, ctx=ctx)


def test_cli_at_mesh_dp_2_matches_one_process(runs, cli_root, tmp_path,
                                             monkeypatch):
    import vqacl_tpu_torch.cli.vqacl_train as TVqa
    import vqacl_tpu_torch.data.vqa_module as vm

    orig = vm.VQADataModule.__init__

    def cut(self, root, tok, tasks=None, **kw):
        orig(self, root, tok, tasks=TASKS, **kw)

    monkeypatch.setattr(vm.VQADataModule, "__init__", cut)
    out = str(tmp_path / "one")
    one = TVqa.main(_cli_args(cli_root, out, -1))
    dp = runs["ranks"]
    assert dp[0]["cli"] == dp[1]["cli"] == one
    # rank 0 wrote the one-process run's files, with its metrics
    assert sorted(os.listdir(runs["cli_out"])) == sorted(os.listdir(out))
    with open(os.path.join(runs["cli_out"], "metrics.json")) as f:
        assert json.load(f) == json.load(open(os.path.join(
            out, "metrics.json")))
