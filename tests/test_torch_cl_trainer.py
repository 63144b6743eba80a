"""The port's continual-learning loop against the JAX package's.

``VQACLTrainer`` of both packages on the same ``SyntheticDataModule``
settings and the same initial weights (tiny config, vocab 32200, f32,
dropout 0, two tasks, one epoch, replay memory of 16, lr 1e-3; the JAX
trainer on one CPU device with its plain XLA attention, the port on the
plain versions of its kernels) must take the same group order,
exemplars and batches (every array of every step bit for bit), per-step
losses within ``LOSS_RTOL``, final parameters within
``PARAM_ATOL``, and give the same answers, result matrix and
Avg-Acc/Forget: with plain replay (ER), with ``cl_reg`` "ewc" and
"derpp", and for ``CompVQACLTrainer`` (comp_cate G5) its comp and
noncomp matrices too. A ``{task}_LAST.npz`` the port writes loads in the
JAX package; both packages resume from it alike; the port's eval-only
``Test()`` reproduces its matrix; a failed background write still leaves
``{task}_EMERGENCY``; options the port does not take raise ValueError;
reference prototype banks (``Q_/V_prototype.pt``) load as the JAX
package loads them. The trainer's own records (``counts``, ``times_ms``,
``step_losses``) agree with the steps it took.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from torch_parity import record_trainer as _record  # noqa: E402
from vqacl_tpu.cl.comp_trainer import CompVQACLTrainer as JComp  # noqa: E402
from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer  # noqa: E402
from vqacl_tpu.data.synthetic_module import SyntheticDataModule as JData  # noqa: E402
from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok  # noqa: E402
from vqacl_tpu.parallel import make_mesh  # noqa: E402
from vqacl_tpu.train.checkpoint import load_checkpoint as jax_load  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cl.comp_trainer import CompVQACLTrainer as TComp  # noqa: E402
from vqacl_tpu_torch.cl.metrics import ResultMatrix  # noqa: E402
from vqacl_tpu_torch.cl.trainer import VQACLTrainer as TTrainer  # noqa: E402
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule as TData  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from vqacl_tpu_torch.train.optim import tree_leaves  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

TASKS = ["q_recognition", "q_location"]
DATA = dict(tasks=TASKS, n_train_per_task=48, n_val_per_task=16,
            n_test_per_task=16, feat_dim=16, n_boxes=4, answer_vocab=4,
            seed=0)
# per-step losses, relative, and the final parameters, absolute, after
# ~15 Adam steps at lr 1e-3 from the same weights (the two packages sum
# in other orders; a wrong gradient or Adam term moves a parameter by
# a whole update, 1e-3)
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
RUNS = {"er": ("none", None), "ewc": ("ewc", None), "derpp": ("derpp", None),
        "comp": ("none", "G5")}


def _configs(out_j, out_t, reg="none", comp=None):
    jm, params = jax_tiny_params(0, dropout_rate=0.0, vocab_size=32200)
    jc = JConfig()
    jc.model = jm
    jc.train.lr = 1e-3
    jc.train.batch_size = jc.train.valid_batch_size = 16
    jc.train.epochs = 1
    jc.train.m_size = 16
    jc.train.cl_reg = reg
    jc.train.fisher_batches = 2
    if comp:
        jc.train.comp_cate = comp
    jc.output = str(out_j)
    tc = TConfig()
    tc.model = torch_cfg_like(jm)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    tc.output = str(out_t)
    return jc, tc, params


def _jax_trainer(cls, jc, params):
    return cls(jc, JData(JTok(), **DATA), JTok(), verbose=False,
               mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
               init_params=jax.tree.map(jnp.asarray, params),
               dtype=jnp.float32)


def _port_trainer(cls, tc, params):
    return cls(tc, TData(TTok(), **DATA), TTok(), verbose=False,
               device="cpu", init_params=from_jax_params(params),
               dtype=torch.float32)


def _train_both(jt, tt, resume=None):
    jr, tr = _record(jt), _record(tt)
    return (jt, jr, jt.train(resume_task=resume)), \
        (tt, tr, tt.train(resume_task=resume))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            reg, comp = RUNS[kind]
            jc, tc, params = _configs(tmp_path_factory.mktemp(f"jax_{kind}"),
                                      tmp_path_factory.mktemp(f"port_{kind}"),
                                      reg, comp)
            cls = (JComp, TComp) if comp else (JTrainer, TTrainer)
            cache[kind] = _train_both(_jax_trainer(cls[0], jc, params),
                                      _port_trainer(cls[1], tc, params)) \
                + (tc, params)
        return cache[kind]
    return get


def _buffer_ids(trainer):
    return {g: [[d["question_id"] for d in slot] for slot in slots]
            for g, slots in trainer.buffer.sets.items()}


def _assert_follows(j, t, metrics=True):
    (jt, jr, jm), (tt, tr, tm) = j, t
    assert [(e["task"], e["group"]) for e in tt.metrics_log] == \
        [(e["task"], e["group"]) for e in jt.metrics_log]
    assert tt.py_rng.getstate() == jt.py_rng.getstate()
    assert _buffer_ids(tt) == _buffer_ids(jt)
    assert [k for k, _ in tr["losses"]] == [k for k, _ in jr["losses"]]
    assert tr["batches"] == jr["batches"]        # every step's arrays
    assert len(tr["losses"]) >= 10
    np.testing.assert_allclose([v for _, v in tr["losses"]],
                               [v for _, v in jr["losses"]], rtol=LOSS_RTOL)
    tp = tree_leaves(tt.state.params)
    jp = jax.tree.leaves(jax.device_get(jt.state.params))
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)
    assert tr["answers"] == jr["answers"]
    assert len(tr["tokens"]) == len(jr["tokens"]) > 0
    for a, b in zip(tr["tokens"], jr["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert tt.result_matrix.to_dict() == jt.result_matrix.to_dict()
    if metrics:
        for k in ("Avg_acc", "Avg_forget"):
            assert tm[k] == jm[k], k


@pytest.mark.parametrize("kind", ["er", "ewc", "derpp"])
def test_trainer_follows_jax(runs, kind):
    j, t, *_ = runs(kind)
    _assert_follows(j, t)
    tt = t[0]
    c = tt.counts
    assert c["train_steps"] + c["replay_steps"] == len(t[1]["losses"])
    # one time per counted call, one per task-boundary save, and every
    # step's loss as the step returned it
    for k in ("train_steps", "replay_steps", "predict_batches",
              "importance_batches", "capture_batches"):
        assert len(tt.times_ms[k]) == c[k], k
        assert all(x >= 0 for x in tt.times_ms[k]), k
    assert len(tt.times_ms["saves"]) == len(TASKS)
    assert sorted(tt.step_losses["train"] + tt.step_losses["replay"]) == \
        sorted(v for _, v in t[1]["losses"])
    assert len(tt.step_losses["replay"]) == c["replay_steps"]
    assert c["replay_steps"] > 0 and c["predict_batches"] > 0
    if kind == "ewc":
        assert c["importance_batches"] == 4         # 2 per task
        for a, b in zip(tree_leaves(tt._reg.anchor),
                        jax.tree.leaves(jax.device_get(j[0]._reg.anchor))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL)
    if kind == "derpp":
        assert c["capture_batches"] > 0
        ti, ji = tt.buffer.all_examplars(), j[0].buffer.all_examplars()
        for a, b in zip(ti, ji):
            assert a["der_target_ids"] == b["der_target_ids"]
            assert a["der_logits"].dtype == np.float16
            np.testing.assert_allclose(a["der_logits"].astype(np.float32),
                                       b["der_logits"].astype(np.float32),
                                       rtol=1e-3, atol=1e-3)


def test_comp_trainer_follows_jax(runs):
    j, t, *_ = runs("comp")
    _assert_follows(j, t, metrics=False)
    (jt, _, jm), (tt, _, tm) = j, t
    for name in ("result_matrix_comp", "result_matrix_noncomp"):
        assert getattr(tt, name).to_dict() == getattr(jt, name).to_dict()
    assert tm == jm
    assert ("q_location", "G5") not in [(e["task"], e["group"])
                                        for e in tt.metrics_log]
    assert os.path.exists(os.path.join(tt.cfg.output, "metrics_comp.json"))


@pytest.mark.parametrize("comp_cate", ["G5", "G1", "G0", "G-1", ""])
def test_comp_gate_matches_jax(comp_cate):
    """The comp trainer is picked by group-key membership, as in JAX:
    "G-1" (and any non-key) turns comp testing off; "G0" is a NExT-QA
    group only."""
    from vqacl_tpu.cl.comp_trainer import comp_enabled as jgate
    from vqacl_tpu_torch.cl.comp_trainer import comp_enabled as tgate
    from vqacl_tpu_torch.cl.tasks import CATEGORY_SPLITS, NEXTQA_GROUPS

    for splits in (CATEGORY_SPLITS, {g: [] for g in NEXTQA_GROUPS}):
        assert tgate(comp_cate, splits) == jgate(comp_cate, splits)


def test_port_checkpoint_loads_in_jax(runs):
    """``{task}_LAST.npz`` of the port's run holds its weights and banks
    bit for bit as the JAX package reads them, and the port loads it
    back the same."""
    _, (tt, _, _), tc, _ = runs("er")
    path = os.path.join(tc.output, f"{TASKS[-1]}_LAST")
    jparams, jproto, jstep = jax_load(path)
    tp, tproto, tstep = load_checkpoint(path, device="cpu")
    assert jstep == tstep == int(tt.state.step)
    for a, b, c in zip(tree_leaves(tt.state.params), jax.tree.leaves(jparams),
                       tree_leaves(tp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)
    for name, x in zip(tt.state.proto._fields, tt.state.proto):
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(getattr(jproto, name)))
    for f in ("Q_prototype.npy", "V_prototype.npy", "metrics.json",
              "train_log.jsonl"):
        assert os.path.exists(os.path.join(tc.output, f)), f


def test_resume_follows_jax(runs, tmp_path):
    """Both packages resume after the first task from the port's
    checkpoint: the same replay buffer rebuild, steps and matrix row."""
    _, _, tc0, params = runs("er")
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
        shutil.copy(os.path.join(tc0.output, f"{TASKS[0]}_LAST.npz"), d)
    jc, tc, _ = _configs(*dirs)
    j, t = _train_both(_jax_trainer(JTrainer, jc, params),
                       _port_trainer(TTrainer, tc, params),
                       resume=TASKS[0])
    _assert_follows(j, t, metrics=False)
    assert [e["task"] for e in t[0].metrics_log] == [TASKS[1]] * 5


def test_eval_only_Test_reproduces_the_matrix(runs):
    """A fresh trainer's ``Test()`` over the run's checkpoints gives the
    run's result matrix and metrics again."""
    _, (tt, _, tm), tc, params = runs("er")
    fresh = _port_trainer(TTrainer, tc, params)
    fresh.result_matrix = ResultMatrix(fresh.tasks)
    metrics = fresh.Test()
    assert fresh.result_matrix.to_dict() == tt.result_matrix.to_dict()
    assert metrics == tm


def test_failed_background_write_still_saves_emergency(tmp_path):
    """A background ``{task}_LAST`` write failure from a PREVIOUS task
    surfaces at the next save(); the just-trained weights must still
    reach ``{task}_EMERGENCY``."""
    _, tc, params = _configs(tmp_path, tmp_path)
    trainer = _port_trainer(TTrainer, tc, params)

    class PoisonedWriter:
        def __init__(self):
            self.calls = 0

        def save(self, *a, **kw):
            self.calls += 1
            if self.calls == 2:
                raise IOError("simulated ENOSPC from previous write")

        def wait(self):
            pass

    trainer._ckpt_writer = PoisonedWriter()
    with pytest.raises(IOError):
        trainer.train()
    path = os.path.join(tc.output, f"{TASKS[1]}_EMERGENCY")
    params_e, _, step = load_checkpoint(path, device="cpu")
    assert step == int(trainer.state.step)
    for a, b in zip(tree_leaves(params_e), tree_leaves(trainer.state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [None, "Q_prototype", "V_prototype"])
def test_reference_prototypes_load_as_in_jax(runs, tmp_path, bad):
    """``Q_/V_prototype.pt`` banks: the port's ``load_reference_prototypes``
    gives the JAX package's banks on the same files (or raises
    ValueError on a wrong shape, as JAX does), and ``test(load=True)``
    puts them in place of the checkpoint's."""
    from vqacl_tpu.models.hf_import import load_reference_prototypes as jload
    from vqacl_tpu.models.prototype import ProtoState as JProto
    from vqacl_tpu_torch.models.prototype import ProtoState as TProto
    from vqacl_tpu_torch.train.checkpoint import load_reference_prototypes

    _, _, tc0, params = runs("er")
    m = tc0.model
    shapes = (m.n_ques_types, m.d_model), (m.n_categories, m.d_model)
    rng = np.random.default_rng(5)
    banks = {}
    for name, shape in zip(("Q_prototype", "V_prototype"), shapes):
        if name == bad:
            shape = (shape[0] + 1, shape[1])
        banks[name] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
        torch.save(banks[name], tmp_path / f"{name}.pt")
    qp, vp = str(tmp_path / "Q_prototype.pt"), str(tmp_path / "V_prototype.pt")
    jp = JProto.create(m.n_ques_types, m.n_categories, m.d_model)
    tp = TProto.create(m.n_ques_types, m.n_categories, m.d_model,
                       device="cpu")
    if bad:
        with pytest.raises(ValueError, match=bad):
            jload(jp, qp, vp)
        with pytest.raises(ValueError, match=bad):
            load_reference_prototypes(tp, qp, vp)
        return
    jout, tout = jload(jp, qp, vp), load_reference_prototypes(tp, qp, vp)
    for name, x in zip(tout._fields, tout):
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(getattr(jout, name)))
    for x, like in ((tout.q_proto, tp.q_proto), (tout.v_proto, tp.v_proto)):
        assert (x.dtype, x.device) == (like.dtype, like.device)
    shutil.copy(os.path.join(tc0.output, f"{TASKS[0]}_LAST.npz"), tmp_path)
    _, tc, _ = _configs(tmp_path, tmp_path)
    trainer = _port_trainer(TTrainer, tc, params)
    trainer.test(TASKS[0], load=True)
    assert torch.equal(trainer.state.proto.q_proto, banks["Q_prototype"])
    assert torch.equal(trainer.state.proto.v_proto, banks["V_prototype"])


REFUSED = {
    # both device caches are taken since the parallel slice (the sharded
    # one over any dp); a table type the cache does not know is refused
    "device_cache": ("data", "device_cache_dtype", "float16"),
    # the "tp" layout is taken since the tp/pp slice (whole leaves at
    # tp = 1); a misspelt one is refused
    "param_layout_tp": ("mesh", "param_layout", "Tp"),
    # fsdp is taken since the parallel slice; a layout nobody knows is not
    "param_layout_fsdp": ("mesh", "param_layout", "fsdp_tp"),
    # one process cannot run a dp of 2: no fallback to fewer ranks
    "dp2": ("mesh", "dp", 2),
    "tp2": ("mesh", "tp", 2),
    "pp2": ("mesh", "pp", 2),
    "unknown_cl_reg": ("train", "cl_reg", "si"),
}


@pytest.mark.parametrize("case", list(REFUSED) + ["der_without_memory"])
def test_unported_options_raise(case, tmp_path):
    _, tc, params = _configs(tmp_path, tmp_path)
    if case == "der_without_memory":
        tc.train.cl_reg, tc.train.memory = "der", False
    else:
        part, name, value = REFUSED[case]
        setattr(getattr(tc, part), name, value)
    with pytest.raises(ValueError):
        _port_trainer(TTrainer, tc, params)
