"""The port's train steps on a two-rank data-parallel mesh (gloo on the
CPU, ``tests/torch_dp.py``) against its one-process steps and JAX's.

Each rank runs its rows of the same global batches (8 rows, 4 per rank;
``shard_batch``) through 3 steps of the tiny config in f32, from the same
state, and the results must equal the one-process port run's from the
same state: per-step loss and metrics, final parameters and prototype
banks within ``RTOL`` relative (reduction order only), and bit for bit
across the ranks, the dropout generator in the same state. The cases:
``make_train_step`` at dropout 0 and 0.1, with ``grad_accum`` 2, the
DER++ replay step, the EWC and MAS importance passes followed by the
anchor-penalty step, and FSDP (vocab 32200, so that the shared embedding
shards; parameter and moment bytes per rank checked). At dropout 0 the
two-rank run also follows JAX's ``make_train_step`` on a dp = 2 mesh
(its fused attention through the shard_map path, Pallas in interpret
mode) within ``tests/test_torch_train_step.py``'s tolerances.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_dp import flat_numpy, run_steps, spawn, w_steps  # noqa: E402
from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

B = 8
STEPS = 3
# the ranks sum their gradients and class statistics in another order
# than one process does: a relative difference of a few f32 ulps in the
# losses, metrics, banks and importances
RTOL = 1e-6
ATOL = 1e-8
# parameters after Adam steps at lr 1e-3: m/(√v+ε) amplifies those ulps
# in gradient entries near ε (as tests/test_torch_train_step.py notes),
# so the parameters' bound adds 1 % of one update absolute; a wrong
# gradient or Adam term moves a parameter by a whole update
PARAM_ATOL = 1e-5
# the banks are means of hiddens computed from those parameters
PROTO_ATOL = 1e-5
# an importance is a gradient entry (its square or magnitude) summed over
# batches: the backward's sums in another order, a few more ulps
IMPORTANCE_RTOL = 1e-5
METRICS = ("loss", "grad_norm", "lr", "loss_memory_Q", "loss_memory_V",
           "retrieval_acc_Q", "retrieval_acc_V")
# name → (dropout, grad_accum, kind, fsdp, vocab)
CASES = {
    "dropout0": (0.0, 1, "train", False, 256),
    "dropout0.1": (0.1, 1, "train", False, 256),
    "accum2": (0.1, 2, "train", False, 256),
    "der": (0.1, 1, "der", False, 256),
    "ewc": (0.1, 1, "ewc", False, 256),
    "mas": (0.1, 1, "mas", False, 256),
    "fsdp": (0.1, 1, "train", True, 32200),
}


def _configs(dropout, accum, kind, vocab):
    jm, params = jax_tiny_params(0, dropout_rate=dropout, vocab_size=vocab)
    jm.fused_attention = True
    jm.fused_interpret = True
    jc = JConfig()
    jc.model = jm
    jc.train.lr = 1e-3
    jc.train.grad_accum = accum
    if kind == "der":
        jc.train.cl_reg, jc.train.reg_lambda = "derpp", 0.7
    tc = TConfig()
    tc.model = torch_cfg_like(jm)
    tc.model.fused_attention = True
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    return jc, tc, params


def _batches(m, kind):
    kw = dict(feat_dim=m.feat_dim, n_boxes=m.n_boxes,
              text_len=m.max_text_length, vocab_size=m.vocab_size,
              answer_vocab=8)
    out = [b["tensors"] for b in SyntheticVQA(B * STEPS, seed=3, **kw)
           .batches(B, seed=4)]
    if kind == "der":
        rng = np.random.default_rng(9)
        for b in out:
            b["der_logits"] = rng.normal(
                size=b["target_ids"].shape + (m.vocab_size,)).astype(
                np.float16)
    return out


def _case(name):
    dropout, accum, kind, fsdp, vocab = CASES[name]
    jc, tc, params = _configs(dropout, accum, kind, vocab)
    return jc, tc, params, _batches(tc.model, kind), kind, fsdp


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    cases = {}
    for name in CASES:
        _, tc, params, batches, kind, fsdp = _case(name)
        cases[name] = (tc, params, batches, kind, fsdp)
    return spawn(w_steps, 2, tmp_path_factory.mktemp("dp_steps"),
                 cases=cases)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_process(dp_runs, name):
    _, tc, params, batches, kind, fsdp = _case(name)
    one = run_steps(tc, params, batches, kind)
    r0, r1 = dp_runs[0][name], dp_runs[1][name]
    # the ranks hold the same state, bit for bit
    for key in ("params", "proto"):
        for k in r0[key]:
            np.testing.assert_array_equal(r0[key][k], r1[key][k],
                                          err_msg=f"{key} {k}")
    assert r0["metrics"] == r1["metrics"]
    np.testing.assert_array_equal(r0["generator"], r1["generator"])
    np.testing.assert_array_equal(r0["generator"], one["generator"])
    # and the one-process run's, up to reduction order
    for s, (got, want) in enumerate(zip(r0["metrics"], one["metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {s} {k}")
    _close(r0["params"], one["params"], "params", PARAM_ATOL)
    _close(r0["proto"], one["proto"], "proto", PROTO_ATOL)
    if kind in ("ewc", "mas"):
        _close(r0["importance"], one["importance"], "importance",
               rtol=IMPORTANCE_RTOL)
    # something moved: the steps trained
    assert any(not np.array_equal(r0["params"][k], v) for k, v in
               flat_numpy(params).items())
    if fsdp:
        # the shared embedding [32200, 32] (the one leaf past 2^14
        # elements) and its two moments live as halves
        assert r0["specs"]["shared"] == ("dp", None)
        assert r0["full_bytes"] - r0["fsdp_bytes"] == \
            32200 * 32 // 2 * (4 + 2 * 2)      # f32 params, bf16 moments


def _jax_dp2(jc, params, batches):
    """JAX's make_train_step on a dp = 2 mesh: the batch sharded, the
    state replicated, the fused attention through its shard_map path."""
    from vqacl_tpu.models.prototype import ProtoState as JProto
    from vqacl_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from vqacl_tpu.train.optim import make_transform as jax_transform
    from vqacl_tpu.train.state import TrainState as JState
    from vqacl_tpu.train.step import make_train_step as jax_train_step
    from vqacl_tpu.utils.config import resolve_fused_attention

    ctx = make_mesh(dp=2, devices=jax.devices()[:2])
    resolve_fused_attention(jc.model, n_devices=2, mesh=ctx.mesh)
    m = jc.model
    tx = jax_transform(jc.train)
    state = JState.create(jax.tree.map(jnp.asarray, params), tx,
                          JProto.create(m.n_ques_types, m.n_categories,
                                        m.d_model),
                          jax.random.PRNGKey(1), warmup_iters=1.0,
                          t_total=40.0)
    state = replicate(ctx, state)
    step = jax_train_step(jc, tx, dtype=jnp.float32, donate=False)
    metrics = []
    for b in batches:
        state, mt = step(state, shard_batch(ctx, b))
        metrics.append({k: float(v) for k, v in mt.items()})
    return metrics, flat_numpy(jax.device_get(state.params)), \
        {k: np.asarray(v) for k, v in zip(JProto._fields, state.proto)}


def test_two_ranks_at_dropout_0_follow_jax_on_a_dp2_mesh(dp_runs):
    jc, tc, params, batches, kind, _ = _case("dropout0")
    jm, jp, jproto = _jax_dp2(jc, params, batches)
    r0 = dp_runs[0]["dropout0"]
    for s, (got, want) in enumerate(zip(r0["metrics"], jm)):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {s} {k}")
    for k in jp:
        np.testing.assert_allclose(r0["params"][k], jp[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in jproto:
        np.testing.assert_allclose(r0["proto"][k], jproto[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
