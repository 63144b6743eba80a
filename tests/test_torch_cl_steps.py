"""The port's CL training-step extras against the JAX package.

On the tiny config at dropout 0 in f32, from the same weights, banks and
batch (JAX on its plain XLA attention, the port on the plain versions of
its kernels): the EWC/MAS penalty, ``init_reg_state`` and
``consolidate``; the importance accumulator of ``make_importance_step``
for "ewc" and "mas" over two batches; one ``make_train_step`` step with
the anchor penalty (``reg_lambda``); ``make_logits_step``'s logits; one
``make_der_replay_step`` step for "der" and "derpp". Every value is held
to ``TOL``, the bound ``tests/test_torch_train_step.py`` holds one step's
parameters to (its metrics there: 1e-5 relative).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, proto_banks, torch_cfg_like  # noqa: E402
from vqacl_tpu.cl import regularizers as JR  # noqa: E402
from vqacl_tpu.data.synthetic import SyntheticVQA as JSynth  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.train import step as JS  # noqa: E402
from vqacl_tpu.train.optim import make_transform as jax_transform  # noqa: E402
from vqacl_tpu.train.state import TrainState as JState  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cl import regularizers as TR  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.train import step as TS  # noqa: E402
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves  # noqa: E402
from vqacl_tpu_torch.train.state import TrainState  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

# one constant for every comparison: 1e-5 relative + 1e-5 absolute
TOL = dict(rtol=1e-5, atol=1e-5)
B = 8


@pytest.fixture(scope="module")
def setup():
    jcfg, params = jax_tiny_params(0, dropout_rate=0.0)
    jc = JConfig()
    jc.model = jcfg
    jc.train.lr = 1e-3
    tc = TConfig()
    tc.model = torch_cfg_like(jcfg)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    m = jcfg
    kw = dict(feat_dim=m.feat_dim, n_boxes=m.n_boxes,
              text_len=m.max_text_length, vocab_size=m.vocab_size,
              answer_vocab=8)
    batches = [b["tensors"] for b in JSynth(2 * B, seed=3, **kw).batches(
        B, seed=4)]
    qb, vb = proto_banks(m, seed=2)
    jproto = JProto.create(m.n_ques_types, m.n_categories, m.d_model)._replace(
        q_proto=jnp.asarray(qb), v_proto=jnp.asarray(vb))
    tproto = TProto.create(m.n_ques_types, m.n_categories, m.d_model,
                           device="cpu")._replace(
        q_proto=torch.from_numpy(qb), v_proto=torch.from_numpy(vb))
    rng = np.random.default_rng(7)
    # an importance and an anchor a little away from the weights, so the
    # penalty and its gradient are not zero
    omega = jax.tree.map(lambda p: rng.uniform(0, 2, p.shape).astype(
        np.float32), params)
    anchor = jax.tree.map(lambda p: (p + 0.01 * rng.normal(size=p.shape))
                          .astype(np.float32), params)
    return dict(jc=jc, tc=tc, params=params, batches=batches, jproto=jproto,
                tproto=tproto, omega=omega, anchor=anchor)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jreg(s):
    return JR.RegState(omega=_jtree(s["omega"]), anchor=_jtree(s["anchor"]))


def _treg(s):
    return TR.RegState(omega=from_jax_params(s["omega"]),
                       anchor=from_jax_params(s["anchor"]))


def _assert_trees_close(tt, jt, what):
    a, b = tree_leaves(tt), jax.tree.leaves(jax.device_get(jt))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   err_msg=what, **TOL)


def test_penalty_init_and_consolidate_match_jax(setup):
    s = setup
    jp, tp = _jtree(s["params"]), from_jax_params(s["params"])
    np.testing.assert_allclose(float(TR.penalty(tp, _treg(s))),
                               float(JR.penalty(jp, _jreg(s))), **TOL)
    # init: zero importance, the weights as a copy (never an alias)
    treg = TR.init_reg_state(tp)
    _assert_trees_close(treg.anchor, JR.init_reg_state(jp).anchor, "anchor")
    assert float(TR.penalty(tp, treg)) == 0.0
    leaf = tree_leaves(tp)[0]
    before = leaf.clone()
    leaf.add_(1.0)
    assert torch.equal(tree_leaves(treg.anchor)[0], before)
    assert float(TR.penalty(tp, treg)) == 0.0      # omega is still zero
    # consolidate: omega += acc / n, anchor = the new weights
    acc = jax.tree.map(lambda x: np.abs(x), s["anchor"])
    moved = jax.tree.map(lambda x: x + np.float32(0.5), s["params"])
    for n in (4, 3):
        jreg = JR.consolidate(_jreg(s), _jtree(moved), _jtree(acc), n)
        treg = TR.consolidate(_treg(s), from_jax_params(moved),
                              from_jax_params(acc), n)
        _assert_trees_close(treg.omega, jreg.omega, f"omega n={n}")
        _assert_trees_close(treg.anchor, jreg.anchor, f"anchor n={n}")


@pytest.mark.parametrize("kind", ["ewc", "mas"])
def test_importance_step_matches_jax(setup, kind):
    """The accumulator after two batches (added in place on the port)."""
    s = setup
    jstep = JR.make_importance_step(s["jc"], kind, dtype=jnp.float32)
    tstep = TR.make_importance_step(s["tc"], kind, dtype=torch.float32,
                                    device="cpu")
    jp, tp = _jtree(s["params"]), from_jax_params(s["params"])
    jacc = jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32), jp)
    tacc = TR.init_reg_state(tp).omega
    first = tree_leaves(tacc)[0]
    for b in s["batches"]:
        jacc = jstep(jacc, jp, s["jproto"], _jtree(b))
        tacc = tstep(tacc, tp, s["tproto"], b)
    assert tree_leaves(tacc)[0] is first            # in place
    _assert_trees_close(tacc, jacc, kind)
    assert sum(float(x.sum()) for x in tree_leaves(tacc)) > 0.0


def test_unknown_importance_kind_raises(setup):
    with pytest.raises(ValueError, match="unknown regularizer"):
        TR.make_importance_step(setup["tc"], "si", device="cpu")


def _states(s, warmup=0.0):
    m = s["jc"].model
    js = JState.create(_jtree(s["params"]), jax_transform(s["jc"].train),
                       s["jproto"], jax.random.PRNGKey(1),
                       warmup_iters=warmup, t_total=40.0)
    ts = TrainState.create(from_jax_params(s["params"]),
                           make_transform(s["tc"].train), s["tproto"],
                           seed=1, warmup_iters=warmup, t_total=40.0)
    assert m.dropout_rate == 0.0
    return js, ts


def _assert_step_close(js, ts, jm, tm, names):
    for name in names:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **TOL)
    _assert_trees_close(ts.params, js.params, "params")
    assert int(ts.step) == int(js.step)


def test_train_step_with_anchor_penalty_matches_jax(setup):
    s = setup
    lam = 50.0
    jstep = JS.make_train_step(s["jc"], jax_transform(s["jc"].train),
                               dtype=jnp.float32, reg_lambda=lam,
                               donate=False)
    tstep = TS.make_train_step(s["tc"], dtype=torch.float32, device="cpu",
                               reg_lambda=lam)
    js, ts = _states(s)
    b = s["batches"][0]
    js, jm = jstep(js, _jtree(b), _jreg(s))
    ts, tm = tstep(ts, b, _treg(s))
    _assert_step_close(js, ts, jm, tm, ("loss", "grad_norm", "lr"))
    # the penalty is in the loss: without it the loss is smaller
    _, plain = TS.make_train_step(s["tc"], dtype=torch.float32,
                                  device="cpu")(_states(s)[1], b)
    assert float(tm["loss"]) > float(plain["loss"])


def test_logits_step_matches_jax(setup):
    s = setup
    b = s["batches"][0]
    jl = JS.make_logits_step(s["jc"], dtype=jnp.float32)(
        _jtree(s["params"]), s["jproto"], _jtree(b))
    tl = TS.make_logits_step(s["tc"], dtype=torch.float32, device="cpu")(
        from_jax_params(s["params"]), s["tproto"], b)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("reg", ["der", "derpp"])
def test_der_replay_step_matches_jax(setup, reg):
    """One DER/DER++ step against logits stored by another set of weights
    (so the MSE is not zero)."""
    s = setup
    jc, tc = s["jc"], s["tc"]
    jc.train.cl_reg = tc.train.cl_reg = reg
    jc.train.reg_lambda = tc.train.reg_lambda = 0.5
    try:
        teacher = jax_tiny_params(9, dropout_rate=0.0)[1]
        b = dict(s["batches"][1])
        z = TS.make_logits_step(tc, dtype=torch.float32, device="cpu")(
            from_jax_params(teacher), s["tproto"], b)
        b["der_logits"] = z.to(torch.float16).numpy()
        jstep = JS.make_der_replay_step(jc, jax_transform(jc.train),
                                        dtype=jnp.float32, donate=False)
        tstep = TS.make_der_replay_step(tc, dtype=torch.float32,
                                        device="cpu")
        js, ts = _states(s)
        js, jm = jstep(js, _jtree(b))
        ts, tm = tstep(ts, b)
    finally:
        jc.train.cl_reg = tc.train.cl_reg = "none"
        jc.train.reg_lambda = tc.train.reg_lambda = 1.0
    _assert_step_close(js, ts, jm, tm, ("loss", "der_mse", "grad_norm", "lr"))
    assert float(tm["der_mse"]) > 0.0
    for name in JProto._fields:
        np.testing.assert_allclose(getattr(ts.proto, name).numpy(),
                                   np.asarray(getattr(js.proto, name)),
                                   err_msg=name, **TOL)
