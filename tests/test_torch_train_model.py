"""The port's training model pieces against the JAX package: the
teacher-forced decoder, ``shift_right`` and dropout; the prototype
update, class means and memory loss; the fused LM-head loss.

Inputs are made with numpy from seeds and handed to both packages; f32
on the CPU, dropout 0 unless stated.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.models import prototype as jproto  # noqa: E402
from vqacl_tpu.models import t5 as jt5  # noqa: E402
from vqacl_tpu.models import vlt5 as jvlt5  # noqa: E402
from vqacl_tpu_torch.models import prototype as tproto  # noqa: E402
from vqacl_tpu_torch.models import t5 as tt5  # noqa: E402
from vqacl_tpu_torch.models import vlt5 as tvlt5  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)
T = torch.from_numpy


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# ---- (b) decoder, shift_right, dropout ------------------------------------

def test_shift_right_exact():
    labels = np.array([[5, 7, 1, -100, -100], [9, 1, -100, -100, -100],
                       [3, 4, 6, 8, 1]], np.int32)
    ref = np.asarray(jt5.shift_right(jnp.asarray(labels), 0, 0))
    out = tt5.shift_right(T(labels), 0, 0).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32


def test_decoder_stack_forward_and_grads_match_jax():
    jcfg, params = jax_tiny_params(0, dropout_rate=0.0)
    tcfg = torch_cfg_like(jcfg)
    rng = np.random.default_rng(1)
    B, Tt, S, D = 3, 5, 9, jcfg.d_model
    emb = rng.normal(size=(B, Tt, D)).astype(np.float32)
    enc = rng.normal(size=(B, S, D)).astype(np.float32)
    enc_mask = np.ones((B, S), np.float32)
    enc_mask[0, 6:] = 0.0
    enc_mask[2, 3:] = 0.0
    w = rng.normal(size=(B, Tt, D)).astype(np.float32)

    def jloss(dec, emb, enc):
        out = jt5.decoder_stack(dec, jcfg, emb, enc, jnp.asarray(enc_mask),
                                deterministic=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                has_aux=True))(
        jax.tree.map(jnp.asarray, params["decoder"]), jnp.asarray(emb),
        jnp.asarray(enc))

    dec = from_jax_params(params["decoder"])
    leaves = {k: v.requires_grad_() for k, v in _torch_leaves(dec).items()}
    temb, tenc = T(emb).requires_grad_(), T(enc).requires_grad_()
    out = tt5.decoder_stack(dec, tcfg, temb, tenc, T(enc_mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * T(w)).sum().backward()
    jgd = _flat(jax.device_get(jg[0]))
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), jgd[k], err_msg=k,
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(temb.grad.numpy(), np.asarray(jg[1]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tenc.grad.numpy(), np.asarray(jg[2]),
                               rtol=2e-5, atol=2e-5)


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_dropout_keeps_the_share_and_the_mean():
    """rate 0.1: about 90 % kept, kept values scaled by 1/0.9, so the
    mean is preserved; the identity without a generator or at rate 0."""
    x = torch.ones(400, 500)
    g = torch.Generator().manual_seed(0)
    y = tt5.dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005, kept           # σ ≈ 0.0004
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
    assert abs(y.mean().item() - 1.0) < 0.006
    assert tt5.dropout(x, 0.1, None) is x
    assert tt5.dropout(x, 0.0, g) is x
    y2 = tt5.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


# ---- (c) prototypes ----------------------------------------------------------

def test_proto_update_sequence_exact():
    """Task 0 steps 0/1/2, then task 2 steps 0/1/2/3 after start_task:
    every branch (first batch, bootstrap, EMA; task 0 vs later) matches
    JAX state by state, bit for bit in f32."""
    NQ, NV, D = 10, 80, 16
    rng = np.random.default_rng(2)
    ts = tproto.ProtoState.create(NQ, NV, D, device="cpu")
    js = jproto.ProtoState.create(NQ, NV, D)
    schedule = [(0, 3), (2, 4)]
    for task, n in schedule:
        ts = ts.start_task(task)
        js = js.start_task(task)
        for _ in range(n):
            cq = rng.normal(size=(NQ, D)).astype(np.float32)
            cv = rng.normal(size=(NV, D)).astype(np.float32)
            nq = rng.integers(0, 4, NQ).astype(np.float32)
            nv = rng.integers(0, 4, NV).astype(np.float32)
            js = jproto.proto_update(js, *map(jnp.asarray, (cq, cv, nq, nv)),
                                     0.5, 0.3)
            ts = tproto.proto_update(ts, *map(T, (cq, cv, nq, nv)), 0.5, 0.3)
            for name in jproto.ProtoState._fields:
                np.testing.assert_array_equal(
                    getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                    err_msg=f"task {task} {name}")
    assert int(ts.steps_in_task) == 4 and int(ts.task_id) == 2


def test_batch_class_means_and_memory_loss_match_jax():
    NQ, NV, D, B = 10, 80, 16, 12
    rng = np.random.default_rng(3)
    pq = rng.normal(size=(B, D)).astype(np.float32)
    pv = rng.normal(size=(B, D)).astype(np.float32)
    ql = np.eye(NQ, dtype=np.float32)[rng.integers(0, NQ, B)]
    cl = np.eye(NV, dtype=np.float32)[rng.integers(0, NV, B)]
    for pooled, lab in ((pq, ql), (pv, cl)):
        jm, jn = jproto.batch_class_means(jnp.asarray(pooled),
                                          jnp.asarray(lab))
        tm, tn = tproto.batch_class_means(T(pooled), T(lab))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    banks = (rng.normal(size=(NQ, D)).astype(np.float32),
             rng.normal(size=(NV, D)).astype(np.float32))
    js = jproto.ProtoState.create(NQ, NV, D)._replace(
        q_proto=jnp.asarray(banks[0]), v_proto=jnp.asarray(banks[1]))
    ts = tproto.ProtoState.create(NQ, NV, D, device="cpu")._replace(
        q_proto=T(banks[0]).requires_grad_(), v_proto=T(banks[1]))

    def jl(pq, pv):
        lq, lv = jproto.memory_loss(pq, pv, jnp.asarray(ql), jnp.asarray(cl),
                                    js)
        return lq + 2.0 * lv, (lq, lv)

    (_, (jlq, jlv)), jg = jax.value_and_grad(jl, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(pq), jnp.asarray(pv))
    tpq, tpv = T(pq).requires_grad_(), T(pv).requires_grad_()
    lq, lv = tproto.memory_loss(tpq, tpv, T(ql), T(cl), ts)
    (lq + 2.0 * lv).backward()
    np.testing.assert_allclose([float(lq.detach()), float(lv.detach())],
                               [float(jlq), float(jlv)], rtol=2e-6)
    np.testing.assert_allclose(tpq.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(tpv.grad.numpy(), np.asarray(jg[1]), **TOL)
    assert ts.q_proto.grad is None          # the banks are detached


# ---- (d) the fused head loss -------------------------------------------------

def test_fused_head_loss_matches_jax_and_autograd():
    """Value and d(hidden), d(shared), d(scores) against JAX's custom VJP
    and against autograd of the port's weighted_lm_loss(lm_logits(...))."""
    rng = np.random.default_rng(4)
    B, Tt, D, V = 4, 5, 16, 50
    rescale = D ** -0.5
    hidden = rng.normal(size=(B, Tt, D)).astype(np.float32)
    shared = rng.normal(size=(V, D)).astype(np.float32)
    labels = rng.integers(2, V, size=(B, Tt)).astype(np.int32)
    labels[0, 3:] = -100
    labels[2, 1:] = -100
    scores = rng.uniform(0.3, 1.0, B).astype(np.float32)

    jl, jg = jax.jit(jax.value_and_grad(
        lambda h, s, lab, sc: jvlt5.fused_head_loss(h, s, lab, sc, rescale),
        argnums=(0, 1, 3)))(jnp.asarray(hidden), jnp.asarray(shared),
                            jnp.asarray(labels), jnp.asarray(scores))
    th, tsh, tsc = (T(x).requires_grad_() for x in (hidden, shared, scores))
    loss = tvlt5.fused_head_loss(th, tsh, T(labels), tsc, rescale)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-6)
    for name, t, j in (("hidden", th, jg[0]), ("shared", tsh, jg[1]),
                       ("scores", tsc, jg[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=name, **TOL)

    ah, ash, asc = (T(x).requires_grad_() for x in (hidden, shared, scores))
    ref = tvlt5.weighted_lm_loss(tt5.lm_logits(ash, ah, D), T(labels), asc)
    ref.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()),
                               rtol=2e-6)
    for name, t, a in (("hidden", th, ah), ("shared", tsh, ash),
                       ("scores", tsc, asc)):
        np.testing.assert_allclose(t.grad.numpy(), a.grad.numpy(),
                                   err_msg=name, **TOL)


def test_token_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 4, 20)).astype(np.float32)
    labels = rng.integers(0, 20, size=(3, 4)).astype(np.int32)
    labels[1, 2:] = -100
    jn, jm = jvlt5.token_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels))
    tn, tm = tvlt5.token_cross_entropy(T(logits), T(labels))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
