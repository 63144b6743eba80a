"""The port's training attention (plain K1′ and K2, and the autograd
Function that joins them) against the JAX package's Pallas kernels in
interpret mode, and its Philox dropout streams.

Same inputs, made with numpy from a seed, through
``vqacl_tpu.ops.fused_attention._call_fwd(save_p=True)``, ``_call_bwd``
and ``jax.grad`` of ``fused_{encoder,cross}_attention(interpret=True)``
and through ``vqacl_tpu_torch.ops.fused_attention`` on CPU tensors (the
plain versions); f32 at dropout 0 (the TPU's random bits cannot be
reproduced), rtol/atol 2e-5 as in tests/test_fused_attention.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.ops import fused_attention as jfa  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as tfa  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)

# (B, Tq, Sk, H, dk, L): ragged masks everywhere; the encoder's length
# with L < S; odd lengths; Tq ≠ Sk with a bias block; L = 0 (cross)
CASES = [
    (3, 58, 58, 4, 16, 20),
    (2, 13, 13, 3, 8, 5),
    (2, 10, 19, 3, 8, 6),
    (3, 10, 58, 4, 16, 0),
]


def _inputs(seed, B, Tq, Sk, H, dk, L):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H * dk)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H * dk)).astype(np.float32)
    v = rng.normal(size=(B, Sk, H * dk)).astype(np.float32)
    do = rng.normal(size=(B, Tq, H * dk)).astype(np.float32)
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    mask = np.ones((B, Sk), np.float32)
    for b in range(B):
        mask[b, int(rng.integers(1, Sk + 1)):] = 0.0
    return q, k, v, do, bias, mask


def _jax_bias(bias, H, L):
    return jnp.asarray(bias) if L else jnp.zeros((H, 8, 8), jnp.float32)


@pytest.mark.parametrize("B,Tq,Sk,H,dk,L", CASES)
def test_plain_k1_train_and_k2_match_pallas(B, Tq, Sk, H, dk, L):
    q, k, v, do, bias, mask = _inputs(0, B, Tq, Sk, H, dk, L)
    seed = np.zeros((1,), np.int32)
    jb = _jax_bias(bias, H, L)
    jo, jp = jfa._call_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                           jnp.asarray(mask)[:, None, :], jnp.asarray(seed),
                           True, 0.0, H, L, save_p=True)
    T = torch.from_numpy
    tb = T(bias) if L else None
    to, tp = tfa.fused_attention_fwd_train(T(q), T(k), T(v), tb, T(mask),
                                           T(seed), H, 0.0)
    assert tp.shape == (B, H * Tq, Sk) and tp.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)

    jdq, jdk, jdv, jdb = jfa._call_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jp, jnp.asarray(seed),
        jnp.asarray(do), True, 0.0, H, L, jb.shape[-1])
    dq, dk, dv, db = tfa.fused_attention_bwd(T(q), T(k), T(v), tp, T(seed),
                                             T(do), H, L, 0.0)
    for name, a, b in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    if L:
        np.testing.assert_allclose(db.numpy(), np.asarray(jdb)[:, :L, :L],
                                   **TOL)
    else:
        assert db is None and not np.asarray(jdb).any()


@pytest.mark.parametrize("B,Tq,Sk,H,dk,L", CASES)
def test_autograd_function_matches_jax_grad(B, Tq, Sk, H, dk, L):
    """Loss Σ o·w through the port's Function (K1′ + K2 plain versions)
    and through JAX's custom VJP: value and the grads of q, k, v, bias."""
    q, k, v, w, bias, mask = _inputs(1, B, Tq, Sk, H, dk, L)
    shp = lambda x, n: x.reshape(B, n, H, dk)
    jm = jnp.asarray(mask)

    def jloss(q, k, v, bias):
        if L:
            o = jfa.fused_encoder_attention(shp(q, Tq), shp(k, Sk),
                                            shp(v, Sk), bias, jm,
                                            interpret=True) \
                if Tq == Sk else jfa._fused_mha(shp(q, Tq), shp(k, Sk),
                                                shp(v, Sk), bias, jm,
                                                interpret=True)
        else:
            o = jfa.fused_cross_attention(shp(q, Tq), shp(k, Sk), shp(v, Sk),
                                          jm, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (q, k, v, bias)))

    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_() for x in
                      (q, k, v, bias))
    before = (tfa.fused_attention.launches,
              tfa.fused_attention_fwd_train.launches,
              tfa.fused_attention_bwd.launches)
    if L:
        o = tfa._fused_mha(shp(tq, Tq), shp(tk, Sk), shp(tv, Sk), tb,
                           torch.from_numpy(mask))
    else:
        o = tfa.fused_cross_attention(shp(tq, Tq), shp(tk, Sk), shp(tv, Sk),
                                      torch.from_numpy(mask))
    assert o.grad_fn is not None and "_FusedAttention" in type(o.grad_fn
                                                                ).__name__
    loss = (o * torch.from_numpy(w)).sum()
    loss.backward()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tfa.fused_attention.launches,
            tfa.fused_attention_fwd_train.launches,
            tfa.fused_attention_bwd.launches) == before
    # a sum of signed terms: its error scales with Σ|o·w|, not with |Σ o·w|
    scale = float((o.detach() * torch.from_numpy(w)).abs().sum())
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0,
                               atol=2e-5 * scale)
    for name, t, j in (("q", tq, jg[0]), ("k", tk, jg[1]), ("v", tv, jg[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=name, **TOL)
    if L:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[3]), **TOL)
    else:
        assert tb.grad is None


def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123)."""
    t = lambda x: torch.tensor([x], dtype=torch.int64)
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xffffffff,) * 4, (0xffffffff,) * 2,
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        got = tfa.philox4x32_10(*map(t, ctr), *map(t, key))
        assert tuple(int(g) for g in got) == want


def test_dropout_streams_and_gradient_at_rate_0_1():
    """At rate 0.1 the keep mask keeps ~90 % of the elements, depends on
    the seed and on (b, h, i, j), and K2 (plain) is the exact gradient of
    K1′ (plain) under that mask: both equal autograd through an
    attention written out with the same mask."""
    B, Tq, Sk, H, dk, L, rate = 4, 12, 14, 3, 8, 5, 0.1
    q, k, v, w, bias, mask = _inputs(2, B, Tq, Sk, H, dk, L)
    seed = torch.tensor([12345], dtype=torch.int32)
    keep = tfa.philox_keep_mask(seed, B, H, Tq, Sk, rate)
    share = keep.float().mean().item()
    assert abs(share - (1 - rate)) < 0.02, share
    other = tfa.philox_keep_mask(torch.tensor([12346], dtype=torch.int32),
                                 B, H, Tq, Sk, rate)
    assert (keep != other).float().mean().item() > 0.1
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep[0, 0], keep[1, 0])

    T = torch.from_numpy
    tq, tk, tv, tb = (T(x).requires_grad_() for x in (q, k, v, bias))
    o = tfa.fused_attention(tq, tk, tv, tb, T(mask), H, dropout_rate=rate,
                            seed=seed)
    (o * T(w)).sum().backward()

    rq, rk, rv, rb = (T(x).requires_grad_() for x in (q, k, v, bias))
    p = tfa._probs(rq, rk, rb, T(mask), H)
    pd = torch.where(keep, p / torch.tensor(1 - rate), 0.0)
    ro = tfa._merge(pd @ tfa._heads(rv, H))
    (ro * T(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), ro.detach().numpy(),
                               **TOL)
    for a, b in ((tq, rq), (tk, rk), (tv, rv), (tb, rb)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **TOL)


def test_inference_path_rejects_dropout_and_counts_nothing_on_cpu():
    """Without grad the wrapper runs K1 (plain version on the CPU), which
    is inference-only; with grad it goes through the Function."""
    q, k, v, _, bias, mask = map(torch.from_numpy,
                                 _inputs(3, 1, 8, 8, 2, 4, 2))
    with torch.no_grad():
        with pytest.raises(NotImplementedError):
            tfa.fused_attention(q, k, v, bias, mask, 2, dropout_rate=0.1)
        o = tfa.fused_attention(q, k, v, bias, mask, 2)
    assert o.grad_fn is None
    o2 = tfa.fused_attention(q.requires_grad_(), k, v, bias, mask, 2,
                             dropout_rate=0.1)
    assert o2.grad_fn is not None
