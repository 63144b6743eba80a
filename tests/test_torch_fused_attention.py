"""The port's fused attention (plain version, as CPU tensors take it)
against the JAX package's Pallas kernel in interpret mode.

Same inputs, made with numpy from a seed, through
``vqacl_tpu.ops.fused_attention.fused_{encoder,cross}_attention(...,
interpret=True)`` and ``vqacl_tpu_torch.ops.fused_attention``; f32,
rtol/atol 2e-5 as in tests/test_fused_attention.py (the two sum the
dot products in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.ops import fused_attention as jfa  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as tfa  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, Tq, Sk, H, dk, L):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H, dk)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, Sk, H, dk)).astype(np.float32)
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    mask = np.ones((B, Sk), np.float32)
    # ragged key padding, at least one key left in every row
    for b in range(B):
        mask[b, int(rng.integers(1, Sk + 1)):] = 0.0
    return q, k, v, bias, mask


@pytest.mark.parametrize("B,S,H,dk,L", [
    (3, 58, 4, 16, 20),     # the encoder's length, text block L < S
    (2, 13, 3, 8, 5),       # odd length, not a multiple of 8
    (2, 16, 2, 32, 16),     # bias over the whole sequence
])
def test_encoder_attention_matches_pallas(B, S, H, dk, L):
    q, k, v, bias, mask = _inputs(0, B, S, S, H, dk, L)
    ref = jfa.fused_encoder_attention(*map(jnp.asarray, (q, k, v, bias, mask)),
                                      interpret=True)
    out = tfa.fused_encoder_attention(*map(torch.from_numpy,
                                           (q, k, v, bias, mask)))
    assert out.shape == (B, S, H * dk) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,Tq,Sk,H,dk", [(3, 10, 58, 4, 16), (2, 7, 13, 2, 8)])
def test_cross_attention_matches_pallas(B, Tq, Sk, H, dk):
    q, k, v, _, mask = _inputs(1, B, Tq, Sk, H, dk, 0)
    ref = jfa.fused_cross_attention(*map(jnp.asarray, (q, k, v, mask)),
                                    interpret=True)
    out = tfa.fused_cross_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rectangular_with_bias_matches_pallas():
    """Tq ≠ Sk with a bias block smaller than both."""
    rng = np.random.default_rng(2)
    B, Tq, Sk, H, dk, L = 2, 10, 19, 3, 8, 6
    q = rng.normal(size=(B, Tq, H, dk)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, Sk, H, dk)).astype(np.float32)
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    mask = np.ones((B, Sk), np.float32)
    mask[1, 11:] = 0.0
    ref = jfa._fused_mha(*map(jnp.asarray, (q, k, v, bias, mask)),
                         interpret=True)
    out = tfa._fused_mha(*map(torch.from_numpy, (q, k, v, bias, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bf16_keeps_the_kernels_cast_points():
    """In bf16 the plain version rounds p to v's dtype before p·v and
    returns q's dtype, as the Pallas kernel does: it equals an f32
    computation fed the same rounded operands to within one bf16 ulp."""
    q, k, v, bias, mask = _inputs(3, 2, 12, 12, 2, 8, 4)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = tfa.fused_encoder_attention(tq, tk, tv, torch.from_numpy(bias),
                                      torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref = jfa.fused_encoder_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
        jnp.asarray(bias), jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_wrapper_counts_only_kernel_launches_and_rejects_dropout():
    q, k, v, bias, mask = map(torch.from_numpy, _inputs(4, 1, 8, 8, 2, 8, 2))
    before = tfa.fused_attention.launches
    tfa.fused_encoder_attention(q, k, v, bias, mask)   # CPU: plain version
    assert tfa.fused_attention.launches == before
    with pytest.raises(NotImplementedError):
        tfa.fused_encoder_attention(q, k, v, bias, mask, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tfa.fused_encoder_attention(q, k, v, torch.zeros(2, 9, 9), mask)
