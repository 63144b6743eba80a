"""The port's T5 pieces, visual embedding and joint encoder against the
JAX package, on the tiny config with the same weights (a JAX parameter
pytree → ``from_jax_params``) and the same numpy inputs.

Tolerances: f32 throughout; 1e-5 for single ops (summation order only),
5e-5 for the two-layer encoder (the differences compound through the
layers and the layer norms). Relative-position buckets, gathers and
masks are compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import encoder_inputs, jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.models import t5 as jt5  # noqa: E402
from vqacl_tpu.models import vlt5 as jvlt5  # noqa: E402
from vqacl_tpu.models.visual_embedding import apply_visual_embedding as jvis  # noqa: E402
from vqacl_tpu_torch.models import t5 as tt5  # noqa: E402
from vqacl_tpu_torch.models import vlt5 as tvlt5  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.visual_embedding import apply_visual_embedding as tvis  # noqa: E402

OP = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, jp = jax_tiny_params(0)
    return jcfg, jp, torch_cfg_like(jcfg), from_jax_params(jp)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("nb,md", [(32, 128), (8, 16)])
def test_relative_position_buckets_exact(bidirectional, nb, md):
    rp = np.arange(-300, 301, dtype=np.int32)[None, :] \
        - np.arange(0, 3, dtype=np.int32)[:, None]
    ref = jax.jit(jt5.relative_position_bucket, static_argnums=(1, 2, 3))(
        jnp.asarray(rp), bidirectional, nb, md)
    out = tt5.relative_position_bucket(_t(rp), bidirectional, nb, md)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_position_bias_and_masks_exact(setup):
    jcfg, jp, _, tp = setup
    for bidir, table in ((True, "encoder"), (False, "decoder")):
        ref = jax.jit(jt5.compute_position_bias, static_argnums=range(1, 7))(
            jp[table]["rel_bias"], 7, 9, bidir, 8, 16, 2)
        out = tt5.compute_position_bias(tp[table]["rel_bias"], 7, 9, bidir,
                                        8, 16, q_offset=2)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tt5.causal_mask(5).numpy(),
                                  np.asarray(jt5.causal_mask(5)))
    m = np.array([[1, 1, 0], [1, 0, 0]], np.float32)[:, None, None, :]
    pb = np.arange(9, dtype=np.float32).reshape(1, 1, 3, 3)
    np.testing.assert_array_equal(
        tt5.attention_scores_bias(_t(m), _t(pb)).numpy(),
        np.asarray(jt5.attention_scores_bias(jnp.asarray(m), jnp.asarray(pb))))
    np.testing.assert_array_equal(
        tvlt5.joint_pos_bias(tp, torch_cfg_like(jcfg), 6, 4).numpy(),
        np.asarray(jvlt5.joint_pos_bias(jp, jcfg, 6, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_embed_and_head(setup, dtype):
    jcfg, jp, _, tp = setup
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = OP if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    ref = jt5.layer_norm(jnp.asarray(w), jnp.asarray(x, jdt), 1e-6)
    out = tt5.layer_norm(_t(w), _t(x).to(tdt), 1e-6)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tt5.embed_tokens(tp["shared"], _t(ids), tdt).float().numpy(),
        np.asarray(jt5.embed_tokens(jp["shared"], jnp.asarray(ids), jdt),
                   np.float32))
    h = jnp.asarray(x, jdt)
    ref = jt5.lm_logits(jnp.asarray(jp["shared"]), h, jcfg.d_model)
    out = tt5.lm_logits(tp["shared"], _t(x).to(tdt), jcfg.d_model)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)


def test_attention_mlp_and_encoder_block(setup):
    jcfg, jp, tcfg, tp = setup
    rng = np.random.default_rng(2)
    B, S, D = 2, 7, jcfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kv = rng.normal(size=(B, 5, D)).astype(np.float32)
    bias = rng.normal(size=(1, jcfg.num_heads, S, S)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, 4:] = 0
    mask_add = np.asarray(jt5.attention_scores_bias(
        jnp.asarray(mask)[:, None, None, :], None))
    blk_j, blk_t = jp["encoder"]["block_0"], tp["encoder"]["block_0"]

    ref = jt5.multihead_attention(blk_j["attn"], *map(jnp.asarray, (x, x, x)),
                                  jnp.asarray(bias), jcfg.num_heads,
                                  jcfg.d_kv, mask_add=jnp.asarray(mask_add))
    out = tt5.multihead_attention(blk_t["attn"], *map(_t, (x, x, x)), _t(bias),
                                  jcfg.num_heads, jcfg.d_kv,
                                  mask_add=_t(mask_add))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)

    xa = jnp.asarray(x)
    ref = jt5.multihead_attention(blk_j["attn"], xa, jnp.asarray(kv),
                                  jnp.asarray(kv), None, jcfg.num_heads,
                                  jcfg.d_kv)
    out = tt5.multihead_attention(blk_t["attn"], _t(x), _t(kv), _t(kv), None,
                                  jcfg.num_heads, jcfg.d_kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)

    ref = jt5.mlp_apply(blk_j["mlp"], xa, "relu")
    out = tt5.mlp_apply(blk_t["mlp"], _t(x), "relu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)

    ref = jt5.encoder_block(blk_j, jcfg, xa, jnp.asarray(bias),
                            mask_add=jnp.asarray(mask_add))
    out = tt5.encoder_block(blk_t, tcfg, _t(x), _t(bias), _t(mask_add))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)


@pytest.mark.parametrize("explicit_order", [False, True])
def test_visual_embedding_matches_jax(setup, explicit_order):
    jcfg, jp, tcfg, tp = setup
    _, feats, boxes = encoder_inputs(jcfg, 3, seed=3)
    N = jcfg.n_boxes
    img = obj = None
    if explicit_order:
        img = np.array([[0, 0, 1, 1]], np.int32)
        obj = np.array([[3, 1, 0, 2]], np.int32)
    kw_j = dict(img_order_ids=None if img is None else jnp.asarray(img),
                obj_order_ids=None if obj is None else jnp.asarray(obj))
    kw_t = dict(img_order_ids=None if img is None else _t(img),
                obj_order_ids=None if obj is None else _t(obj))
    ref = jvis(jp["visual_embedding"], jcfg, jnp.asarray(jp["shared"]),
               jnp.asarray(feats), jnp.asarray(boxes), **kw_j)
    out = tvis(tp["visual_embedding"], tcfg, tp["shared"], _t(feats),
               _t(boxes), **kw_t)
    assert out.shape == (3, N, jcfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OP)


@pytest.mark.parametrize("fused", [True, False])
def test_encode_matches_jax(setup, fused):
    """The port's encode (fused: the kernel's plain version on CPU) against
    JAX ``vlt5.encode`` with the Pallas kernel in interpret mode."""
    jcfg, jp, _, tp = setup
    jcfg.fused_attention = fused
    jcfg.fused_interpret = True
    tcfg = torch_cfg_like(jcfg, fused_attention=fused)
    ids, feats, boxes = encoder_inputs(jcfg, 3, seed=4)
    ref_h, ref_m = jvlt5.encode(jp, jcfg, *map(jnp.asarray, (ids, feats, boxes)),
                                dtype=jnp.float32)
    out_h, out_m = tvlt5.encode(tp, tcfg, *map(_t, (ids, feats, boxes)),
                                dtype=torch.float32)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h),
                               rtol=5e-5, atol=5e-5)


def test_cast_params_for_inference_keeps_f32_leaves(setup):
    _, jp, _, tp = setup
    cast = tvlt5.cast_params_for_inference(tp, torch.bfloat16)
    assert cast["shared"].dtype == torch.bfloat16
    assert cast["encoder"]["block_0"]["attn"]["wq"].dtype == torch.bfloat16
    for leaf in (cast["encoder"]["block_0"]["ln1"], cast["encoder"]["rel_bias"],
                 cast["decoder"]["final_ln"],
                 cast["visual_embedding"]["feat_ln"]):
        assert leaf.dtype == torch.float32
    jcast = jvlt5.cast_params_for_inference(jp, jnp.bfloat16)
    np.testing.assert_array_equal(
        cast["decoder"]["block_1"]["mlp"]["wo"].float().numpy(),
        np.asarray(jcast["decoder"]["block_1"]["mlp"]["wo"], np.float32))
