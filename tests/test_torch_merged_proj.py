"""Merged q/k/v and folded cross-K/V projections: the port against the
JAX package, against its own separate path, and the strided views the
kernels' plain versions take.

Mirrors ``tests/test_train_step.py``'s ``test_merged_qkv_equals_separate``
and ``test_folded_cross_kv_equals_separate`` across the two packages:
one set of tiny weights and one batch made with numpy from seeds (f32,
dropout 0). JAX runs its plain attention (``fused_attention`` "auto" on
the CPU); the port runs its fused path (the plain versions of K1′/K2
through ``_FusedAttentionPacked``), and its unfused path. Loss within
``LOSS_RTOL`` relative, gradients within ``GRAD_TOL``, greedy and beam
(3) tokens equal. The plain attention versions give the same bits on
strided views as on dense copies, and the CL trainer resolves
``merged_qkv="auto"`` to True as JAX's does while ``make_eval_step``
leaves it alone.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.models import vlt5 as jvlt5  # noqa: E402
from vqacl_tpu.models.generate import beam_search as jax_beam  # noqa: E402
from vqacl_tpu.models.generate import greedy_decode as jax_greedy  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu_torch.models import vlt5  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.generate import (beam_search,  # noqa: E402
                                             greedy_decode)
from vqacl_tpu_torch.models.prototype import ProtoState  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402

# the JAX test's own bounds for merged against separate, f32
LOSS_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = 96


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    B, L, N, T = 3, cfg.max_text_length, cfg.n_boxes, 4
    return {
        "input_ids": rng.integers(2, VOCAB, size=(B, L)).astype(np.int32),
        "vis_feats": rng.normal(size=(B, N, cfg.feat_dim)).astype(np.float32),
        "boxes": rng.uniform(0, 1, (B, N, 4)).astype(np.float32),
        "target_ids": rng.integers(2, VOCAB, size=(B, T)).astype(np.int32),
        "scores": rng.uniform(0.5, 1, B).astype(np.float32),
        "ques_labels": np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)],
        "cate_labels": np.eye(80, dtype=np.float32)[rng.integers(0, 80, B)],
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if hasattr(tree, "detach")
                               else tree)}


@pytest.fixture(scope="module")
def setup():
    jcfg, params = jax_tiny_params(3, vocab_size=VOCAB, dropout_rate=0.0)
    return jcfg, params, _batch(jcfg)


def _jax(jcfg, params, batch, merged, folded):
    c = copy.deepcopy(jcfg)
    c.merged_qkv, c.folded_cross_kv = merged, folded
    proto = JProto.create(10, 80, c.d_model)

    def loss(p):
        return jvlt5.forward_train(p, c, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                   proto, 0.3, 0.3, deterministic=True,
                                   dtype=jnp.float32).loss

    l, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
    return float(l), _flat(jax.device_get(g))


def _port(jcfg, params, batch, merged, folded, **model):
    c = torch_cfg_like(jcfg, merged_qkv=merged, folded_cross_kv=folded,
                       **model)
    live = from_jax_params(params)
    leaves = _flat_t(live)
    for t in leaves.values():
        t.requires_grad_()
    proto = ProtoState.create(10, 80, c.d_model, device="cpu")
    out = vlt5.forward_train(live, c, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                             proto, 0.3, 0.3, dtype=torch.float32)
    out.loss.backward()
    return float(out.loss.detach()), {
        k: (np.zeros(t.shape, np.float32) if t.grad is None
            else t.grad.numpy()) for k, t in leaves.items()}


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# port model variants: the fused path (plain K1′/K2 versions), the fused
# decoder too, and the unfused path
PORT_PATHS = {"fused": {}, "fused_decoder": {"fused_decoder": True},
              "unfused": {"fused_attention": False}}


@pytest.mark.parametrize("path", list(PORT_PATHS))
@pytest.mark.parametrize("merged,folded", [(True, False), (False, True),
                                           (True, True)])
def test_forward_and_grads_equal_jax(setup, merged, folded, path):
    jcfg, params, batch = setup
    jl, jg = _jax(jcfg, params, batch, merged, folded)
    tl, tg = _port(jcfg, params, batch, merged, folded, **PORT_PATHS[path])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert jg.keys() == tg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("path", list(PORT_PATHS))
@pytest.mark.parametrize("merged,folded", [(True, False), (False, True),
                                           (True, True)])
def test_merged_equals_the_ports_separate_path(setup, merged, folded, path):
    jcfg, params, batch = setup
    l0, g0 = _port(jcfg, params, batch, False, False, **PORT_PATHS[path])
    l1, g1 = _port(jcfg, params, batch, merged, folded, **PORT_PATHS[path])
    np.testing.assert_allclose(l1, l0, rtol=LOSS_RTOL)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("merged,folded", [(True, False), (False, True),
                                           (True, True)])
def test_decode_tokens_equal_jax(setup, merged, folded):
    jcfg, params, batch = setup
    jon = copy.deepcopy(jcfg)
    jon.merged_qkv, jon.folded_cross_kv = merged, folded
    tcfg = torch_cfg_like(jcfg, merged_qkv=merged, folded_cross_kv=folded)
    jp = jax.tree.map(jnp.asarray, params)
    enc, mask = jvlt5.encode(jp, jcfg, jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["vis_feats"]),
                             jnp.asarray(batch["boxes"]), dtype=jnp.float32)
    tp = from_jax_params(params)
    tenc, tmask = torch.from_numpy(np.array(enc)), \
        torch.from_numpy(np.array(mask))
    for jfn, tfn in ((jax_greedy, greedy_decode),
                     (lambda *a, **k: jax_beam(*a, num_beams=3, **k),
                      lambda *a, **k: beam_search(*a, num_beams=3, **k))):
        ref = np.asarray(jfn(jp, jon, enc, mask, dtype=jnp.float32))
        out = tfn(tp, tcfg, tenc, tmask, dtype=torch.float32).numpy()
        np.testing.assert_array_equal(out, ref)
        off = tfn(tp, torch_cfg_like(jcfg), tenc, tmask,
                  dtype=torch.float32).numpy()
        np.testing.assert_array_equal(out, off)


def _packed_inputs(B, Tq, Sk, H, dk, layout, seed=0):
    rng = np.random.default_rng(seed)
    W = H * dk
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    do = r(B, Tq, W)
    mask = torch.ones(B, Sk)
    mask[0, Sk // 2:] = 0.0
    if layout == "self":
        x, kv = r(B, Tq, 3 * W), None
    else:
        x, kv = r(B, Tq, W), r(B, Sk, 2 * W)
    return x, kv, do, mask


@pytest.mark.parametrize("layout,Tq,Sk,L", [("self", 7, 7, 4),
                                            ("cross", 5, 9, 0)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_versions_ignore_the_stride(layout, Tq, Sk, L, rate):
    """K1, K1′ and K2's plain versions on column slices of a packed
    buffer give the bits they give on dense copies."""
    H, dk = 2, 4
    x, kv, do, mask = _packed_inputs(3, Tq, Sk, H, dk, layout)
    views = fa._unpack(x, kv)
    dense = tuple(t.contiguous() for t in views)
    assert fa._qkv_strides(*views) != fa._qkv_strides(*dense)
    bias = torch.randn(H, L, L) if L else None
    seed = torch.tensor([5], dtype=torch.int32)
    if rate == 0.0:
        assert torch.equal(
            fa.fused_attention_reference(*views, bias, mask, H),
            fa.fused_attention_reference(*dense, bias, mask, H))
    o_v, p_v = fa.fused_attention_fwd_train_reference(*views, bias, mask,
                                                      seed, H, rate)
    o_d, p_d = fa.fused_attention_fwd_train_reference(*dense, bias, mask,
                                                      seed, H, rate)
    assert torch.equal(o_v, o_d) and torch.equal(p_v, p_d)
    for a, b in zip(fa.fused_attention_bwd_reference(*views, p_v, seed, do,
                                                     H, L, rate),
                    fa.fused_attention_bwd_reference(*dense, p_d, seed, do,
                                                     H, L, rate)):
        assert a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("layout,Tq,Sk,L", [("self", 7, 7, 4),
                                            ("cross", 5, 9, 0)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_packed_function_returns_one_gradient_buffer(layout, Tq, Sk, L,
                                                     rate):
    """``fused_attention_packed`` (``_FusedAttentionPacked``) against
    ``fused_attention`` on dense copies: the same output, and the packed
    input's gradient is the dense dq, dk, dv side by side, bit for bit;
    K2's ``out`` takes only buffers of its inputs' row strides."""
    H, dk = 2, 4
    x, kv, do, mask = _packed_inputs(3, Tq, Sk, H, dk, layout, seed=1)
    bias = torch.randn(H, L, L) if L else None
    seed = torch.tensor([9], dtype=torch.int32)
    xg = x.clone().requires_grad_()
    kvg = None if kv is None else kv.clone().requires_grad_()
    o = fa.fused_attention_packed(xg, kvg, bias, mask, H, rate, seed)
    o.backward(do)
    dense = [t.contiguous().requires_grad_() for t in fa._unpack(x, kv)]
    o2 = fa.fused_attention(*dense, bias, mask, H, rate, seed)
    o2.backward(do)
    assert torch.equal(o, o2)
    grads = [t.grad for t in dense]
    if kv is None:
        assert torch.equal(xg.grad, torch.cat(grads, dim=-1))
    else:
        assert torch.equal(xg.grad, grads[0])
        assert torch.equal(kvg.grad, torch.cat(grads[1:], dim=-1))
    # without grad: K1 on the strided views
    with torch.no_grad():
        assert torch.equal(
            fa.fused_attention_packed(x, kv, bias, mask, H),
            fa.fused_attention(*[t.contiguous() for t in fa._unpack(x, kv)],
                               bias, mask, H))
    q, k, v = fa._unpack(x, kv)
    _, p = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H, rate)
    with pytest.raises(ValueError, match="row stride"):
        fa.fused_attention_bwd(q, k, v, p, seed, do, H, L, rate,
                               out=tuple(t.contiguous() for t in (q, k, v)))


def test_packed_inputs_must_be_dense():
    x = torch.randn(2, 5, 3 * 8 + 2)[..., :24]
    with pytest.raises(ValueError, match="dense projection output"):
        fa.fused_attention_packed(x, None, None, torch.ones(2, 5), 2)


def test_auto_resolves_in_the_trainer_only(tmp_path):
    """``merged_qkv="auto"``: JAX's (on a one-device mesh) and the
    port's CL trainers resolve it to True; ``make_eval_step`` leaves it
    "auto", which the blocks read as the separate projections."""
    from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer
    from vqacl_tpu.data.synthetic_module import SyntheticDataModule as JData
    from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok
    from vqacl_tpu.parallel import make_mesh
    from vqacl_tpu.train.step import make_eval_step as jax_eval_step
    from vqacl_tpu.utils.config import Config as JConfig
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import t5
    from vqacl_tpu_torch.train.step import make_eval_step
    from vqacl_tpu_torch.utils.config import Config

    jm, params = jax_tiny_params(0, vocab_size=32200)
    data = dict(tasks=["q_recognition"], n_train_per_task=8,
                n_val_per_task=4, n_test_per_task=4, feat_dim=jm.feat_dim,
                n_boxes=jm.n_boxes, seed=0)
    jc = JConfig()
    jc.model = jm
    jc.output = str(tmp_path / "jax")
    tc = Config()
    tc.model = torch_cfg_like(jm)
    tc.output = str(tmp_path / "port")
    assert jc.model.merged_qkv == tc.model.merged_qkv == "auto"
    jax_eval_step(jc, dtype=jnp.float32)
    make_eval_step(tc, dtype=torch.float32, device="cpu")
    assert jc.model.merged_qkv == tc.model.merged_qkv == "auto"
    assert not t5.merged_qkv(tc.model)
    JTrainer(jc, JData(JTok(), **data), JTok(), verbose=False,
             mesh_ctx=make_mesh(dp=1, devices=jax.devices()[:1]),
             init_params=jax.tree.map(jnp.asarray, params))
    VQACLTrainer(tc, SyntheticDataModule(VLT5Tokenizer(), **data),
                 VLT5Tokenizer(), verbose=False, device="cpu",
                 init_params=from_jax_params(params))
    assert jc.model.merged_qkv is True and tc.model.merged_qkv is True
    assert t5.merged_qkv(tc.model)
