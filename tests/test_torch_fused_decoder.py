"""The port's fused teacher-forced decoder against the JAX package.

``decoder_stack(fused=True)`` runs the causal self-attention (the whole
causal + relative bias [H,T,T] as the kernels' bias block) and the
bias-free cross-attention through ``ops.fused_attention``; on CPU
tensors that is the kernels' plain versions inside the same autograd
Function. It is held against JAX ``t5.decoder_stack(fused={"interpret":
True})``, the Pallas kernels in interpret mode, at the geometry of
``tests/test_fused_attention.py::test_decoder_stack_fused_matches_unfused``
(tiny config, d_kv 16, B 3, T 9, S 17, one padded encoder row): forward
within 2e-4 and every parameter gradient, the relative-bias table
included, within 5e-4. The fused decoder is also held against the
port's unfused one, and ``make_loss_eval_step`` with ``fused_decoder``
against JAX's within 1e-5 relative. Dropout 0, f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, proto_banks, torch_cfg_like  # noqa: E402
from vqacl_tpu.data.synthetic import SyntheticVQA as JSynth  # noqa: E402
from vqacl_tpu.models import t5 as jt5  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.train.step import make_loss_eval_step as jax_loss_eval  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu.utils.config import tiny_model_config as jax_tiny  # noqa: E402
from vqacl_tpu_torch.models import t5 as tt5  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402
from vqacl_tpu_torch.train.optim import (tree_leaves, tree_map,  # noqa: E402
                                         tree_unflatten)
from vqacl_tpu_torch.train.step import make_loss_eval_step  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
B, T, S = 3, 9, 17


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if hasattr(tree, "detach")
                               else tree)}


@pytest.fixture(scope="module")
def decoder_setup():
    cfg = jax_tiny(d_kv=16)
    p = jax.device_get(jt5.init_stack(jax.random.PRNGKey(1), cfg,
                                      is_decoder=True))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    em = np.ones((B, S), np.float32)
    em[1, 12:] = 0.0
    return cfg, p, x, enc, em


def _torch_run(cfg, p, x, enc, em, fused):
    """(output, gradients of Σ sin(output)) of the port's decoder."""
    live = tree_map(lambda t: t.detach().requires_grad_(),
                    from_jax_params(p))
    out = tt5.decoder_stack(live, cfg, torch.from_numpy(x),
                            torch.from_numpy(enc), torch.from_numpy(em),
                            fused=fused)
    grads = torch.autograd.grad(torch.sin(out).sum(), tree_leaves(live))
    return out.detach().numpy(), _flat(tree_unflatten(live, grads))


def test_fused_decoder_stack_matches_jax(decoder_setup):
    jcfg, p, x, enc, em = decoder_setup
    tcfg = torch_cfg_like(jcfg)
    jp = jax.tree.map(jnp.asarray, p)
    args = (jnp.asarray(x), jnp.asarray(enc), jnp.asarray(em))

    def jrun(params):
        return jt5.decoder_stack(params, jcfg, *args,
                                 fused={"interpret": True})

    jout = np.asarray(jrun(jp))
    jgrad = _flat(jax.device_get(
        jax.grad(lambda q: jnp.sum(jnp.sin(jrun(q))))(jp)))
    tout, tgrad = _torch_run(tcfg, p, x, enc, em, fused=True)
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    assert set(tgrad) == set(jgrad)
    for k in jgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], err_msg=k, **GRAD_TOL)
    # the relative bias reaches its table through K2's dbias
    assert np.abs(tgrad["/rel_bias"]).max() > 1e-3


def test_fused_decoder_stack_matches_the_unfused_port(decoder_setup):
    jcfg, p, x, enc, em = decoder_setup
    tcfg = torch_cfg_like(jcfg)
    fout, fgrad = _torch_run(tcfg, p, x, enc, em, fused=True)
    uout, ugrad = _torch_run(tcfg, p, x, enc, em, fused=False)
    np.testing.assert_allclose(fout, uout, rtol=2e-5, atol=2e-5)
    for k in ugrad:
        np.testing.assert_allclose(fgrad[k], ugrad[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_fused_decoder_routes_through_the_kernels(decoder_setup,
                                                  monkeypatch):
    """Training calls K1′ and K2 twice per decoder layer (self and cross
    attention); without grad the same stack calls K1 twice per layer.
    On the CPU the wrappers take their plain versions, counted here."""
    jcfg, p, x, enc, em = decoder_setup
    tcfg = torch_cfg_like(jcfg)
    calls = {"k1": 0, "k1p": 0, "k2": 0}

    def counting(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    for key, name in (("k1", "fused_attention_reference"),
                      ("k1p", "fused_attention_fwd_train_reference"),
                      ("k2", "fused_attention_bwd_reference")):
        monkeypatch.setattr(fa, name, counting(key, getattr(fa, name)))
    _torch_run(tcfg, p, x, enc, em, fused=True)
    n = tcfg.num_decoder_layers
    assert calls == {"k1": 0, "k1p": 2 * n, "k2": 2 * n}
    with torch.no_grad():
        tt5.decoder_stack(from_jax_params(p), tcfg, torch.from_numpy(x),
                          torch.from_numpy(enc), torch.from_numpy(em),
                          fused=True)
    assert calls["k1"] == 2 * n
    # no encoder mask: the unfused path, as in JAX
    calls.update(k1=0, k1p=0, k2=0)
    with torch.no_grad():
        tt5.decoder_stack(from_jax_params(p), tcfg, torch.from_numpy(x),
                          torch.from_numpy(enc), None, fused=True)
    assert calls == {"k1": 0, "k1p": 0, "k2": 0}


def test_loss_eval_step_with_fused_decoder_matches_jax():
    jcfg, params = jax_tiny_params(0, dropout_rate=0.0)
    jcfg.fused_attention = True
    jcfg.fused_interpret = True
    jcfg.fused_decoder = True
    jc = JConfig()
    jc.model = jcfg
    tc = TConfig()
    tc.model = torch_cfg_like(jcfg)
    assert tc.model.fused_decoder and tc.model.fused_attention
    qb, vb = proto_banks(jcfg, seed=2)
    batch = next(JSynth(8, seed=3, feat_dim=jcfg.feat_dim,
                        n_boxes=jcfg.n_boxes, text_len=jcfg.max_text_length,
                        vocab_size=jcfg.vocab_size, answer_vocab=8)
                 .batches(8, seed=4))["tensors"]
    jproto = JProto.create(jcfg.n_ques_types, jcfg.n_categories,
                           jcfg.d_model)._replace(q_proto=jnp.asarray(qb),
                                                  v_proto=jnp.asarray(vb))
    jloss = float(jax_loss_eval(jc, dtype=jnp.float32)(
        jax.tree.map(jnp.asarray, params), jproto,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    tproto = TProto.create(jcfg.n_ques_types, jcfg.n_categories,
                           jcfg.d_model, device="cpu")._replace(
        q_proto=torch.from_numpy(qb), v_proto=torch.from_numpy(vb))
    tloss = float(make_loss_eval_step(tc, dtype=torch.float32, device="cpu")(
        from_jax_params(params), tproto, batch))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
