"""The classifier head (``init_classifier_head``, ``classifier_logits``,
``classifier_bce_loss``) against the JAX package's.

One set of tiny weights, one head and one batch of encoder states, made
with numpy from seeds and handed to both packages (f32 on the CPU):
logits and BCE within ``RTOL``, gradients of the loss in the head, the
decoder weights and the encoder states against ``jax.grad``, a finite
loss at large logits, and JAX's "learns" test run in the port (the port's
own Adam over the (params, head) pair, its fused encoder on the plain
K1′/K2 versions).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.models import vlt5 as jvlt5  # noqa: E402
from vqacl_tpu_torch.data.collate import collate  # noqa: E402
from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.models import vlt5  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves,  # noqa: E402
                                         tree_map, tree_unflatten)
from vqacl_tpu_torch.utils.config import TrainConfig  # noqa: E402

RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
A = 12


def _head(d, n, seed=1):
    rng = np.random.default_rng(seed)
    return {"fc1_w": (rng.normal(size=(d, 2 * d)) * d ** -0.5).astype(
                np.float32),
            "fc1_b": (0.1 * rng.normal(size=2 * d)).astype(np.float32),
            "ln": (1 + 0.1 * rng.normal(size=2 * d)).astype(np.float32),
            "fc2_w": (rng.normal(size=(2 * d, n)) * (2 * d) ** -0.5).astype(
                np.float32),
            "fc2_b": (0.1 * rng.normal(size=n)).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    jcfg, params = jax_tiny_params(0, dropout_rate=0.0)
    rng = np.random.default_rng(2)
    B, S = 4, 9
    hidden = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, 6:] = 0.0
    tgt = np.zeros((B, A), np.float32)
    for r in range(B):
        tgt[r, rng.choice(A, 2, replace=False)] = rng.choice([0.3, 1.0], 2)
    return jcfg, params, _head(jcfg.d_model, A), hidden, mask, tgt


def test_init_shapes_match_jax():
    jcfg, _ = jax_tiny_params(0)
    ref = jvlt5.init_classifier_head(jax.random.PRNGKey(0), jcfg, A)
    head = vlt5.init_classifier_head(0, torch_cfg_like(jcfg), A,
                                     device="cpu")
    assert ref.keys() == head.keys()
    for k in ref:
        assert tuple(head[k].shape) == ref[k].shape, k
        assert head[k].dtype == torch.float32
    if not torch.cuda.is_available():   # an entry point: cuda by default
        with pytest.raises(RuntimeError, match="CUDA"):
            vlt5.init_classifier_head(0, torch_cfg_like(jcfg), A)


def test_logits_and_bce_equal_jax(case):
    jcfg, params, head, hidden, mask, tgt = case
    jl = jvlt5.classifier_logits(jax.tree.map(jnp.asarray, head), jcfg,
                                 jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(hidden), jnp.asarray(mask))
    tl = vlt5.classifier_logits(from_jax_params(head), torch_cfg_like(jcfg),
                                from_jax_params(params),
                                torch.from_numpy(hidden),
                                torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (4, A)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=1e-6)
    for scale in (1.0, 300.0):      # large logits stay finite
        jb = jvlt5.classifier_bce_loss(scale * jl, jnp.asarray(tgt))
        tb = vlt5.classifier_bce_loss(scale * torch.from_numpy(
            np.array(jl)), torch.from_numpy(tgt))
        assert np.isfinite(float(tb))
        np.testing.assert_allclose(float(tb), float(jb), rtol=RTOL)


def test_gradients_equal_jax_grad(case):
    jcfg, params, head, hidden, mask, tgt = case

    def jloss(hd, dec, h):
        p = {**jax.tree.map(jnp.asarray, params), "decoder": dec}
        return jvlt5.classifier_bce_loss(
            jvlt5.classifier_logits(hd, jcfg, p, h, jnp.asarray(mask)),
            jnp.asarray(tgt))

    jl, (jgh, jgd, jgx) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, head),
        jax.tree.map(jnp.asarray, params["decoder"]), jnp.asarray(hidden))
    th = tree_map(lambda t: t.requires_grad_(), from_jax_params(head))
    tp = from_jax_params(params)
    tp["decoder"] = tree_map(lambda t: t.requires_grad_(), tp["decoder"])
    tx = torch.from_numpy(hidden).requires_grad_()
    loss = vlt5.classifier_bce_loss(
        vlt5.classifier_logits(th, torch_cfg_like(jcfg), tp, tx,
                               torch.from_numpy(mask)),
        torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    for k in head:
        np.testing.assert_allclose(th[k].grad.numpy(), np.asarray(jgh[k]),
                                   err_msg=k, **GRAD_TOL)
    jd = jax.tree_util.tree_leaves(jgd)
    td = [t.grad if t.grad is not None else torch.zeros_like(t)
          for t in tree_leaves(tp["decoder"])]
    assert len(jd) == len(td)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)


def test_classifier_head_learns():
    """JAX's ``test_classifier_head_learns`` in the port: one-hot targets
    over the synthetic answer index, Adam at lr 3e-3 over the (params,
    head) pair for 30 epochs of 3 batches; the loss falls below 0.4 of
    its first value and the eval accuracy is above chance."""
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config(dropout_rate=0.0)
    n_answers = 8
    params = vlt5.init_vlt5_params(0, cfg, device="cpu")
    head = vlt5.init_classifier_head(1, cfg, n_answers, device="cpu")
    data = SyntheticVQA(48, seed=0, feat_dim=cfg.feat_dim,
                        n_boxes=cfg.n_boxes, text_len=cfg.max_text_length,
                        vocab_size=cfg.vocab_size, answer_vocab=n_answers)
    ans_base = min(3000, cfg.vocab_size - n_answers)

    def batch_of(idx):
        b = collate([data.examples[i] for i in idx], feat_dim=cfg.feat_dim,
                    n_boxes=cfg.n_boxes,
                    max_text_length=cfg.max_text_length)["tensors"]
        tgt = np.zeros((len(idx), n_answers), np.float32)
        for r, i in enumerate(idx):
            tgt[r, data.examples[i]["target_ids"][0] - ans_base] = 1.0
        return {k: torch.from_numpy(v) for k, v in b.items()}, \
            torch.from_numpy(tgt)

    # plain Adam, as optax.adam(3e-3): no clipping, no decay, f32 moments
    tx = make_transform(dataclasses.replace(
        TrainConfig(), adam_impl="torch", adam_dtype="float32",
        weight_decay=0.0), with_clip=False)
    tree = {"params": params, "head": head}
    opt = tx.init(tree)

    def logits_of(tr, b):
        hidden, mask = vlt5.encode(tr["params"], cfg, b["input_ids"],
                                   b["vis_feats"], b["boxes"],
                                   dtype=torch.float32)
        return vlt5.classifier_logits(tr["head"], cfg, tr["params"],
                                      hidden, mask)

    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        order = rng.permutation(48)
        for s in range(0, 48, 16):
            b, t = batch_of(order[s:s + 16])
            live = tree_map(lambda p: p.detach().requires_grad_(), tree)
            loss = vlt5.classifier_bce_loss(logits_of(live, b), t)
            leaves = tree_leaves(live)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = tree_unflatten(tree, [torch.zeros_like(p) if x is None
                                      else x for p, x in zip(leaves, gs)])
            with torch.no_grad():
                upd, opt = tx.update(g, opt, tree)
                tree = tree_map(lambda p, u: p - 3e-3 * u, tree, upd)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.4 * losses[0], losses[::10]
    b, t = batch_of(np.arange(16))
    with torch.no_grad():
        logits = logits_of(tree, b)
    acc = float((logits.argmax(-1) == t.argmax(-1)).float().mean())
    assert acc > 0.4, acc
