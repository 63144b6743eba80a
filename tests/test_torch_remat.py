"""Block recompute (``remat``) in the port leaves a training step as it
was, dropout included.

At dropout 0.1 on the CPU, one forward and backward of the tiny config
with remat "full" and "dots" must give the loss of the run without
remat, the same gradients within 1e-6 relative, and leave the dropout
generator in the same state. ``torch.utils.checkpoint`` alone restores
only the default generators, so without the port's rewind of the step's
explicit generator the recompute draws new dropout masks: the gradients
come out wrong and the generator ends elsewhere. The last test shows
that trap with a bare checkpoint.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.models import t5, vlt5  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState  # noqa: E402
from vqacl_tpu_torch.train.optim import tree_leaves, tree_map  # noqa: E402
from vqacl_tpu_torch.utils.config import tiny_model_config  # noqa: E402

GRAD_RTOL = 1e-6
B = 6


def _setup(fused_decoder):
    cfg = tiny_model_config(dropout_rate=0.1, fused_decoder=fused_decoder)
    params = vlt5.init_vlt5_params(0, cfg, device="cpu")
    batch = next(SyntheticVQA(
        B, seed=3, feat_dim=cfg.feat_dim, n_boxes=cfg.n_boxes,
        text_len=cfg.max_text_length, vocab_size=cfg.vocab_size,
        answer_vocab=8).batches(B, seed=4))["tensors"]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    proto = ProtoState.create(cfg.n_ques_types, cfg.n_categories,
                              cfg.d_model, device="cpu")
    return cfg, params, batch, proto


def _step(setup, remat, seed=11):
    """(loss, flat gradient, generator state after) of one forward and
    backward with dropout drawn from a generator seeded with ``seed``."""
    cfg, params, batch, proto = setup
    g = torch.Generator().manual_seed(seed)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = vlt5.forward_train(live, cfg, batch, proto, 0.5, 0.3,
                             generator=g, dtype=torch.float32, remat=remat)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(out.loss, leaves, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(p) if d is None else d).reshape(-1)
                      for p, d in zip(leaves, grads)])
    return float(out.loss.detach()), flat, g.get_state()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("remat", ["full", "dots", True])
@pytest.mark.parametrize("fused_decoder", [False, True])
def test_remat_replays_dropout(remat, fused_decoder):
    setup = _setup(fused_decoder)
    loss0, g0, state0 = _step(setup, False)
    loss1, g1, state1 = _step(setup, remat)
    assert loss1 == loss0
    assert _rel(g1, g0) <= GRAD_RTOL
    assert torch.equal(state1, state0)
    # dropout is on: another generator seed gives another loss
    assert _step(setup, False, seed=12)[0] != loss0


def test_remat_unfused_attention():
    """The plain attention blocks (``fused_attention`` off) take remat
    too, with dropout on the attention weights drawn from the generator
    inside the recomputed block."""
    cfg, params, batch, proto = _setup(False)
    cfg.fused_attention = False
    setup = (cfg, params, batch, proto)
    loss0, g0, state0 = _step(setup, False)
    for remat in ("full", "dots"):
        loss1, g1, state1 = _step(setup, remat)
        assert loss1 == loss0
        assert _rel(g1, g0) <= GRAD_RTOL
        assert torch.equal(state1, state0)


def test_dots_keeps_the_matrix_products():
    """"dots" recomputes the block but not its matrix products: the
    backward of a remat="dots" block runs as many mm/bmm as the backward
    without remat, and "full" runs the forward's again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountDots(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in t5._DOT_OPS:
                CountDots.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tiny_model_config(dropout_rate=0.1)
    p = vlt5.init_vlt5_params(0, cfg, device="cpu")["encoder"]["block_0"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    counts = {}
    for remat in (False, "dots", "full"):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        g = torch.Generator().manual_seed(1)
        y = t5.maybe_checkpoint(t5.encoder_block, remat, g)(
            live, cfg, x, None, None, g)
        CountDots.n = 0
        with CountDots():
            torch.autograd.grad(y.sum(), tree_leaves(live))
        counts[remat] = CountDots.n
    assert counts["dots"] == counts[False] < counts["full"]


def test_remat_rejects_unknown_mode():
    with pytest.raises(ValueError, match="remat"):
        t5.maybe_checkpoint(t5.encoder_block, "everything", None)


def test_remat_without_grad_runs_the_block_once():
    calls = []

    def block(x):
        calls.append(1)
        return x * 2

    with torch.no_grad():
        out = t5.maybe_checkpoint(block, "full", torch.Generator())(
            torch.ones(3))
    assert calls == [1] and torch.equal(out, torch.full((3,), 2.0))


def test_bare_checkpoint_would_not_replay_dropout(monkeypatch):
    """The trap the generator rewind avoids: a bare non-reentrant
    checkpoint keeps the loss but recomputes with fresh dropout draws,
    so the gradients and the generator's final state differ."""
    from torch.utils.checkpoint import checkpoint

    def bare(fn, remat, generator):
        if not remat:
            return fn
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)

    setup = _setup(True)
    loss0, g0, state0 = _step(setup, False)
    monkeypatch.setattr(t5, "maybe_checkpoint", bare)
    loss1, g1, state1 = _step(setup, "full")
    assert loss1 == loss0
    assert _rel(g1, g0) > 1e-3
    assert not torch.equal(state1, state0)
    np.testing.assert_equal(np.isfinite(g1.numpy()).all(), True)
