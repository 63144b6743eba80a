"""The port's optimizer and schedule against the JAX package's optax
chain (``vqacl_tpu.train.optim.make_transform``), and the kernel build's
library naming.

Five steps of each transform on the same seeded gradients: HF and torch
Adam directions × f32 and bf16 moment storage, with clipping active and
inactive, and with ``freeze`` on; the directions and the moments agree
within 1e-6 relative (f32 arithmetic in both, in the same order).
``dynamic_lr`` matches exactly, the zero first step included.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.train import optim as joptim  # noqa: E402
from vqacl_tpu.utils.config import TrainConfig as JTrain  # noqa: E402
from vqacl_tpu_torch.train import optim as toptim  # noqa: E402
from vqacl_tpu_torch.utils.config import TrainConfig as TTrain  # noqa: E402

RTOL = 1e-6


def _tree(rng, scale=1.0):
    """A small parameter-shaped tree whose names exercise the masks:
    decayed weights and layer norms, undecayed ``*_b`` and ``rel_bias``,
    the shared embedding that ``freeze`` keeps training."""
    n = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"shared": n(12, 4),
            "encoder": {"rel_bias": n(8, 2), "final_ln": n(4),
                        "block_0": {"attn": {"wq": n(4, 6)}, "ln1": n(4)}},
            "visual_embedding": {"feat_w": n(5, 4), "feat_b": n(4)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32))}


def test_config_defaults_match_jax():
    j, t = JTrain(), TTrain()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("impl", ["hf", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["clip_active", "clip_inactive", "freeze"])
def test_transform_five_steps_match_optax(impl, dtype, case):
    rng = np.random.default_rng(7)
    kw = dict(adam_impl=impl, adam_dtype=dtype, weight_decay=0.01,
              clip_grad_norm=1.0 if case == "clip_active" else 1e6,
              freeze=case == "freeze")
    jtx = joptim.make_transform(dataclasses.replace(JTrain(), **kw))
    ttx = toptim.make_transform(dataclasses.replace(TTrain(), **kw))
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = toptim.tree_map(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        # grads with a global norm well above 1 (clipping triggers when
        # the limit is 1) and entries near ε, where Adam is most sensitive
        g = _tree(rng, scale=0.5 if step % 2 else 1e-3)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(toptim.tree_map(torch.from_numpy, g), ts, tp)
        fj, ft = _flat(ju), _flat(tu)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], rtol=RTOL, atol=1e-9,
                                       err_msg=f"step {step} {k}")
        adam = js[1]
        for name, jm, tm in (("mu", adam.mu, ts.mu), ("nu", adam.nu, ts.nu)):
            a, b = _flat(jm), _flat(tm)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-12,
                                           err_msg=f"step {step} {name}{k}")
        assert int(ts.count) == int(adam.count) == step + 1
        assert toptim.tree_leaves(ts.mu)[0].dtype == getattr(torch, dtype)
    if case == "freeze":
        assert all(not v.any() for k, v in _flat(tu).items()
                   if not k.startswith("/shared"))


def test_clip_is_optax_rule_not_torch():
    g = {"a": torch.tensor([3.0, 4.0])}                  # ‖g‖ = 5
    np.testing.assert_array_equal(
        toptim.clip_by_global_norm(g, 5.0)["a"].numpy(), [3.0, 4.0])
    np.testing.assert_allclose(
        toptim.clip_by_global_norm(g, 1.0)["a"].numpy(), [0.6, 0.8],
        rtol=1e-7)
    assert float(toptim.global_norm(g)) == 5.0


def test_masks_match_jax():
    params = _tree(np.random.default_rng(0))
    for jf, tf in ((joptim.decay_mask, toptim.decay_mask),
                   (joptim.freeze_mask, toptim.freeze_mask)):
        jm = jax.tree_util.tree_flatten_with_path(jf(params))[0]
        jm = {jax.tree_util.keystr(p): v for p, v in jm}
        tm = {"".join(f"['{k}']" for k in path.split("/")[1:]): v
              for path, v in _flat_bools(tf(params)).items()}
        assert tm == jm


def _flat_bools(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_bools(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("kind", ["constant_warmup", "linear_warmup"])
def test_dynamic_lr_exact(kind):
    for warmup, total in ((0.0, 10.0), (4.0, 40.0), (7.0, 7.0)):
        for step in range(0, 45, 3):
            j = joptim.dynamic_lr(jnp.asarray(float(step)),
                                  jnp.asarray([warmup, total]), 1e-4, kind)
            t = toptim.dynamic_lr(torch.tensor(float(step)),
                                  torch.tensor([warmup, total]), 1e-4, kind)
            assert t.dtype == torch.float32
            assert float(t) == float(j), (warmup, total, step)
    sched_j = joptim.make_schedule(1e-4, 40, 0.1, kind)
    sched_t = toptim.make_schedule(1e-4, 40, 0.1, kind)
    assert float(sched_t(0)) == 0.0                    # HF: first step is 0
    for step in (0, 1, 3, 4, 20, 39):
        assert float(sched_t(step)) == float(sched_j(step))


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    """An edited shared header renames (so rebuilds) every kernel
    library; nothing is compiled to find that out."""
    from vqacl_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    before = {n: _build._lib_path(n) for n in _build.SIGNATURES}
    header = src / "philox.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SIGNATURES}
    for n in _build.SIGNATURES:
        assert before[n] != after[n], n
        assert os.path.dirname(after[n]) == _build.BUILD_DIR
    (src / "fused_attention_bwd.cu").write_bytes(b"// changed")
    assert _build._lib_path("fused_attention_bwd") != after[
        "fused_attention_bwd"]
    assert _build._lib_path("fused_attention_fwd") == after[
        "fused_attention_fwd"]
