"""K3's mesh path: the dropout streams of a data-parallel rank.

JAX's shard_map path shifts each shard's seed by ``axis_index·B_shard·H``
(``vqacl_tpu/ops/fused_attention.py:490-495``) so that shard s draws the
streams of a one-device call's rows. The port keeps the seed and shifts
the Philox counter instead: K1′, K2 and ``philox_keep_mask`` take a row
offset ``bh0`` added to ``b·H + h``. Here, on the CPU (the kernels'
plain versions, which the card's kernels equal bit for bit in
``chip_smoke.py``):

- ``philox_keep_mask(bh0 = s·B·H)`` is rows s·B … of the one-process
  mask, bit for bit;
- ``_FusedAttention`` (and the packed variant) over two shards with
  their ``bh0`` at dropout 0.1 gives the one-process call's outputs and
  gradients, the bias cotangent summed over the shards;
- at dropout 0 the two shards equal JAX's shard_map'd
  ``fused_encoder_attention`` on a dp = 2 mesh in interpret mode;
- the fused encoder stack run under ``data_parallel`` on each rank's rows
  (global-shape dropout draws, the kernels' row offset) gives the
  one-process stack's rows and leaves the generator where it leaves it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402
from vqacl_tpu_torch.parallel.mesh import MeshContext, data_parallel  # noqa: E402

RATE = 0.1


@pytest.mark.parametrize("B,H,Tq,Sk", [(4, 2, 7, 9), (8, 3, 5, 12),
                                       (6, 12, 10, 58)])
def test_keep_mask_rows_with_bh0(B, H, Tq, Sk):
    seed = torch.tensor([123457], dtype=torch.int32)
    whole = fa.philox_keep_mask(seed, B, H, Tq, Sk, RATE)
    half = B // 2
    for s in range(2):
        part = fa.philox_keep_mask(seed, half, H, Tq, Sk, RATE,
                                   bh0=s * half * H)
        assert torch.equal(part, whole[s * half:(s + 1) * half])
    assert not torch.equal(whole[:half], whole[half:])


def _inputs(B=8, S=11, H=2, dk=8, L=6, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H * dk))
                                .astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(H, L, L)).astype(np.float32))
    mask = np.ones((B, S), np.float32)
    mask[3, 8:] = 0.0
    mask[6, 5:] = 0.0
    do = torch.from_numpy(rng.normal(size=(B, S, H * dk)).astype(np.float32))
    return q, k, v, bias, torch.from_numpy(mask), do, H


def _run(q, k, v, bias, mask, do, H, rate, bh0, packed):
    """(o, dq, dk, dv, dbias) of one call, through the autograd Function."""
    seed = torch.tensor([987], dtype=torch.int32)
    bias = bias.clone().requires_grad_()
    if packed:
        x = torch.cat([q, k, v], dim=-1).requires_grad_()
        o = fa.fused_attention_packed(x, None, bias, mask, H, rate, seed,
                                      bh0=bh0)
        o.backward(do)
        W = q.shape[-1]
        g = x.grad
        return o.detach(), g[..., :W], g[..., W:2 * W], g[..., 2 * W:], \
            bias.grad
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.fused_attention(q, k, v, bias, mask, H, dropout_rate=rate,
                           seed=seed, bh0=bh0)
    o.backward(do)
    return o.detach(), q.grad, k.grad, v.grad, bias.grad


@pytest.mark.parametrize("packed", [False, True])
def test_two_shards_equal_the_one_process_call(packed):
    q, k, v, bias, mask, do, H = _inputs()
    whole = _run(q, k, v, bias, mask, do, H, RATE, 0, packed)
    half = q.shape[0] // 2
    parts = [_run(*(t[s * half:(s + 1) * half] for t in (q, k, v)), bias,
                  mask[s * half:(s + 1) * half],
                  do[s * half:(s + 1) * half], H, RATE, s * half * H, packed)
             for s in range(2)]
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = torch.cat([p[i] for p in parts])
        assert torch.equal(got, whole[i]), name
    np.testing.assert_allclose((parts[0][4] + parts[1][4]).numpy(),
                               whole[4].numpy(), rtol=1e-6, atol=1e-7)
    # without the offset the second shard would repeat the first's masks
    wrong = _run(*(t[half:] for t in (q, k, v)), bias, mask[half:],
                 do[half:], H, RATE, 0, packed)
    assert not torch.equal(wrong[0], whole[0][half:])


def test_two_shards_equal_jax_shard_map_at_rate_0():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from vqacl_tpu.ops.fused_attention import fused_encoder_attention

    q, k, v, bias, mask, do, H = _inputs()
    B, S, HD = q.shape
    dk = HD // H
    half = B // 2
    parts = [_run(*(t[s * half:(s + 1) * half] for t in (q, k, v)), bias,
                  mask[s * half:(s + 1) * half],
                  do[s * half:(s + 1) * half], H, 0.0, s * half * H, False)
             for s in range(2)]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    shard = NamedSharding(mesh, P("dp"))
    j = lambda t: jax.device_put(  # noqa: E731
        jnp.asarray(t.numpy().reshape(B, S, H, dk)), shard)
    jdo = jnp.asarray(do.numpy())
    jmask = jax.device_put(jnp.asarray(mask.numpy()), shard)

    def loss(q, k, v, b):
        o = fused_encoder_attention(q, k, v, b, jmask, interpret=True,
                                    mesh=mesh)
        return jnp.sum(o * jdo), o

    (jloss, jo), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        j(q), j(k), j(v), jnp.asarray(bias.numpy()))
    # tests/test_fused_attention.py's terms: the loss 2e-5 relative, the
    # arrays 2e-4
    o = torch.cat([p[0] for p in parts])
    np.testing.assert_allclose(float((o * do).sum()), float(jloss),
                               rtol=2e-5)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **tol)
    for i in range(3):
        np.testing.assert_allclose(
            torch.cat([p[i + 1] for p in parts]).numpy(),
            np.asarray(jg[i]).reshape(B, S, HD), **tol)
    np.testing.assert_allclose((parts[0][4] + parts[1][4]).numpy(),
                               np.asarray(jg[3]), **tol)


def test_encoder_stack_under_data_parallel_draws_the_one_process_rows():
    from vqacl_tpu_torch.models import t5
    from vqacl_tpu_torch.models.vlt5 import init_vlt5_params
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config(dropout_rate=RATE)
    cfg.fused_attention = True
    p = init_vlt5_params(0, cfg, device="cpu")["encoder"]
    rng = np.random.default_rng(1)
    B, S, L = 8, 9, cfg.max_text_length
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                         .astype(np.float32))
    mask = torch.ones(B, S)
    mask[2, 4:] = 0.0
    bias = t5.compute_position_bias(
        p["rel_bias"], L, L, bidirectional=True,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)[0].contiguous()

    def stack(rows, ctx):
        gen = torch.Generator().manual_seed(5)
        with data_parallel(ctx):
            # a differentiable input: the training kernels (K1′)
            out = t5.encoder_stack(p, cfg, x[rows].requires_grad_(), None,
                                   fused={"pos_bias": bias,
                                          "mask": mask[rows]},
                                   generator=gen)
        return out.detach(), gen.get_state()

    whole, gstate = stack(slice(0, B), None)
    for r in range(2):
        ctx = MeshContext(dp=2, rank=r, backend="gloo")   # no collective
        rows = slice(r * B // 2, (r + 1) * B // 2)
        part, pstate = stack(rows, ctx)
        np.testing.assert_allclose(part.numpy(), whole[rows].numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(pstate, gstate)
    # the one-process draw is not the same for each half of the batch
    alone, _ = stack(slice(B // 2, B), None)
    assert not np.allclose(alone.numpy(), whole[B // 2:].numpy(), atol=1e-3)
