"""The port's mesh arithmetic, batch sharding and FSDP rules
(``parallel/mesh.py``, ``parallel/sharding.py``) against the JAX
package's on the 8 virtual CPU devices of ``tests/conftest.py``.

- ``mesh_shape`` (``make_mesh``'s arithmetic over the world size) gives
  JAX's ``make_mesh`` axis sizes over 8 devices, and raises with its
  assertion messages;
- ``fsdp_rules`` gives, for every leaf of the tiny and of the t5-base
  parameter trees, the spec of JAX's ``fsdp_rules`` on a dp = 2 mesh
  (the largest dimension dp divides that the tp rules leave free, for
  leaves of at least 2^14 elements), and ``FsdpLayout.shard`` gives each
  rank the block JAX's ``shard_params_fsdp`` puts on that device;
- ``shard_batch`` gives each rank the rows JAX puts on that device:
  with ``grad_accum`` 1 the batch sharded over dp, with 2 each
  microbatch of JAX's split (``train/step.py:82-86``) sharded over dp.
- ``RULES``/``param_sharding_rules``/``apply_rules`` are JAX's as data;
  the tp layout (``shard_params``) raises (not ported yet).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from torch_parity import jax_tiny_params  # noqa: E402
from vqacl_tpu.parallel import mesh as JM  # noqa: E402
from vqacl_tpu.parallel import sharding as JS  # noqa: E402
from vqacl_tpu_torch.parallel import sharding as TS  # noqa: E402
from vqacl_tpu_torch.parallel.mesh import (MeshContext, batch_rows,  # noqa: E402
                                           mesh_shape, shard_batch)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device virtual mesh")

SHAPES = [(-1, 1, 1), (8, 1, 1), (4, 2, 1), (2, 4, 1), (-1, 2, 1),
          (2, 2, 2), (-1, 2, 2), (1, 1, 8), (-1, 3, 1), (3, 1, 1),
          (4, 1, 1), (2, 2, 1), (-1, 1, 3)]


@pytest.mark.parametrize("dp,tp,pp", SHAPES)
def test_mesh_arithmetic_and_errors_follow_jax(dp, tp, pp):
    try:
        ctx = JM.make_mesh(dp=dp, tp=tp, pp=pp)
        want = (ctx.dp, ctx.tp, ctx.pp)
    except AssertionError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(8, dp, tp, pp)
        assert str(got.value) == str(e)
        return
    assert mesh_shape(8, dp, tp, pp) == want


def _jax_mesh(dp=2):
    return Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1),
                axis_names=("dp", "tp"))


def _t5_base_shapes():
    """The t5-base parameter tree's shapes (JAX's init, traced only)."""
    from vqacl_tpu.models.vlt5 import init_vlt5_params
    from vqacl_tpu.utils.config import ModelConfig

    cfg = ModelConfig()
    tree = jax.eval_shape(lambda key: init_vlt5_params(key, cfg),
                          jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: tuple(s.shape), tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("model", ["tiny", "t5-base"])
def test_fsdp_rules_follow_jax(model):
    if model == "tiny":
        # vocab 32200, as the trainer tests run it: the shared embedding
        # is the one leaf past 2^14 elements
        shapes = jax.tree.map(np.shape,
                              jax_tiny_params(0, vocab_size=32200)[1])
    else:
        shapes = _t5_base_shapes()
    is_leaf = lambda s: isinstance(s, tuple)  # noqa: E731
    # no memory: numpy's empty arrays for JAX, meta tensors for the port
    jtree = jax.tree.map(lambda s: np.empty(s, np.float32), shapes,
                         is_leaf=is_leaf)
    ttree = jax.tree.map(lambda s: torch.empty(s, device="meta"), shapes,
                         is_leaf=is_leaf)
    want = _paths(jax.tree.map(lambda ns: tuple(ns.spec),
                               JS.fsdp_rules(_jax_mesh(), jtree),
                               is_leaf=lambda x: isinstance(
                                   x, NamedSharding)))
    got = _paths(TS.fsdp_rules(MeshContext(dp=2), ttree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    sharded = [k for k, s in got.items() if "dp" in s]
    assert sharded
    if model == "t5-base":
        # the tp marks count at tp = 1: wq [768, 768] and mlp/wi
        # [768, 3072] shard dimension 0, not the larger free one
        assert got["encoder/block_0/attn/wq"] == ("dp", "tp")
        assert got["encoder/block_0/mlp/wi"] == ("dp", "tp")
        assert got["encoder/block_0/attn/wo"] == ("tp", "dp")
        assert got["shared"] == ("dp", None)
    # dp = 1 shards nothing
    assert "dp" not in str(TS.fsdp_rules(MeshContext(dp=1), ttree))


@pytest.mark.parametrize("rank", [0, 1])
def test_fsdp_shards_are_jax_device_shards(rank):
    _, params = jax_tiny_params(0, vocab_size=32200)
    tparams = jax.tree.map(torch.from_numpy, params)
    layout = TS.FsdpLayout(MeshContext(dp=2, rank=rank), tparams)
    shards = _paths(layout.shard(tparams))
    placed = JS.shard_params_fsdp(_jax_mesh(), params)
    dev = jax.devices()[rank]
    for k, x in _paths(placed).items():
        want = next(s.data for s in x.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(shards[k].numpy(), np.asarray(want),
                                      err_msg=k)
    # the views of a full tree are the same slices
    for k, x in _paths(layout.slice(tparams)).items():
        np.testing.assert_array_equal(x.numpy(), shards[k].numpy())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_rows_are_jax_device_rows(accum, rank):
    B = 8
    rng = np.random.default_rng(accum)
    batch = {"input_ids": rng.integers(0, 99, (B, 5)).astype(np.int32),
             "vis_feats": rng.normal(size=(B, 3, 4)).astype(np.float32),
             "scores": rng.uniform(size=B).astype(np.float32),
             "note": "passes through"}
    got = shard_batch(MeshContext(dp=2, rank=rank), batch, accum)
    mesh = _jax_mesh()
    dev = jax.devices()[rank]
    for k in ("input_ids", "vis_feats", "scores"):
        x = batch[k]
        # JAX: the batch split into accum microbatches, each over dp
        split = x.reshape((accum, B // accum) + x.shape[1:])
        placed = jax.device_put(split, NamedSharding(mesh, P(None, "dp")))
        want = next(s.data for s in placed.addressable_shards
                    if s.device == dev)
        want = np.asarray(want).reshape((-1,) + x.shape[1:])
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    assert got["note"] == "passes through"
    np.testing.assert_array_equal(
        batch_rows(B, 2, rank, accum),
        np.concatenate([np.arange(i * B // accum + rank * B // accum // 2,
                                  i * B // accum + (rank + 1) * B // accum
                                  // 2) for i in range(accum)]))
    with pytest.raises(ValueError, match="divisible"):
        batch_rows(6, 2, rank, 2)


def test_rules_are_jax_rules_and_tp_is_refused():
    assert [(p, s) for p, s in TS.RULES] == \
        [(p, tuple(s)) for p, s in JS.RULES]
    for path in ("encoder/block_3/attn/wq", "decoder/block_0/cross_attn/wo",
                 "decoder/block_1/mlp/wi", "shared", "encoder/rel_bias",
                 "visual_embedding/feat_w"):
        assert TS.param_sharding_rules(path) == \
            tuple(JS.param_sharding_rules(path))
    _, params = jax_tiny_params(0)
    specs = _paths(TS.apply_rules(MeshContext(), params))
    assert specs["encoder/block_0/attn/wq"] == (None, "tp")
    # the tp layout is in force: at tp = 1 it keeps every leaf whole; a
    # tp the heads (4 in the tiny config) do not divide still raises
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.train.optim import tree_leaves

    tparams = from_jax_params(params)
    whole = TS.shard_params(MeshContext(), tparams)
    for a, b in zip(tree_leaves(whole), tree_leaves(tparams)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        TS.shard_params(MeshContext(tp=3), tparams)
