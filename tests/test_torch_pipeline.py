"""The port's GPipe stacks (``parallel/pipeline.py``) and its train step
under pipeline and tensor parallelism, on gloo ranks of the CPU
(``tests/torch_dp.py::spawn``), against JAX.

- ``encoder_stack_pp``/``decoder_stack_pp`` at pp = 2 (two ranks) and
  tp = 2 × pp = 2 (four ranks; the rank's Megatron slices, the tp
  blocks), unfused and fused (K1′/K2's plain versions on the CPU), at
  dropout 0 on 4 microbatches of 2 rows (the decoder on 2 of 4): every
  rank's output equals JAX's sequential ``t5.encoder_stack``/
  ``decoder_stack`` on the full parameters (JAX's own slow tests tie
  those to its pp stacks) within ``RTOL``/``ATOL``; each rank
  differentiates ``1/pp`` of a fixed-cotangent loss and its gradients,
  summed over the pp group (the train step's rule), equal JAX's (the
  rank's tp slice of a sharded leaf) within the same bounds.
- ``make_train_step`` at dp = 2 × pp = 2 (replicated, unfused), at tp =
  2 × pp = 2 (the "tp" layout, fused) and at tp = 2 with a replicated
  state (its slices cut per step, the sliced gradients gathered over
  tp), 3 steps of 8 rows at dropout 0:
  the metrics and parameters equal the one-process port's within
  ``tests/test_torch_dp_step.py``'s bounds, the loss JAX's one-device
  ``make_train_step``'s within 1e-5 relative and the grad norm within
  1e-3, as ``tests/test_pipeline.py`` holds JAX's own pp step.
- The stacks refuse, with JAX's assertion tuples, a batch ``pp_micro``
  does not divide, layers pp does not divide and heads tp does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_dp import flat_numpy, run_steps, spawn, w_steps  # noqa: E402
from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402

# f32; the pipelined stacks add the same terms as the sequential ones,
# the tp blocks' partial sums over tp in another order
RTOL = 1e-5
ATOL = 2e-5
B, S, T = 8, 10, 5
LAYERS = dict(num_layers=4, num_decoder_layers=4)
MICRO = {"encoder": 4, "decoder": 2}
MESHES = {"pp2": {"pp": 2}, "tp2pp2": {"tp": 2, "pp": 2}}


def _inputs(cfg):
    rng = np.random.default_rng(5)
    D = cfg.d_model
    mask = np.ones((B, S), np.float32)
    mask[3, 7:] = 0.0
    mask[6, 4:] = 0.0
    return {"x": rng.normal(size=(B, S, D)).astype(np.float32),
            "y": rng.normal(size=(B, T, D)).astype(np.float32),
            "enc": rng.normal(size=(B, S, D)).astype(np.float32),
            "g_enc": rng.normal(size=(B, S, D)).astype(np.float32),
            "g_dec": rng.normal(size=(B, T, D)).astype(np.float32),
            "mask": mask}


def w_stacks(ctx, params, inputs):
    """On each rank: the pipelined stacks' outputs and pp-summed
    gradients, unfused and fused."""
    import torch

    from vqacl_tpu_torch.models import t5
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.parallel.mesh import data_parallel
    from vqacl_tpu_torch.parallel.pipeline import (decoder_stack_pp,
                                                   encoder_stack_pp)
    from vqacl_tpu_torch.parallel.sharding import TpLayout
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config(**LAYERS)
    full = from_jax_params(params)
    mine = TpLayout(ctx, full).shard(full)
    x, y, enc, mask = (torch.from_numpy(inputs[k])
                       for k in ("x", "y", "enc", "mask"))
    L = cfg.max_text_length
    out = {}
    for fused in (False, True):
        cfg.fused_attention = fused
        live = {s: {k: v.detach().requires_grad_()
                    for k, v in _flat(mine[s]).items()}
                for s in ("encoder", "decoder")}
        ep, dp = _unflat(live["encoder"]), _unflat(live["decoder"])
        with data_parallel(ctx):
            if fused:
                tb = t5.compute_position_bias(
                    ep["rel_bias"], L, L, True,
                    cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance)[0]
                xe = encoder_stack_pp(ep, cfg, x, None, ctx, MICRO["encoder"],
                                      fused={"pos_bias": tb, "mask": mask})
            else:
                pb = t5.compute_position_bias(
                    ep["rel_bias"], S, S, True,
                    cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance)
                xe = encoder_stack_pp(
                    ep, cfg, x, pb, ctx, MICRO["encoder"],
                    mask_add=t5.attention_scores_bias(
                        mask[:, None, None, :], None))
            xd = decoder_stack_pp(dp, cfg, y, enc, mask, ctx,
                                  MICRO["decoder"], fused=fused)
            # two chains of hand-offs here (the decoder does not read the
            # encoder's output): one backward each, in one order on every
            # rank
            for out_, g in ((xd, "g_dec"), (xe, "g_enc")):
                ((out_ * torch.from_numpy(inputs[g])).sum()
                 / ctx.pp).backward()
        grads = {}
        for s in ("encoder", "decoder"):
            for k, v in live[s].items():
                g = torch.zeros_like(v) if v.grad is None else v.grad
                grads[f"{s}/{k}"] = ctx.all_reduce(g.clone(), "pp").numpy()
        out["fused" if fused else "unfused"] = {
            "enc": xe.detach().numpy(), "dec": xd.detach().numpy(),
            "grads": grads}
    out["stats"] = dict(ctx.stats)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    jm, params = jax_tiny_params(0, **LAYERS)
    inputs = _inputs(jm)
    runs = {name: spawn(w_stacks, int(np.prod(list(mesh.values()))),
                        tmp_path_factory.mktemp(f"pp_{name}"), mesh=mesh,
                        params=params, inputs=inputs)
            for name, mesh in MESHES.items()}
    return jm, params, inputs, runs


def _jax_stacks(jm, params, inputs, text_only):
    """JAX's sequential stacks on the full parameters → (encoder out,
    decoder out, {path: grad})."""
    from vqacl_tpu.models import t5 as J

    x, y, enc, mask = (jnp.asarray(inputs[k]) for k in ("x", "y", "enc",
                                                         "mask"))
    L = jm.max_text_length

    def loss_fn(ep, dp):
        kw = dict(num_buckets=jm.relative_attention_num_buckets,
                  max_distance=jm.relative_attention_max_distance)
        if text_only:    # the fused encoder's bias: the text block only
            tb = J.compute_position_bias(ep["rel_bias"], L, L,
                                         bidirectional=True, **kw)
            pb = jnp.zeros((1, jm.num_heads, S, S), jnp.float32)
            pb = pb.at[:, :, :L, :L].set(tb)
        else:
            pb = J.compute_position_bias(ep["rel_bias"], S, S,
                                         bidirectional=True, **kw)
        xe = J.encoder_stack(ep, jm, x, pb, mask_add=J.attention_scores_bias(
            mask[:, None, None, :], None))
        xd = J.decoder_stack(dp, jm, y, enc, mask)
        loss = (xe * inputs["g_enc"]).sum() + (xd * inputs["g_dec"]).sum()
        return loss, (xe, xd)

    ep = jax.tree.map(jnp.asarray, params["encoder"])
    dp = jax.tree.map(jnp.asarray, params["decoder"])
    (_, (xe, xd)), (ge, gd) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(ep, dp)
    grads = {f"encoder{k}": v for k, v in
             flat_numpy(jax.device_get(ge)).items()}
    grads.update({f"decoder{k}": v for k, v in
                  flat_numpy(jax.device_get(gd)).items()})
    return np.asarray(xe), np.asarray(xd), grads


def _tp_slice(path, full, t, tp):
    """tp rank t's slice of a full leaf, by JAX's RULES."""
    from vqacl_tpu.parallel.sharding import param_sharding_rules

    spec = tuple(param_sharding_rules(path))
    if tp == 1 or "tp" not in spec:
        return full
    d = spec.index("tp")
    n = full.shape[d] // tp
    return np.take(full, np.arange(t * n, (t + 1) * n), axis=d)


@pytest.fixture(scope="module")
def jax_stacks(stacks):
    jm, params, inputs, _ = stacks
    return {v: _jax_stacks(jm, params, inputs, v == "fused")
            for v in ("unfused", "fused")}


@pytest.mark.parametrize("variant", ["unfused", "fused"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_pp_stacks_match_jax_sequential(stacks, jax_stacks, mesh, variant):
    jm, params, inputs, runs = stacks
    want_e, want_d, want_g = jax_stacks[variant]
    tp, pp = MESHES[mesh].get("tp", 1), MESHES[mesh]["pp"]
    for rank, r in enumerate(runs[mesh]):
        got = r[variant]
        np.testing.assert_allclose(got["enc"], want_e, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["dec"], want_d, rtol=RTOL, atol=ATOL)
        t = (rank // pp) % tp
        assert set(got["grads"]) == set(want_g)
        for k, v in got["grads"].items():
            np.testing.assert_allclose(
                v, _tp_slice(k, want_g[k], t, tp), rtol=RTOL, atol=ATOL,
                err_msg=f"{mesh} rank {rank} {k}")
    # the hand-offs and collects went over the pp group only, and tp's
    # partial sums over the tp group
    stats = runs[mesh][0]["stats"]
    assert stats["all_reduce_pp_calls"] > 0
    assert (stats.get("all_reduce_tp_calls", 0) > 0) == (tp > 1)
    assert stats["all_reduce_calls"] == stats["all_reduce_pp_calls"] \
        + stats.get("all_reduce_tp_calls", 0)


# name → (mesh, param_layout "tp", fused); "tp2_replicated" keeps the
# whole tree in the state and cuts the rank's slices for each forward
STEP_CASES = {"dp2pp2": ({"dp": 2, "pp": 2}, False, False),
              "tp2pp2": ({"tp": 2, "pp": 2}, True, True),
              "tp2_replicated": ({"tp": 2}, False, True)}
STEPS = 3
METRICS = ("loss", "grad_norm", "lr", "loss_memory_Q", "loss_memory_V",
           "retrieval_acc_Q", "retrieval_acc_V")


def _step_configs(fused):
    import dataclasses

    from vqacl_tpu.utils.config import Config as JConfig
    from vqacl_tpu_torch.utils.config import Config as TConfig

    jm, params = jax_tiny_params(0, dropout_rate=0.0, **LAYERS)
    jm.fused_attention = False
    jc = JConfig()
    jc.model = jm
    jc.train.lr = 1e-3
    tc = TConfig()
    tc.model = torch_cfg_like(jm)
    tc.model.fused_attention = fused
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    tc.mesh.pp_micro = 2
    return jc, tc, params


def _step_batches(m):
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA

    return [b["tensors"] for b in SyntheticVQA(
        B * STEPS, seed=3, feat_dim=m.feat_dim, n_boxes=m.n_boxes,
        text_len=m.max_text_length, vocab_size=m.vocab_size,
        answer_vocab=8).batches(B, seed=4)]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    out = {}
    for name, (mesh, tp_layout, fused) in STEP_CASES.items():
        _, tc, params = _step_configs(fused)
        cases = {name: (tc, params, _step_batches(tc.model), "train",
                        False, tp_layout)}
        out[name] = spawn(w_steps, int(np.prod(list(mesh.values()))),
                          tmp_path_factory.mktemp(name), mesh=mesh,
                          cases=cases)
    return out


def _jax_one_device(jc, params, batches):
    from vqacl_tpu.models.prototype import ProtoState as JProto
    from vqacl_tpu.train.optim import make_transform as jax_transform
    from vqacl_tpu.train.state import TrainState as JState
    from vqacl_tpu.train.step import make_train_step as jax_train_step

    m = jc.model
    tx = jax_transform(jc.train)
    state = JState.create(jax.tree.map(jnp.asarray, params), tx,
                          JProto.create(m.n_ques_types, m.n_categories,
                                        m.d_model),
                          jax.random.PRNGKey(1), warmup_iters=1.0,
                          t_total=40.0)
    step = jax_train_step(jc, tx, dtype=jnp.float32, donate=False)
    metrics = []
    for b in batches:
        state, mt = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in mt.items()})
    return metrics


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_pp_train_step_equals_one_process_and_jax(step_runs, name):
    jc, tc, params = _step_configs(STEP_CASES[name][2])
    batches = _step_batches(tc.model)
    one = run_steps(tc, params, batches, "train")
    ranks = [r[name] for r in step_runs[name]]
    # every rank holds the same state, bit for bit
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k in ranks[0]["params"]:
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k], err_msg=k)
    r0 = ranks[0]
    for s, (got, want) in enumerate(zip(r0["metrics"], one["metrics"])):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=f"step {s} {k}")
    for k, v in one["params"].items():
        np.testing.assert_allclose(r0["params"][k], v, rtol=1e-6, atol=1e-5,
                                   err_msg=k)
    assert any(not np.array_equal(r0["params"][k], v) for k, v in
               flat_numpy(params).items())
    jm = _jax_one_device(jc, params, batches)
    for s, (got, want) in enumerate(zip(r0["metrics"], jm)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=f"step {s}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-3, err_msg=f"step {s}")


@pytest.mark.parametrize("what", ["micro", "layers", "heads"])
def test_pp_stacks_refuse_what_does_not_divide(what):
    from vqacl_tpu_torch.parallel.mesh import MeshContext
    from vqacl_tpu_torch.parallel.pipeline import (decoder_stack_pp,
                                                   encoder_stack_pp)
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config(num_layers=3 if what == "layers" else 4,
                            num_decoder_layers=3 if what == "layers" else 4)
    # the checks come before any collective: a context without a group
    mesh = MeshContext(tp=3 if what == "heads" else 1, pp=2)
    Bx = 6 if what == "micro" else 8
    want = {"micro": (Bx, 4), "layers": (3, 2), "heads": (4, 3)}[what]
    p = {"block_0": {"attn": {"wq": torch.zeros(cfg.d_model, 64)}}}
    x = torch.zeros(Bx, S, cfg.d_model)
    with pytest.raises(ValueError, match=f"^{re_tuple(want)}"):
        encoder_stack_pp(p, cfg, x, None, mesh, 4)
    with pytest.raises(ValueError, match=f"^{re_tuple(want)}"):
        decoder_stack_pp(p, cfg, x[:, :T], x, None, mesh, 4)


def re_tuple(t):
    import re

    return re.escape(str(t))


@pytest.mark.parametrize("tp_axis", [None, "tp"])
def test_stack_blocks_and_specs_equal_jax(tp_axis):
    from vqacl_tpu.parallel import pipeline as JP
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.parallel.pipeline import (stack_blocks,
                                                   stacked_block_specs)

    _, params = jax_tiny_params(0, **LAYERS)
    for stack in ("encoder", "decoder"):
        jst = JP.stack_blocks(jax.tree.map(jnp.asarray, params[stack]), 4)
        tst = stack_blocks(from_jax_params(params)[stack], 4)
        got, want = flat_numpy(tst), flat_numpy(jax.device_get(jst))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        jspec = jax.tree_util.tree_map(
            tuple, JP.stacked_block_specs(jst, "pp", tp_axis),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tspec = stacked_block_specs(tst, "pp", tp_axis)
        assert _flat(tspec) == {k: tuple(v) for k, v in _flat(jspec).items()}
