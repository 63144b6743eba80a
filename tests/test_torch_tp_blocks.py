"""The port's Megatron tensor-parallel blocks (``models/t5.py``:
``encoder_block_tp``, ``decoder_block_tp`` and the fused blocks over the
rank's heads) and the tp layout (``parallel/sharding.py``) on two gloo
ranks of the CPU (``tests/torch_dp.py::spawn`` with ``mesh={"tp": 2}``),
against JAX.

- Each rank runs its slices (``TpLayout.shard``: 2 of the tiny config's
  4 heads, 32 of its 64 MLP columns) of one encoder and one decoder block
  at dropout 0, unfused and through the fused blocks (K1′/K2's plain
  versions on the CPU, the rank's Philox heads), and differentiates a
  fixed cotangent of the output; the output and each parameter's
  gradient (the rank's slice of it, the replicated leaves whole) must
  equal JAX's ``t5.encoder_block``/``decoder_block`` on the full
  parameters within ``RTOL`` (f32; the partial sums over tp add in
  another order). The relative-bias table's gradient is the whole
  table's on both ranks (``copy_to_tp`` of the bias before its heads are
  cut).
- ``TpLayout``: ``shard`` then ``gather`` gives the full tree bit for
  bit; ``slice`` views the same values; ``global_sq_norm`` of the slices
  is the full tree's; a tp the heads do not divide raises.
- A tp = 2 train step at dropout 0.1 (tiny config, 4 + 4 layers, fused
  and unfused) draws exactly the one-process step's dropout masks, each
  rank its heads and MLP columns of them (the masks recorded at every
  ``t5.dropout``), and follows its losses and parameters up to reduction
  order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_dp import flat_numpy, spawn  # noqa: E402
from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402

RTOL = 1e-5
ATOL = 2e-5
B, S, T = 3, 7, 5
LAYERS = dict(num_layers=4, num_decoder_layers=4)


def _inputs(cfg):
    rng = np.random.default_rng(11)
    D = cfg.d_model
    return {"x": rng.normal(size=(B, S, D)).astype(np.float32),
            "y": rng.normal(size=(B, T, D)).astype(np.float32),
            "enc": rng.normal(size=(B, S, D)).astype(np.float32),
            "g_enc": rng.normal(size=(B, S, D)).astype(np.float32),
            "g_dec": rng.normal(size=(B, T, D)).astype(np.float32),
            "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def w_blocks(ctx, params, inputs):
    """On each tp rank: encoder and decoder block outputs and gradients,
    unfused and fused, and the tp layout's round trips."""
    import torch

    from vqacl_tpu_torch.models import t5
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.parallel.mesh import data_parallel
    from vqacl_tpu_torch.parallel.sharding import TpLayout
    from vqacl_tpu_torch.train.optim import global_norm, tree_leaves
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config(**LAYERS)
    full = from_jax_params(params)
    tpl = TpLayout(ctx, full)
    mine = tpl.shard(full)
    x, y, enc, mask = (torch.from_numpy(inputs[k])
                       for k in ("x", "y", "enc", "mask"))
    out = {"round_trip": all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tpl.gather(mine)), tree_leaves(full))),
        "slice_equal": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tpl.slice(full)), tree_leaves(mine))),
        "sq_norm": float(tpl.global_sq_norm(mine)),
        "full_sq_norm": float(global_norm(full) ** 2),
        "slice_shape": tuple(mine["encoder"]["block_0"]["mlp"]["wi"].shape)}
    try:
        TpLayout(ctx, {"a": {"attn": {"wq": torch.zeros(4, 3)}}})
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    L = cfg.max_text_length
    for fused in (False, True):
        cfg.fused_attention = fused
        live = {k: {kk: vv.detach().requires_grad_() for kk, vv in
                    _flat(mine[k]).items()} for k in ("encoder", "decoder")}
        enc_p = _unflat(live["encoder"])
        dec_p = _unflat(live["decoder"])
        with data_parallel(ctx):
            if fused:
                tb = t5.compute_position_bias(
                    enc_p["rel_bias"], L, L, True,
                    cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance)[0]
                bias = t5.head_slice(tb, 0, 2).contiguous()
                xe = t5.encoder_block_fused(enc_p["block_0"], cfg, x, bias,
                                            mask)
            else:
                pb = t5.compute_position_bias(
                    enc_p["rel_bias"], S, S, True,
                    cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance)
                xe = t5.encoder_block_tp(
                    enc_p["block_0"], cfg, x, t5.head_slice(pb, 1, 2),
                    t5.attention_scores_bias(mask[:, None, None, :], None))
            pbd = t5.compute_position_bias(
                dec_p["rel_bias"], T, T, False,
                cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance)
            e = t5.copy_to_tp(enc)
            if fused:
                causal = (1.0 - t5.causal_mask(T)[0, 0]) * t5.NEG_INF
                sb = t5.head_slice(pbd[0] + causal[None], 0, 2).contiguous()
                xd = t5.decoder_block_fused(dec_p["block_0"], cfg, y, sb, e,
                                            mask)
            else:
                sb = t5.head_slice(t5.attention_scores_bias(
                    t5.causal_mask(T), pbd), 1, 2)
                xd = t5.decoder_block_tp(
                    dec_p["block_0"], cfg, y, sb, e,
                    t5.attention_scores_bias(mask[:, None, None, :], None))
            loss = (xe * torch.from_numpy(inputs["g_enc"])).sum() \
                + (xd * torch.from_numpy(inputs["g_dec"])).sum()
            loss.backward()
        key = "fused" if fused else "unfused"
        out[key] = {"enc": xe.detach().numpy(), "dec": xd.detach().numpy(),
                    "grads": {f"{s}/{k}": v.grad.numpy()
                              for s in ("encoder", "decoder")
                              for k, v in live[s].items()
                              if v.grad is not None}}
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
def blocks(tmp_path_factory):
    jm, params = jax_tiny_params(0, **LAYERS)
    inputs = _inputs(jm)
    ranks = spawn(w_blocks, 2, tmp_path_factory.mktemp("tp_blocks"),
                  mesh={"tp": 2}, params=params, inputs=inputs)
    return jm, params, inputs, ranks


def _jax_blocks(jm, params, inputs):
    """JAX's one-device blocks on the full parameters → (encoder out,
    decoder out, {path: grad})."""
    from vqacl_tpu.models import t5 as J

    x, y, enc, mask = (jnp.asarray(inputs[k]) for k in ("x", "y", "enc",
                                                         "mask"))
    S_, T_ = x.shape[1], y.shape[1]
    L = jm.max_text_length

    def f(ep, dp):
        tb = J.compute_position_bias(ep["rel_bias"], L, L, bidirectional=True,
                                     num_buckets=jm.relative_attention_num_buckets,
                                     max_distance=jm.relative_attention_max_distance)
        return tb, ep, dp

    def loss_fn(ep, dp, text_only):
        if text_only:   # the fused blocks' bias: the text block only
            tb = J.compute_position_bias(
                ep["rel_bias"], L, L, bidirectional=True,
                num_buckets=jm.relative_attention_num_buckets,
                max_distance=jm.relative_attention_max_distance)
            pb = jnp.zeros((1, jm.num_heads, S_, S_), jnp.float32)
            pb = pb.at[:, :, :L, :L].set(tb)
        else:
            pb = J.compute_position_bias(
                ep["rel_bias"], S_, S_, bidirectional=True,
                num_buckets=jm.relative_attention_num_buckets,
                max_distance=jm.relative_attention_max_distance)
        xe = J.encoder_block(ep["block_0"], jm, x, pb, True, None,
                             J.attention_scores_bias(mask[:, None, None, :],
                                                     None))
        pbd = J.compute_position_bias(
            dp["rel_bias"], T_, T_, bidirectional=False,
            num_buckets=jm.relative_attention_num_buckets,
            max_distance=jm.relative_attention_max_distance)
        sb = J.attention_scores_bias(J.causal_mask(T_), pbd)
        xd = J.decoder_block(dp["block_0"], jm, y, sb, enc,
                             J.attention_scores_bias(mask[:, None, None, :],
                                                     None), True, None)
        loss = (xe * inputs["g_enc"]).sum() + (xd * inputs["g_dec"]).sum()
        return loss, (xe, xd)

    out = {}
    for text_only in (False, True):
        ep = jax.tree.map(jnp.asarray, params["encoder"])
        dp = jax.tree.map(jnp.asarray, params["decoder"])
        (_, (xe, xd)), (ge, gd) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(ep, dp, text_only)
        grads = {f"encoder/{k}": v for k, v in
                 flat_numpy(jax.device_get(ge)).items()}
        grads.update({f"decoder/{k}": v for k, v in
                      flat_numpy(jax.device_get(gd)).items()})
        out["fused" if text_only else "unfused"] = (
            np.asarray(xe), np.asarray(xd),
            {k.replace("//", "/").lstrip("/"): v for k, v in grads.items()})
    return out


def _rank_slice(path, full, rank):
    """Rank ``rank``'s tp slice of a full leaf, by JAX's RULES."""
    from vqacl_tpu.parallel.sharding import param_sharding_rules

    spec = tuple(param_sharding_rules(path))
    if "tp" not in spec:
        return full
    d = spec.index("tp")
    n = full.shape[d] // 2
    return np.take(full, np.arange(rank * n, (rank + 1) * n), axis=d)


@pytest.fixture(scope="module")
def jax_blocks(blocks):
    jm, params, inputs, _ = blocks
    return _jax_blocks(jm, params, inputs)


@pytest.mark.parametrize("variant", ["unfused", "fused"])
@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_tp_blocks_match_jax(blocks, jax_blocks, stack, variant):
    jm, params, inputs, ranks = blocks
    want_e, want_d, want_g = jax_blocks[variant]
    for rank, r in enumerate(ranks):
        got = r[variant]
        np.testing.assert_allclose(got["enc" if stack == "encoder" else
                                       "dec"],
                                   want_e if stack == "encoder" else want_d,
                                   rtol=RTOL, atol=ATOL)
        grads = {k: v for k, v in got["grads"].items()
                 if k.startswith(stack) and "block_1" not in k}
        assert grads, stack
        for k, v in grads.items():
            want = want_g[k.replace(f"{stack}/", f"{stack}/", 1)]
            np.testing.assert_allclose(
                v, _rank_slice(k, want, rank), rtol=RTOL, atol=ATOL,
                err_msg=f"rank {rank} {k}")
        # the bias table's gradient is the whole table's on every rank
        np.testing.assert_array_equal(ranks[0][variant]["grads"][
            f"{stack}/rel_bias"], ranks[1][variant]["grads"][
            f"{stack}/rel_bias"])


def test_tp_layout_round_trips(blocks):
    for r in blocks[3]:
        assert r["round_trip"] and r["slice_equal"]
        np.testing.assert_allclose(r["sq_norm"], r["full_sq_norm"],
                                   rtol=1e-6)
        assert r["slice_shape"] == (32, 32)     # d_ff 64 over tp = 2
        assert "not divisible by tp=2" in r["indivisible"]


def w_dropout_masks(ctx, params, batch, fused):
    """Two train steps at dropout 0.1, one process and tp = 2, with every
    dropout mask recorded → (one-process, tp) records."""
    import torch

    from vqacl_tpu_torch.models import t5
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.parallel.mesh import tp_active
    from vqacl_tpu_torch.parallel.sharding import TpLayout
    from vqacl_tpu_torch.train.optim import make_transform
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_train_step
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    cfg = Config()
    cfg.model = tiny_model_config(dropout_rate=0.1, fused_attention=fused,
                                  fused_decoder=fused, **LAYERS)
    cfg.train.lr = 1e-3
    m = cfg.model
    full = from_jax_params(params)
    masks = []
    orig = t5.dropout

    def recording(x, rate, generator, tp_dim=None):
        y = orig(x, rate, generator, tp_dim)
        if generator is not None and rate > 0:
            keep = (y != 0) | (x == 0)
            ctx = tp_active()
            masks.append((keep.numpy().copy(), None if ctx is None or
                          tp_dim is None else tp_dim % x.dim()))
        return y

    t5.dropout = recording
    out = {}
    for name, mesh in (("one", None), ("tp", ctx)):
        masks.clear()
        tpl = TpLayout(ctx, full) if mesh is not None else None
        p = full if tpl is None else tpl.shard(full)
        state = TrainState.create(
            p, make_transform(cfg.train),
            ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cpu"), seed=1, warmup_iters=1.0,
            t_total=40.0)
        step = make_train_step(cfg, dtype=torch.float32, device="cpu",
                               mesh_ctx=mesh, tp=tpl)
        losses = []
        for _ in range(2):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        params_out = state.params if tpl is None else tpl.gather(state.params)
        out[name] = {"masks": list(masks), "losses": losses,
                     "params": flat_numpy(params_out)}
    t5.dropout = orig
    return out


@pytest.fixture(scope="module")
def dropout_runs(tmp_path_factory):
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA

    jm, params = jax_tiny_params(0, **LAYERS)
    tm = torch_cfg_like(jm)
    batch = next(iter(SyntheticVQA(8, seed=3, feat_dim=tm.feat_dim,
                                   n_boxes=tm.n_boxes,
                                   text_len=tm.max_text_length,
                                   vocab_size=tm.vocab_size,
                                   answer_vocab=8).batches(8, seed=4)))
    return {fused: spawn(w_dropout_masks, 2,
                         tmp_path_factory.mktemp(f"tp_drop{int(fused)}"),
                         mesh={"tp": 2}, params=params,
                         batch=batch["tensors"], fused=fused)
            for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
def test_tp_step_draws_the_one_process_masks(dropout_runs, fused):
    for rank, r in enumerate(dropout_runs[fused]):
        one, tp = r["one"], r["tp"]
        assert len(one["masks"]) == len(tp["masks"]) > 0
        cut = 0
        for (want, _), (got, dim) in zip(one["masks"], tp["masks"]):
            if dim is not None:
                n = got.shape[dim]
                want = np.take(want, np.arange(rank * n, (rank + 1) * n),
                               axis=dim)
                cut += 1
            np.testing.assert_array_equal(got, want)
        # the attention probabilities (unfused) and the MLP hidden are cut
        assert cut > 0
        np.testing.assert_allclose(tp["losses"], one["losses"], rtol=1e-6)
        for k, v in one["params"].items():
            np.testing.assert_allclose(tp["params"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
