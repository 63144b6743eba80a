"""The port's device feature cache against the JAX package's.

``_to_bf16_fast`` gives JAX's bits (ties, subnormals, infinities, NaN)
and ``_quant_rows`` JAX's int8 values and scales; ``lookup`` of a bf16,
f32 or int8 table gives JAX's features and boxes, zeros for slot −1 and
out-of-range slots; ``from_store`` builds JAX's table and slot map, and
slot-mode datasets collate to JAX's batches. The four cached steps (train,
eval, DER replay, DER capture) match JAX's cached steps in f32 at dropout
0, and a bf16 table gives the host path's tokens in bf16. ``VQACLTrainer``
with ``data.device_cache`` (bf16 with EWC, int8 with DER++) follows JAX's
trainer with its cache as ``test_torch_cl_trainer.py`` holds the host
path: the same batches (slots), losses within 1e-4 relative, the same
answers and matrices. The sharded cache needs a mesh (its runs are in
``test_torch_dp_trainer.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_cl_trainer import (_assert_follows, _configs,  # noqa: E402
                                   _jax_trainer, _port_trainer, _train_both)
from torch_parity import jax_tiny_params, proto_banks, torch_cfg_like  # noqa: E402
from vqacl_tpu.cl.trainer import VQACLTrainer as JTrainer  # noqa: E402
from vqacl_tpu.data import device_cache as JD  # noqa: E402
from vqacl_tpu.data.features import MemoryFeatureStore as JStore  # noqa: E402
from vqacl_tpu.data.synthetic import SyntheticVQA as JSynth  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.train.optim import make_transform as jax_transform  # noqa: E402
from vqacl_tpu.train.state import TrainState as JState  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cl.trainer import VQACLTrainer as TTrainer  # noqa: E402
from vqacl_tpu_torch.data import device_cache as TD  # noqa: E402
from vqacl_tpu_torch.data.features import MemoryFeatureStore  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves  # noqa: E402
from vqacl_tpu_torch.train.state import TrainState  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

# step metrics and parameters after one step, as test_torch_cl_steps.py
TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = [("bfloat16", jnp.bfloat16), ("float32", jnp.float32),
          ("int8", jnp.int8)]
B = 8


def _table(seed=0, n=20, n_boxes=4, feat_dim=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, n_boxes, feat_dim)).astype(np.float32)
    feats[3] = 0.0                      # an all-zero image: int8 scale 1
    boxes = rng.uniform(0, 1, (n, n_boxes, 4)).astype(np.float32)
    return feats, boxes


def test_to_bf16_fast_bits_equal_jax():
    rng = np.random.default_rng(1)
    tie = np.float32(1.0 + 2.0 ** -8)            # halfway: rounds to even
    tie_up = np.float32(1.0 + 3 * 2.0 ** -8)     # halfway: rounds up
    special = np.asarray(
        [0.0, -0.0, 1.0, -1.0, tie, -tie, tie_up, 1e-40, -1e-40, 1e-45,
         np.finfo(np.float32).tiny, np.finfo(np.float32).max, 3.0e38,
         np.inf, -np.inf, np.nan], np.float32)
    x = np.concatenate([special, rng.normal(size=4096).astype(np.float32),
                        rng.normal(size=4096).astype(np.float32) * 1e-39])
    bits = TD._to_bf16_fast(x)
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits,
                                  JD._to_bf16_fast(x).view(np.uint16))
    # as a tensor: the bits of torch's own round-to-nearest-even cast
    finite = np.isfinite(x) & (np.abs(x) < 3.0e38)
    t = TD._bf16_tensor(bits)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy()[finite],
        torch.from_numpy(x[finite]).to(torch.bfloat16).view(
            torch.int16).numpy())


def test_quant_rows_equal_jax():
    feats, _ = _table()
    feats[5, 1] = np.float32(127.5) / 127 * np.arange(16)   # .5 ties
    q, s = TD._quant_rows(feats)
    jq, js = JD._quant_rows(feats)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert (s[3] == 1.0).all()


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_lookup_equals_jax(name, jdt):
    feats, boxes = _table()
    tcache = TD.DeviceFeatureCache(feats, boxes, device="cpu",
                                   feat_dtype=TD.DTYPES[name])
    jcache = JD.DeviceFeatureCache(feats, boxes, feat_dtype=jdt)
    slots = np.asarray([3, 0, 19, -1, 7, 20, 1000, -5, 5], np.int32)
    f, b = tcache.lookup(slots)
    jf, jb = jcache.lookup(jnp.asarray(slots))
    assert f.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf, np.float32))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    for row in (3, 5, 6, 7):                      # −1 and out of range
        assert not f[row].any() and not b[row].any()
    if name == "int8":
        assert tcache.feats.dtype == torch.int8
        err = np.abs(f[[0, 1, 2, 4]].numpy() - feats[[3, 0, 19, 7]])
        half = np.abs(feats[[3, 0, 19, 7]]).max(-1, keepdims=True) / 254
        assert (err <= half + 1e-7).all()
    else:
        np.testing.assert_array_equal(b[4].numpy(), boxes[7])
    assert tcache.nbytes == sum(
        a.nbytes for a in (jcache.feats, jcache.boxes, jcache.scales)
        if a is not None)


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_from_store_equals_jax(name, jdt):
    feats, boxes = _table(seed=2)
    jstore, tstore = JStore(), MemoryFeatureStore()
    for i in range(len(feats)):
        jstore.put(f"img{i}", feats[i], boxes[i])
        tstore.put(f"img{i}", feats[i], boxes[i])
    ids = [f"img{i}" for i in (4, 1, 9, 0, 13)]
    tcache, tslots = TD.DeviceFeatureCache.from_store(
        tstore, ids, device="cpu", feat_dtype=TD.DTYPES[name])
    jcache, jslots = JD.DeviceFeatureCache.from_store(jstore, ids,
                                                      feat_dtype=jdt)
    assert tslots == jslots == {img: i for i, img in enumerate(ids)}
    tf = tcache.feats.view(torch.int16).numpy() if name == "bfloat16" \
        else tcache.feats.numpy()
    jf = np.asarray(jcache.feats)
    np.testing.assert_array_equal(tf, jf.view(np.int16) if name == "bfloat16"
                                  else jf)
    np.testing.assert_array_equal(tcache.boxes.numpy(),
                                  np.asarray(jcache.boxes))
    if name == "int8":
        np.testing.assert_array_equal(tcache.scales.numpy(),
                                      np.asarray(jcache.scales))
    # the table built at once from the stacked features is the same
    direct = TD.DeviceFeatureCache(feats[[4, 1, 9, 0, 13]],
                                   boxes[[4, 1, 9, 0, 13]], device="cpu",
                                   feat_dtype=TD.DTYPES[name])
    assert torch.equal(direct.feats, tcache.feats)


def test_sharded_cache_and_unknown_dtype_refused():
    feats, boxes = _table()
    with pytest.raises(ValueError, match="mesh"):
        TD.DeviceFeatureCache(feats, boxes, device="cpu", shard=True)
    with pytest.raises(ValueError, match="feat_dtype"):
        TD.DeviceFeatureCache(feats, boxes, device="cpu",
                              feat_dtype=torch.float16)
    with pytest.raises(ValueError, match="scales"):
        TD.DeviceFeatureCache(feats.astype(np.int8), boxes, device="cpu",
                              feat_dtype=torch.int8)


def test_slot_mode_collate_equals_jax():
    from vqacl_tpu.data.synthetic_module import SyntheticDataModule as JData
    from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok
    from vqacl_tpu_torch.data.partition import BatchLoader
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu.data.partition import BatchLoader as JLoader

    kw = dict(tasks=["q_recognition"], n_train_per_task=20,
              n_val_per_task=4, n_test_per_task=4, feat_dim=16, n_boxes=4,
              n_images=12, seed=0)
    jd, td = JData(JTok(), **kw), SyntheticDataModule(VLT5Tokenizer(), **kw)
    ids = sorted(td.cate_map)
    _, jslots = JD.DeviceFeatureCache.from_store(jd.features, ids,
                                                 feat_dtype=jnp.float32)
    _, tslots = TD.DeviceFeatureCache.from_store(td.features, ids,
                                                 device="cpu",
                                                 feat_dtype=torch.float32)
    jds = jd.dataset("q_recognition", "train", task_idx=0)
    tds = td.dataset("q_recognition", "train", task_idx=0)
    jds.slot_of, tds.slot_of = jslots, tslots
    ck = dict(max_text_length=20, n_boxes=4, feat_dim=16)
    jb = list(JLoader(jds, np.arange(len(jds)), 8, shuffle=True, seed=3,
                      drop_last=False, collate_kw=ck))
    tb = list(BatchLoader(tds, np.arange(len(tds)), 8, shuffle=True, seed=3,
                          drop_last=False, collate_kw=ck))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert set(a["tensors"]) == set(b["tensors"])
        assert "slots" in a["tensors"] and "vis_feats" not in a["tensors"]
        for k, v in b["tensors"].items():
            np.testing.assert_array_equal(a["tensors"][k], v, err_msg=k)
        assert a["meta"]["question_ids"] == b["meta"]["question_ids"]
    assert (tb[-1]["tensors"]["slots"][4:] == -1).all()   # pad rows


@pytest.fixture(scope="module")
def steps_setup():
    jm, params = jax_tiny_params(0, dropout_rate=0.0)
    jc, tc = JConfig(), TConfig()
    jc.model, tc.model = jm, torch_cfg_like(jm)
    jc.train.lr = 1e-3
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    batch = next(JSynth(B, seed=3, feat_dim=jm.feat_dim, n_boxes=jm.n_boxes,
                        text_len=jm.max_text_length,
                        vocab_size=jm.vocab_size,
                        answer_vocab=8).batches(B, seed=4))["tensors"]
    # the table holds the batch's images in another order, plus others
    rng = np.random.default_rng(5)
    perm = rng.permutation(B + 4)
    feats = rng.normal(size=(B + 4, jm.n_boxes, jm.feat_dim)).astype(
        np.float32)
    boxes = rng.uniform(0, 1, (B + 4, jm.n_boxes, 4)).astype(np.float32)
    feats[perm[:B]], boxes[perm[:B]] = batch["vis_feats"], batch["boxes"]
    slotted = {k: v for k, v in batch.items()
               if k not in ("vis_feats", "boxes")}
    slotted["slots"] = perm[:B].astype(np.int32)
    qb, vb = proto_banks(jm, seed=2)
    jproto = JProto.create(jm.n_ques_types, jm.n_categories,
                           jm.d_model)._replace(q_proto=jnp.asarray(qb),
                                                v_proto=jnp.asarray(vb))
    tproto = TProto.create(jm.n_ques_types, jm.n_categories, jm.d_model,
                           device="cpu")._replace(
        q_proto=torch.from_numpy(qb), v_proto=torch.from_numpy(vb))
    return dict(jc=jc, tc=tc, params=params, batch=batch, slotted=slotted,
                feats=feats, boxes=boxes, jproto=jproto, tproto=tproto,
                jcache=JD.DeviceFeatureCache(feats, boxes,
                                             feat_dtype=jnp.float32),
                tcache=TD.DeviceFeatureCache(feats, boxes, device="cpu",
                                             feat_dtype=torch.float32))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _states(s):
    js = JState.create(_jtree(s["params"]), jax_transform(s["jc"].train),
                       s["jproto"], jax.random.PRNGKey(1))
    ts = TrainState.create(from_jax_params(s["params"]),
                           make_transform(s["tc"].train), s["tproto"],
                           seed=1)
    return js, ts


def _assert_step_close(js, ts, jm, tm, names):
    for name in names:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **TOL)
    for a, b in zip(tree_leaves(ts.params),
                    jax.tree.leaves(jax.device_get(js.params))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cached_train_step_equals_jax(steps_setup):
    s = steps_setup
    jstep = JD.make_cached_train_step(s["jc"], jax_transform(s["jc"].train),
                                      s["jcache"], dtype=jnp.float32,
                                      donate=False)
    tstep = TD.make_cached_train_step(s["tc"], s["tcache"],
                                      dtype=torch.float32, device="cpu")
    js, ts = _states(s)
    js, jm = jstep(js, s["slotted"])
    ts, tm = tstep(ts, s["slotted"])
    _assert_step_close(js, ts, jm, tm, ("loss", "grad_norm", "lr"))
    # and the host path's step on the same features
    from vqacl_tpu_torch.train.step import make_train_step
    _, hm = make_train_step(s["tc"], dtype=torch.float32, device="cpu")(
        _states(s)[1], s["batch"])
    assert float(hm["loss"]) == float(tm["loss"])


def test_cached_der_step_equals_jax(steps_setup):
    s = steps_setup
    jc, tc = s["jc"], s["tc"]
    jc.train.cl_reg = tc.train.cl_reg = "derpp"
    jc.train.reg_lambda = tc.train.reg_lambda = 0.5
    try:
        teacher = jax_tiny_params(9, dropout_rate=0.0)[1]
        z = TD.make_cached_logits_step(tc, s["tcache"], dtype=torch.float32,
                                       device="cpu")(
            from_jax_params(teacher), s["tproto"], s["slotted"])
        b = dict(s["slotted"], der_logits=z.to(torch.float16).numpy())
        jstep = JD.make_cached_der_step(jc, jax_transform(jc.train),
                                        s["jcache"], dtype=jnp.float32,
                                        donate=False)
        tstep = TD.make_cached_der_step(tc, s["tcache"], dtype=torch.float32,
                                        device="cpu")
        js, ts = _states(s)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
    finally:
        jc.train.cl_reg = tc.train.cl_reg = "none"
        jc.train.reg_lambda = tc.train.reg_lambda = 1.0
    _assert_step_close(js, ts, jm, tm, ("loss", "der_mse", "grad_norm"))
    assert float(tm["der_mse"]) > 0.0


def test_cached_logits_and_eval_steps_equal_jax(steps_setup):
    s = steps_setup
    jl = JD.make_cached_logits_step(s["jc"], s["jcache"], dtype=jnp.float32)(
        _jtree(s["params"]), s["jproto"], s["slotted"])
    tl = TD.make_cached_logits_step(s["tc"], s["tcache"],
                                    dtype=torch.float32, device="cpu")(
        from_jax_params(s["params"]), s["tproto"], s["slotted"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    eb = {k: s["slotted"][k] for k in ("input_ids", "slots")}
    for kw in ({}, {"num_beams": 3}):
        jt = JD.make_cached_eval_step(s["jc"], s["jcache"],
                                      dtype=jnp.float32, **kw)(
            _jtree(s["params"]), s["jproto"], eb)
        tt = TD.make_cached_eval_step(s["tc"], s["tcache"],
                                      dtype=torch.float32, device="cpu",
                                      **kw)(
            from_jax_params(s["params"]), s["tproto"], eb)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_bf16_cache_gives_the_host_path_tokens_in_bf16(steps_setup):
    """The encoder rounds the features to bf16 first, so a bf16 table
    decodes as the host path does in bf16."""
    from vqacl_tpu_torch.train.step import make_eval_step

    s = steps_setup
    cache = TD.DeviceFeatureCache(s["feats"], s["boxes"], device="cpu",
                                  feat_dtype=torch.bfloat16)
    params = from_jax_params(s["params"])
    params["shared"][0] = 0.0
    eb = {k: s["slotted"][k] for k in ("input_ids", "slots")}
    cached = TD.make_cached_eval_step(s["tc"], cache, dtype=torch.bfloat16,
                                      device="cpu")(params, s["tproto"], eb)
    host = make_eval_step(s["tc"], dtype=torch.bfloat16, device="cpu")(
        params, s["tproto"], s["batch"])
    assert torch.equal(cached, host)


@pytest.mark.parametrize("cache_dtype,reg", [("bfloat16", "ewc"),
                                             ("int8", "derpp")])
def test_trainer_with_device_cache_follows_jax(tmp_path, cache_dtype, reg):
    jc, tc, params = _configs(tmp_path / "jax", tmp_path / "port", reg)
    for c in (jc, tc):
        c.data.device_cache = True
        c.data.device_cache_dtype = cache_dtype
    j, t = _train_both(_jax_trainer(JTrainer, jc, params),
                       _port_trainer(TTrainer, tc, params))
    jt, tt = j[0], t[0]
    assert tt._cache is not None and jt._cache is not None
    assert tt._cache.feats.dtype == TD.DTYPES[cache_dtype]
    np.testing.assert_array_equal(
        tt._cache.feats.view(torch.int16).numpy()
        if cache_dtype == "bfloat16" else tt._cache.feats.numpy(),
        np.asarray(jt._cache.feats).view(np.int16)
        if cache_dtype == "bfloat16" else np.asarray(jt._cache.feats))
    # every step's batch carries slots, no features
    assert all("slots" in b and "vis_feats" not in b
               for b in t[1]["batches"])
    _assert_follows(j, t)
    c = tt.counts
    assert c["replay_steps"] > 0
    assert c["importance_batches" if reg == "ewc" else "capture_batches"] > 0


def test_trainer_refuses_the_sharded_cache(tmp_path):
    """The sharded cache is taken since the parallel slice: over the dp
    of the trainer's mesh. Asked for dp = 2 in one process, the trainer
    refuses (it never runs on fewer ranks than asked); an unknown table
    type is refused too."""
    _, tc, params = _configs(tmp_path, tmp_path)
    tc.data.device_cache = True
    tc.data.device_cache_sharded = True
    tc.mesh.dp = 2
    with pytest.raises(ValueError, match="dp=1 ranks"):
        _port_trainer(TTrainer, tc, params)
    tc.mesh.dp = -1
    tc.data.device_cache_sharded = False
    tc.data.device_cache_dtype = "float16"
    with pytest.raises(ValueError, match="device_cache_dtype"):
        _port_trainer(TTrainer, tc, params)
