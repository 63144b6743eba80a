"""The port's training step as a whole against the JAX package.

JAX parameters → ``from_jax_params`` → the port's ``make_train_step``
(``dtype=float32, device="cpu"``: the fused attention takes its plain
K1′/K2 versions through the autograd Function) must follow JAX
``make_train_step`` with ``fused_attention=True, fused_interpret=True``
(the Pallas kernels in interpret mode) for 3 steps on the tiny config at
dropout 0: per step, the loss, the grad norm, the lr and the retrieval /
memory metrics within 1e-5 relative, and the parameters and prototype
state within the tolerance stated below — with and without the memory
loss, and with ``grad_accum=2``. A checkpoint the port writes after
training loads in JAX and decodes to the same f32 tokens there. The
same holds with the fused decoder (``fused_decoder``) and with block
recompute (``remat`` True and "dots", against JAX's ``remat``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.data.synthetic import SyntheticVQA as JSynth  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.train.optim import make_transform as jax_transform  # noqa: E402
from vqacl_tpu.train.state import TrainState as JState  # noqa: E402
from vqacl_tpu.train.step import make_train_step as jax_train_step  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.train.optim import make_transform  # noqa: E402
from vqacl_tpu_torch.train.state import TrainState  # noqa: E402
from vqacl_tpu_torch.train.step import make_train_step  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

STEPS = 3
B = 8
METRIC_RTOL = 1e-5
# parameters after up to two non-zero Adam updates at lr 1e-3: the
# direction m/(√v+ε) amplifies the f32 rounding differences of gradient
# entries near ε (a slope of up to ~3e4 at the first step), so the bound
# is absolute: 1 % of one update (a wrong gradient or Adam term moves a
# parameter by a whole update, 1e-3)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
# the banks are means of hiddens computed from those parameters
PROTO_TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ("loss", "grad_norm", "lr", "loss_memory_Q", "loss_memory_V",
           "retrieval_acc_Q", "retrieval_acc_V")


def _configs(accum=1, fused_decoder=False):
    jcfg, params = jax_tiny_params(0, dropout_rate=0.0)
    jcfg.fused_attention = True
    jcfg.fused_interpret = True
    jcfg.fused_decoder = fused_decoder
    jc = JConfig()
    jc.model = jcfg
    jc.train.lr = 1e-3
    jc.train.grad_accum = accum
    tc = TConfig()
    tc.model = torch_cfg_like(jcfg)
    tc.train = dataclasses.replace(
        tc.train, **{f.name: getattr(jc.train, f.name)
                     for f in dataclasses.fields(tc.train)})
    return jc, tc, params


def _batches(m, n_steps):
    kw = dict(feat_dim=m.feat_dim, n_boxes=m.n_boxes,
              text_len=m.max_text_length, vocab_size=m.vocab_size,
              answer_vocab=8)
    jb = [b["tensors"] for b in JSynth(B * n_steps, seed=3, **kw).batches(
        B, seed=4)]
    tb = [b["tensors"] for b in SyntheticVQA(B * n_steps, seed=3,
                                             **kw).batches(B, seed=4)]
    return jb, tb


def _states(jc, tc, params):
    m = jc.model
    jtx = jax_transform(jc.train)
    jproto = JProto.create(m.n_ques_types, m.n_categories, m.d_model)
    jstate = JState.create(jax.tree.map(jnp.asarray, params), jtx, jproto,
                           jax.random.PRNGKey(1), warmup_iters=1.0,
                           t_total=40.0)
    tproto = TProto.create(m.n_ques_types, m.n_categories, m.d_model,
                           device="cpu")
    tstate = TrainState.create(from_jax_params(params),
                               make_transform(tc.train), tproto, seed=1,
                               warmup_iters=1.0, t_total=40.0)
    return jstate, tstate


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if hasattr(tree, "detach")
                               else tree)}


def _assert_state_close(js, ts, step):
    jp, tp = _flat(jax.device_get(js.params)), _flat(ts.params)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=f"step {step} {k}",
                                   **PARAM_TOL)
    for name in JProto._fields:
        np.testing.assert_allclose(
            getattr(ts.proto, name).numpy(),
            np.asarray(getattr(js.proto, name)),
            err_msg=f"step {step} proto {name}", **PROTO_TOL)
    assert int(ts.step) == int(js.step) and int(ts.opt_state.count) == \
        int(js.opt_state[1].count)


# variant → (grad_accum, memory loss, fused_decoder, remat)
VARIANTS = {
    "plain": (1, False, False, False),
    "memory_loss": (1, True, False, False),
    "grad_accum2": (2, False, False, False),
    "fused_decoder": (1, False, True, False),
    "remat_full": (1, False, False, True),
    "remat_dots": (1, False, False, "dots"),
    "fused_decoder_remat": (1, False, True, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_follow_jax(variant):
    accum, mem, fused_decoder, remat = VARIANTS[variant]
    jc, tc, params = _configs(accum=accum, fused_decoder=fused_decoder)
    assert tc.model.fused_decoder == fused_decoder
    jb, tb = _batches(jc.model, STEPS)
    for a, b in zip(jb, tb):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    jstate, tstate = _states(jc, tc, params)
    jstep = jax_train_step(jc, jax_transform(jc.train), dtype=jnp.float32,
                           use_memory_loss=mem, remat=remat, donate=False)
    tstep = make_train_step(tc, dtype=torch.float32, device="cpu",
                            use_memory_loss=mem, remat=remat)
    for s in range(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in jb[s].items()})
        tstate, tm = tstep(tstate, tb[s])
        for name in METRICS:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=METRIC_RTOL,
                                       err_msg=f"step {s} {name}")
        _assert_state_close(jstate, tstate, s)
    if mem:
        assert float(tm["loss_memory_Q"]) > 0.0
    assert float(tm["lr"]) == pytest.approx(jc.train.lr)


def test_grad_accum_matches_full_batch():
    """grad_accum=2 reproduces the full-batch step (dropout 0, prototype
    off so nothing threads between the microbatches): the loss is a
    per-example batch mean."""
    _, tc, params = _configs()
    tc.model = dataclasses.replace(tc.model, use_prototype=False)
    _, tb = _batches(tc.model, 1)
    out = {}
    for accum in (1, 2):
        tc.train.grad_accum = accum
        _, state = _states(_configs()[0], tc, params)
        state = state._replace(step=torch.ones((), dtype=torch.int32))
        out[accum] = make_train_step(tc, dtype=torch.float32,
                                     device="cpu")(state, tb[0])
    (s1, m1), (s2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    a, b = _flat(s1.params), _flat(s2.params)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)


def test_grad_accum_rejects_indivisible_batch():
    jc, tc, params = _configs(accum=3)
    _, tb = _batches(tc.model, 1)
    _, state = _states(jc, tc, params)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(tc, dtype=torch.float32, device="cpu")(state, tb[0])


def test_port_trained_checkpoint_decodes_the_same_in_jax(tmp_path):
    """The port trains 3 steps and saves; JAX ``load_checkpoint`` reads
    the file and JAX ``make_eval_step`` (Pallas in interpret mode) gives
    the port's f32 eval tokens exactly."""
    from vqacl_tpu.train.checkpoint import load_checkpoint as jax_load
    from vqacl_tpu.train.step import make_eval_step as jax_eval_step
    from vqacl_tpu_torch.train.checkpoint import save_checkpoint
    from vqacl_tpu_torch.train.step import make_eval_step

    jc, tc, params = _configs()
    tc.train.lr = 1e-2
    _, tb = _batches(tc.model, STEPS)
    _, state = _states(jc, tc, params)
    step = make_train_step(tc, dtype=torch.float32, device="cpu")
    for s in range(STEPS):
        state, _ = step(state, tb[s])
    path = str(tmp_path / "port_ckpt")
    save_checkpoint(path, state.params, state.proto, step=int(state.step))

    jparams, jproto, jstep = jax_load(path)
    assert jstep == STEPS
    eval_batch = {k: tb[0][k] for k in ("input_ids", "vis_feats", "boxes")}
    ttok = make_eval_step(tc, dtype=torch.float32, device="cpu")(
        state.params, state.proto, eval_batch).numpy()
    jtok = np.asarray(jax_eval_step(jc, dtype=jnp.float32)(
        jax.tree.map(jnp.asarray, jparams),
        JProto(*map(jnp.asarray, jproto)),
        {k: jnp.asarray(v) for k, v in eval_batch.items()}))
    np.testing.assert_array_equal(ttok, jtok)


def test_train_entry_points_need_a_device_without_cuda():
    """``make_train_step()`` and ``make_loss_eval_step()`` with no device
    raise on a machine without CUDA instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from vqacl_tpu_torch.train.step import make_loss_eval_step

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(TConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_loss_eval_step(TConfig())
