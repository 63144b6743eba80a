"""The port's decoding options against the JAX package's.

``beam_search`` (HF ``generate(num_beams=K)`` in the JAX package's
static-shape form), ``greedy_decode(max_length, early_stop)`` and
``make_eval_step(use_prototype, max_length, num_beams)`` on the same
tiny weights and encoder states must give exactly JAX's token ids in
f32. The beam cases run with and without an EOS row that the decoder
reaches, so items finish through the pool, through ``is_done`` and
through the final merge. Beam search ranks ties at −1e9 every step;
``_top_k`` must rank them as ``jax.lax.top_k`` does, which
``torch.topk`` does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (encoder_inputs, jax_tiny_params, proto_banks,  # noqa: E402
                          torch_cfg_like)
from vqacl_tpu.models.generate import beam_search as jax_beam  # noqa: E402
from vqacl_tpu.models.generate import greedy_decode as jax_greedy  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.generate import (_top_k, beam_search,  # noqa: E402
                                             greedy_decode)

VOCAB, GEN_LEN = 48, 8
B, S = 6, 7
SEEDS = (0, 2, 3)
EOS_GAIN = 1.2


def _case(seed, eos):
    """(JAX cfg, numpy params, encoder states [B,S,D], mask [B,S]). With
    ``eos`` the EOS row (1) becomes 1.2 × the mean of the rows greedy
    picks, plus noise (an exact copy of one row would tie its logits
    with that row's in one framework and not in the other)."""
    cfg, params = jax_tiny_params(seed, vocab_size=VOCAB,
                                  gen_max_length=GEN_LEN)
    rng = np.random.default_rng(seed + 100)
    enc = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, 5:] = 0.0
    if eos:
        picked = np.asarray(jax_greedy(
            jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(enc),
            jnp.asarray(mask), dtype=jnp.float32, early_stop=False))
        shared = params["shared"].copy()
        shared[1] = EOS_GAIN * shared[picked.reshape(-1)].mean(axis=0) \
            + 0.1 * rng.normal(size=shared.shape[1]).astype(np.float32)
        params = {**params, "shared": shared}
    return cfg, params, enc, mask


@pytest.fixture(scope="module")
def cases():
    return {(seed, eos): _case(seed, eos) for seed in SEEDS
            for eos in (False, True)}


_JAX_BEAM = {}


def _jax_beam_tokens(cfg, params, enc, mask, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_BEAM:
        _JAX_BEAM[key] = jax.jit(lambda p, e, m: jax_beam(
            p, cfg, e, m, dtype=jnp.float32, **kw))
    return np.asarray(_JAX_BEAM[key](jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(enc), jnp.asarray(mask)))


@pytest.mark.parametrize("max_length", [None, 6])
@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
@pytest.mark.parametrize("num_beams", [2, 3, 5])
def test_beam_search_tokens_equal_jax(cases, num_beams, length_penalty,
                                      max_length):
    eos_rows = 0
    for (seed, eos), (cfg, params, enc, mask) in cases.items():
        kw = dict(num_beams=num_beams, max_length=max_length,
                  length_penalty=length_penalty)
        ref = _jax_beam_tokens(cfg, params, enc, mask, **kw)
        out = beam_search(from_jax_params(params), torch_cfg_like(cfg),
                          torch.from_numpy(enc), torch.from_numpy(mask),
                          dtype=torch.float32, **kw)
        assert out.dtype == torch.int32
        assert out.shape == (B, (max_length or GEN_LEN) - 1)
        np.testing.assert_array_equal(out.numpy(), ref,
                                      err_msg=f"seed {seed} eos {eos}")
        eos_rows += int((ref == 1).any(axis=1).sum())
    # some hypotheses finished through the pool, the rest at the merge
    assert 0 < eos_rows < len(cases) * B


def test_top_k_ranks_ties_as_lax_top_k():
    x = np.asarray([-1e9, .5, -1e9, .5, -1e9, -1e9, .2, -1e9], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 6)[1])
    np.testing.assert_array_equal(want, [1, 3, 6, 0, 2, 4])
    vals, idx = _top_k(torch.from_numpy(x)[None], 6)
    np.testing.assert_array_equal(idx[0].numpy(), want)
    np.testing.assert_array_equal(vals[0].numpy(), x[want])
    # torch.topk orders the ties at -1e9 otherwise
    assert not np.array_equal(torch.topk(torch.from_numpy(x), 6)[1].numpy(),
                              want)
    rng = np.random.default_rng(0)
    levels = np.asarray([-1e9, -7.0, -0.25, 0.0, 0.5, 3.0], np.float32)
    for _ in range(50):
        n = int(rng.integers(2, 200))
        k = int(rng.integers(1, n + 1))
        a = rng.choice(levels, size=(3, n))
        a = np.where(rng.random((3, n)) < 0.3,
                     rng.normal(size=(3, n)), a).astype(np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(a), k)
        v, i = _top_k(torch.from_numpy(a), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("max_length", [None, 6])
def test_greedy_decode_options_equal_jax(cases, max_length, early_stop):
    for (seed, eos), (cfg, params, enc, mask) in cases.items():
        ref = np.asarray(jax_greedy(
            jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(enc),
            jnp.asarray(mask), max_length=max_length, dtype=jnp.float32,
            early_stop=early_stop))
        out = greedy_decode(from_jax_params(params), torch_cfg_like(cfg),
                            torch.from_numpy(enc), torch.from_numpy(mask),
                            max_length=max_length, dtype=torch.float32,
                            early_stop=early_stop)
        np.testing.assert_array_equal(out.numpy(), ref,
                                      err_msg=f"seed {seed} eos {eos}")


@pytest.mark.parametrize("use_prototype,num_beams,max_length", [
    (False, 1, 6), (False, 3, None), (None, 3, 6), (None, 1, None)])
def test_eval_step_options_equal_jax(use_prototype, num_beams, max_length):
    from vqacl_tpu.models.prototype import ProtoState as JProto
    from vqacl_tpu.train.step import make_eval_step as jax_eval_step
    from vqacl_tpu.utils.config import Config as JConfig
    from vqacl_tpu_torch.models.prototype import ProtoState as TProto
    from vqacl_tpu_torch.train.step import make_eval_step
    from vqacl_tpu_torch.utils.config import Config as TConfig

    jm, params = jax_tiny_params(0, vocab_size=32200)
    params["shared"][0] = 0.0
    jm.fused_attention = True
    jm.fused_interpret = True
    jc, tc = JConfig(), TConfig()
    jc.model, tc.model = jm, torch_cfg_like(jm)
    ids, feats, boxes = encoder_inputs(jm, 4, seed=5)
    batch = {"input_ids": ids, "vis_feats": feats, "boxes": boxes}
    q, v = proto_banks(jm, seed=1)
    jp = JProto.create(jm.n_ques_types, jm.n_categories, jm.d_model)._replace(
        q_proto=jnp.asarray(q), v_proto=jnp.asarray(v))
    tp = TProto.create(jm.n_ques_types, jm.n_categories, jm.d_model,
                       device="cpu")._replace(q_proto=torch.from_numpy(q),
                                              v_proto=torch.from_numpy(v))
    kw = dict(use_prototype=use_prototype, max_length=max_length,
              num_beams=num_beams)
    ref = np.asarray(jax_eval_step(jc, dtype=jnp.float32, **kw)(
        jax.tree.map(jnp.asarray, params), jp,
        {k: jnp.asarray(x) for k, x in batch.items()}))
    out = make_eval_step(tc, dtype=torch.float32, device="cpu", **kw)(
        from_jax_params(params), tp, batch)
    assert out.shape == (4, (max_length or jm.gen_max_length) - 1)
    np.testing.assert_array_equal(out.numpy(), ref)
