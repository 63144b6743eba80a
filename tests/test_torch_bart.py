"""VL-BART (``models/bart.py``) against the JAX package's.

One tree from a random-init ``transformers`` BART (tiny widths) through
both packages' ``bart_from_state_dict`` (equal bit for bit), plus one
visual embedding made with numpy; then ``bart_encode`` and
``bart_decode_train`` of both on the same inputs (f32 on the CPU) within
``TOL``, with and without regions, and against HF's own logits as the
JAX test holds them. ``init_bart_params`` has JAX init's keys and shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.models import bart as jbart  # noqa: E402
from vqacl_tpu_torch.models import bart  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass
class BartCfg:
    vocab_size: int = 128
    d_model: int = 32
    num_heads: int = 4
    d_ff: int = 64
    num_layers: int = 2
    num_decoder_layers: int = 2
    dropout_rate: float = 0.0
    max_position_embeddings: int = 64
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    feat_dim: int = 16
    pos_dim: int = 4
    n_images: int = 2
    use_vis_order_embedding: bool = True
    use_vis_layer_norm: bool = True
    individual_vis_layer_norm: bool = True
    layer_norm_epsilon: float = 1e-5
    use_vision: bool = True


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


@pytest.fixture(scope="module")
def pair():
    transformers = pytest.importorskip("transformers")
    cfg = BartCfg()
    hf_cfg = transformers.BartConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        encoder_layers=cfg.num_layers, decoder_layers=cfg.num_decoder_layers,
        encoder_attention_heads=cfg.num_heads,
        decoder_attention_heads=cfg.num_heads,
        encoder_ffn_dim=cfg.d_ff, decoder_ffn_dim=cfg.d_ff,
        max_position_embeddings=cfg.max_position_embeddings,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        activation_function="gelu", pad_token_id=1, bos_token_id=0,
        eos_token_id=2, decoder_start_token_id=2, forced_eos_token_id=None,
        scale_embedding=False, tie_word_embeddings=True)
    torch.manual_seed(0)
    hf = transformers.BartForConditionalGeneration(hf_cfg).eval()
    sd = hf.state_dict()
    jp = jbart.bart_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                    cfg)
    tp = bart.bart_from_state_dict(sd, cfg)
    rng = np.random.default_rng(0)
    D = cfg.d_model
    vis = {"feat_w": rng.normal(size=(cfg.feat_dim, D)) * 0.25,
           "feat_b": 0.1 * rng.normal(size=D),
           "pos_w": rng.normal(size=(cfg.pos_dim + 1, D)),
           "pos_b": 0.1 * rng.normal(size=D),
           "feat_ln": 1 + 0.1 * rng.normal(size=D),
           "pos_ln": 1 + 0.1 * rng.normal(size=D),
           "img_order": rng.normal(size=(cfg.n_images, D))}
    vis = {k: np.asarray(v, np.float32) for k, v in vis.items()}
    jp["visual_embedding"] = vis
    tp["visual_embedding"] = from_jax_params(vis)
    return cfg, hf, jp, tp


def _inputs(cfg, seed=1, B=3, L=9, N=4, T=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(B, L))
    ids[1, 6:] = cfg.pad_token_id
    attn = (ids != cfg.pad_token_id).astype(np.float32)
    feats = rng.normal(size=(B, N, cfg.feat_dim)).astype(np.float32)
    x1y1 = rng.uniform(0, 0.5, (B, N, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(0.1, 0.4, (B, N, 2))],
                           axis=2).clip(0, 1).astype(np.float32)
    labels = rng.integers(3, cfg.vocab_size, size=(B, T))
    labels[0, 3:] = -100
    return ids, attn, feats, boxes, labels


def test_from_state_dict_equals_jax(pair):
    _, _, jp, tp = pair
    a, b = _flat(tp), _flat(jp)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("regions", [False, True])
def test_encode_and_decode_equal_jax(pair, regions):
    cfg, _, jp, tp = pair
    ids, attn, feats, boxes, labels = _inputs(cfg)
    vis = (feats, boxes) if regions else (None, None)
    jenc, jmask = jbart.bart_encode(
        jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(ids),
        jnp.asarray(attn), *(None if v is None else jnp.asarray(v)
                             for v in vis))
    jlog = jbart.bart_decode_train(jax.tree.map(jnp.asarray, jp), cfg, jenc,
                                   jmask, jnp.asarray(labels))
    t = torch.from_numpy
    tenc, tmask = bart.bart_encode(tp, cfg, t(ids), t(attn),
                                   *(None if v is None else t(v)
                                     for v in vis))
    tlog = bart.bart_decode_train(tp, cfg, tenc, tmask, t(labels))
    assert tenc.shape == (3, 9 + (4 if regions else 0), cfg.d_model)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_logits_match_hf(pair):
    """As JAX's ``test_bart_logits_match``: the text-only model against
    HF's ``BartForConditionalGeneration``."""
    cfg, hf, _, tp = pair
    ids, attn, _, _, labels = _inputs(cfg, seed=2)
    t = torch.from_numpy
    with torch.no_grad():
        ref = hf(input_ids=t(ids), attention_mask=t(attn),
                 labels=t(labels)).logits
    enc, mask = bart.bart_encode(tp, cfg, t(ids), t(attn))
    out = bart.bart_decode_train(tp, cfg, enc, mask, t(labels))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_shift_tokens_right_equals_jax():
    labels = np.array([[5, 7, -100], [9, -100, -100]], np.int64)
    ref = np.asarray(jbart.shift_tokens_right(jnp.asarray(labels), 1, 2))
    out = bart.shift_tokens_right(torch.from_numpy(labels), 1, 2).numpy()
    np.testing.assert_array_equal(out, ref)


def test_init_has_jax_keys_and_shapes():
    cfg = BartCfg()
    ref = _flat(jax.device_get(jbart.init_bart_params(jax.random.PRNGKey(0),
                                                      cfg)))
    out = _flat(bart.init_bart_params(0, cfg, device="cpu"))
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == np.float32, k
    again = _flat(bart.init_bart_params(0, cfg, device="cpu"))
    assert all(np.array_equal(out[k], again[k]) for k in out)


def test_dropout_runs_from_a_generator(pair):
    cfg, _, _, tp = pair
    c = dataclasses.replace(cfg, dropout_rate=0.1)
    ids, attn, feats, boxes, labels = _inputs(cfg)
    t = torch.from_numpy
    runs = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        enc, mask = bart.bart_encode(tp, c, t(ids), t(attn), t(feats),
                                     t(boxes), generator=g)
        runs.append(bart.bart_decode_train(tp, c, enc, mask, t(labels),
                                           generator=g))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[2]).all()
