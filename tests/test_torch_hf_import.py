"""Weight import and export (``models/hf_import.py``,
``cli/export_pth.py``) against the JAX package's.

State dicts come from a random-init ``transformers`` T5 (tiny widths) and
from reference-style keys built here (``module.``, ``vis_encoder.``, a
visual embedding, a vocabulary resize); both packages import them and
the trees must be equal bit for bit. ``to_state_dict`` gives JAX's keys
and values; ``.pth`` and ``.safetensors`` files round-trip; ``load_t5_base``
reads a ``save_pretrained`` directory (safetensors or ``.bin``) as JAX's
does, and the HF cache layout on disk, and raises FileNotFoundError
without files; ``export_pth`` writes what JAX's CLI writes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import jax_tiny_params, torch_cfg_like  # noqa: E402
from vqacl_tpu.models import hf_import as jhf  # noqa: E402
from vqacl_tpu_torch.models import hf_import as hf  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402

HF_VOCAB = 100


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(port, ref):
    a, b = _flat(port), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _cfg(vocab):
    jcfg, _ = jax_tiny_params(0, vocab_size=vocab)
    return jcfg, torch_cfg_like(jcfg)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    c = transformers.T5Config(
        vocab_size=HF_VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64,
        num_layers=2, num_decoder_layers=2, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, feed_forward_proj="relu",
        tie_word_embeddings=True, dropout_rate=0.0)
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(c).eval()


def _reference_keys(sd, seed=0):
    """An HF state dict as a reference-trained VL-T5 checkpoint names it:
    ``module.`` on every key, ``vis_encoder.`` for the encoder, with
    visual-embedding weights."""
    rng = np.random.default_rng(seed)
    D = sd["shared.weight"].shape[1]
    vis = {"feat_embedding.0.weight": (D, 16), "feat_embedding.0.bias": (D,),
           "absolute_vis_pos_embedding.0.weight": (D, 5),
           "absolute_vis_pos_embedding.0.bias": (D,),
           "feat_embedding.1.weight": (D,),
           "absolute_vis_pos_embedding.1.weight": (D,),
           "img_order_embedding.weight": (2, D)}
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder."):
            k = "vis_" + k
        out["module." + k] = v
    for k, shape in vis.items():
        out[f"module.vis_encoder.visual_embedding.{k}"] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
    return out


@pytest.mark.parametrize("vocab", [HF_VOCAB, 128, 64])
def test_from_state_dict_equals_jax(hf_model, vocab):
    """A transformers state dict, at the same vocabulary, extended (N(0,1)
    rows from the same numpy seed) and cut."""
    jcfg, tcfg = _cfg(vocab)
    sd = hf_model.state_dict()
    ref = jhf.from_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    _assert_trees_equal(hf.from_state_dict(sd, tcfg), ref)
    assert "visual_embedding" not in ref
    with pytest.raises(KeyError, match="visual_embedding"):
        hf.from_state_dict(sd, tcfg, strict_visual=True)


def test_reference_keys_equal_jax(hf_model):
    jcfg, tcfg = _cfg(128)
    sd = _reference_keys(hf_model.state_dict())
    ref = jhf.from_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    port = hf.from_state_dict(sd, tcfg, strict_visual=True)
    assert "visual_embedding" in ref
    _assert_trees_equal(port, ref)
    # numpy values are taken as well as tensors
    _assert_trees_equal(hf.from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, tcfg), ref)


def test_to_state_dict_equals_jax():
    jcfg, params = jax_tiny_params(0)
    ref = jhf.to_state_dict(params, jcfg)
    out = hf.to_state_dict(from_jax_params(params), torch_cfg_like(jcfg))
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == torch.float32 and out[k].is_contiguous(), k
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    # the tied copies of shared are one tensor; none aliases a parameter
    assert out["lm_head.weight"] is out["shared.weight"]


def test_pth_and_safetensors_round_trips(tmp_path):
    jcfg, params = jax_tiny_params(1)
    tcfg = torch_cfg_like(jcfg)
    tp = from_jax_params(params)
    pth = str(tmp_path / "model.pth")
    hf.save_reference_pth(tp, pth, tcfg)
    _assert_trees_equal(hf.load_reference_pth(pth, tcfg), params)
    # the reference's {"model": state_dict} wrapping, as JAX reads it
    torch.save({"model": torch.load(pth), "epoch": 3},
               str(tmp_path / "wrapped.pth"))
    _assert_trees_equal(
        hf.load_reference_pth(str(tmp_path / "wrapped.pth"), tcfg),
        jhf.load_reference_pth(str(tmp_path / "wrapped.pth"), jcfg))
    st = str(tmp_path / "model.safetensors")
    sd = hf.to_state_dict(tp, tcfg)
    hf.write_safetensors(sd, st)
    back = hf.read_safetensors(st)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    mixed = {"bf16": torch.randn(3, 5).to(torch.bfloat16),
             "i32": torch.arange(7, dtype=torch.int32),
             "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    hf.write_safetensors(mixed, st)
    back = hf.read_safetensors(st)
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with open(st, "rb") as f:     # header padded to 8 bytes
        assert int.from_bytes(f.read(8), "little") % 8 == 0


def test_safetensors_package_reads_our_file(tmp_path):
    safetensors = pytest.importorskip("safetensors.torch")
    jcfg, params = jax_tiny_params(2)
    sd = hf.to_state_dict(from_jax_params(params), torch_cfg_like(jcfg))
    st = str(tmp_path / "model.safetensors")
    hf.write_safetensors(sd, st)
    theirs = safetensors.load_file(st)
    assert theirs.keys() == sd.keys()
    assert all(torch.equal(theirs[k], sd[k]) for k in sd)


@pytest.mark.parametrize("safe", [True, False])
def test_load_t5_base_reads_a_save_pretrained_dir(hf_model, tmp_path, safe):
    jcfg, tcfg = _cfg(128)
    d = str(tmp_path / "t5")
    hf_model.save_pretrained(d, safe_serialization=safe)
    assert os.path.exists(os.path.join(
        d, "model.safetensors" if safe else "pytorch_model.bin"))
    _assert_trees_equal(hf.load_t5_base(tcfg, d), jhf.load_t5_base(jcfg, d))


def test_load_t5_base_reads_the_hf_cache_and_never_fetches(
        hf_model, tmp_path, monkeypatch):
    jcfg, tcfg = _cfg(128)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    with pytest.raises(FileNotFoundError, match="models--org--t5-tiny"):
        hf.load_t5_base(tcfg, "org/t5-tiny")
    snap = tmp_path / "hf" / "hub" / "models--org--t5-tiny" / "snapshots" \
        / "abc123"
    hf_model.save_pretrained(str(snap))
    _assert_trees_equal(hf.load_t5_base(tcfg, "org/t5-tiny"),
                        jhf.load_t5_base(jcfg, str(snap)))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf.load_t5_base(tcfg, str(empty))


def test_export_pth_equals_the_jax_cli(tmp_path, capsys):
    from vqacl_tpu.cli import export_pth as jexport
    from vqacl_tpu_torch.cli import export_pth
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.train.checkpoint import save_checkpoint

    jcfg, params = jax_tiny_params(3)
    proto = ProtoState.create(10, 80, jcfg.d_model, device="cpu")
    proto = proto._replace(q_proto=torch.ones_like(proto.q_proto))
    ck = str(tmp_path / "q_recognition_LAST")
    save_checkpoint(ck, from_jax_params(params), proto, step=5)
    export_pth.main([ck + ".npz", str(tmp_path / "port.pth")])
    port_out = capsys.readouterr().out
    jexport.main([ck + ".npz", str(tmp_path / "jax.pth")])
    jax_out = capsys.readouterr().out
    assert port_out == jax_out.replace(str(tmp_path / "jax.pth"),
                                       str(tmp_path / "port.pth"))
    assert "NOT carried into the .pth" in port_out
    a = torch.load(str(tmp_path / "port.pth"))
    b = torch.load(str(tmp_path / "jax.pth"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
