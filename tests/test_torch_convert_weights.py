"""The port's detector weight conversion against the JAX package's.

``vqacl_tpu_torch.vision.convert_weights``: ``from_caffe2_dict`` on a
synthetic checkpoint with detectron2's caffe2 naming and full R-101-C4
shapes (``test_convert_weights.synthetic_caffe2_sd``) gives, through the
bridge ``to_jax_params``, exactly the JAX package's tree, with every blob
consumed; ``fold_bn`` folds as JAX's does; an ``.npz`` written by either
package reads back in the other bit for bit; and
``from_jax_params``/``to_jax_params`` round-trip every key and value,
4-D (HWIO ↔ OIHW) and 5-D (DHWIO ↔ OIDHW) kernels included.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_convert_weights import _flat, synthetic_caffe2_sd  # noqa: E402
from torch_parity import (patch_small_stages, small_detector,  # noqa: E402
                          small_resnext3d)
from vqacl_tpu.vision import convert_weights as JC  # noqa: E402
from vqacl_tpu.vision import resnet as JRN  # noqa: E402
from vqacl_tpu_torch.vision import convert_weights as PC  # noqa: E402
from vqacl_tpu_torch.vision import resnet as PRN  # noqa: E402


def assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (set(g) ^ set(w))
    for k in w:
        assert np.asarray(g[k]).shape == np.asarray(w[k]).shape, k
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


def test_from_caffe2_dict_equals_jax_and_consumes_every_blob():
    sd = synthetic_caffe2_sd(unique_fill=True)
    ours = PC.from_caffe2_dict(sd)
    # the port's layout: caffe2's OIHW kept, linear weights [in, out]
    assert tuple(ours["backbone"]["stem"]["w"].shape) == (64, 3, 7, 7)
    assert tuple(ours["rpn"]["obj_w"].shape) == (15, 1024, 1, 1)
    assert tuple(ours["heads"]["cls_w"].shape) == (2048, 1601)
    assert_trees_equal(PC.to_jax_params(ours), JC.from_caffe2_dict(sd))
    leaf_values = set()
    for v in _flat(ours).values():
        leaf_values.update(torch.unique(v).tolist())
    for name, blob in sd.items():
        assert float(blob.flat[0]) in leaf_values, f"{name} never consumed"


def test_fold_bn_equals_jax():
    rng = np.random.default_rng(2)
    g, b = rng.normal(size=8), rng.normal(size=8)
    mu, var = rng.normal(size=8), rng.uniform(0.5, 2.0, 8)
    for eps in (1e-5, 1e-3):
        ours = PC.fold_bn(g, b, mu, var, eps=eps)
        ref = JC.fold_bn(g, b, mu, var, eps=eps)
        for o, r in zip(ours, ref):
            assert o.dtype == r.dtype == np.float32
            np.testing.assert_array_equal(o, r)
    # raw-BN-stat checkpoints fold inside _conv_bn, as in JAX
    sd = {"c_w": rng.normal(size=(8, 2, 1, 1)).astype(np.float32),
          "c_bn_gamma": g, "c_bn_beta": b,
          "c_bn_running_mean": mu, "c_bn_running_var": var}
    assert_trees_equal(PC.to_jax_params(PC._conv_bn(sd, "c")),
                       JC._conv_bn(sd, "c"))


def test_converted_conv_equals_jax_conv():
    """A caffe2 conv blob through each package's converter and conv_bn:
    the same activations (f32, rtol 1e-5)."""
    rng = np.random.default_rng(1)
    sd = {"conv1_w": rng.normal(size=(4, 3, 7, 7)).astype(np.float32),
          "conv1_bn_s": rng.normal(size=(4,)).astype(np.float32),
          "conv1_bn_b": rng.normal(size=(4,)).astype(np.float32)}
    x = rng.normal(size=(1, 12, 10, 3)).astype(np.float32)
    ref = np.asarray(JRN.conv_bn(jax.tree.map(jnp.asarray,
                                              JC._conv_bn(sd, "conv1")),
                                 jnp.asarray(x), stride=2))
    ours = PRN.conv_bn(PC._conv_bn(sd, "conv1"),
                       torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                       stride=2).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_npz_read_across_packages(tmp_path, monkeypatch):
    """The .npz keeps JAX's flat keys and HWIO: a file written by either
    package loads in the other, bit for bit."""
    patch_small_stages(monkeypatch)
    p, jp = small_detector(3)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JC.save_npz_params(j_path, jp)
    PC.save_npz_params(p_path, p)
    assert sorted(np.load(j_path).files) == sorted(np.load(p_path).files)
    assert_trees_equal(PC.to_jax_params(PC.load_npz_params(j_path)), jp)
    assert_trees_equal(JC.load_npz_params(p_path), jp)
    back = PC.load_npz_params(p_path)
    assert_trees_equal(back, p)


def test_bridge_round_trip_2d_and_3d():
    """from_jax_params ∘ to_jax_params is the identity on the port's
    trees (detector and 3D ResNeXt), every key kept; 4-D kernels move
    HWIO ↔ OIHW and 5-D DHWIO ↔ OIDHW."""
    rng = np.random.default_rng(4)
    det = {"backbone": {"stem": {
        "w": torch.from_numpy(rng.normal(size=(6, 3, 7, 5)).astype(
            np.float32)), "scale": torch.ones(6), "bias": torch.zeros(6)}},
        "heads": {"cls_w": torch.from_numpy(rng.normal(size=(8, 5)).astype(
            np.float32))}}
    j = PC.to_jax_params(det)
    assert j["backbone"]["stem"]["w"].shape == (7, 5, 3, 6)    # HWIO
    assert j["heads"]["cls_w"].shape == (8, 5)                 # unchanged
    assert_trees_equal(PC.from_jax_params(j), det)
    r3, j3 = small_resnext3d(0)
    w = r3["stage_1"]["block_0"]["conv2"]["w"]                 # grouped
    assert tuple(w.shape) == (64, 2, 3, 3, 3)                  # OIDHW
    assert j3["stage_1"]["block_0"]["conv2"]["w"].shape == (3, 3, 3, 2, 64)
    assert_trees_equal(PC.from_jax_params(j3), r3)


def test_load_caffe2_pkl_equals_jax(tmp_path):
    """The detectron2 pkl container ({'blobs': {...}} with non-array
    entries skipped) → the same tree as JAX's loader."""
    sd = synthetic_caffe2_sd(unique_fill=True)
    path = str(tmp_path / "vg.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": {**sd, "__meta__": "caffe2", "lr": 0.01}}, f)
    assert_trees_equal(PC.to_jax_params(PC.load_caffe2_pkl(path)),
                       JC.load_caffe2_pkl(path))
