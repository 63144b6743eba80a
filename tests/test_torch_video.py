"""The port's video feature extraction against the JAX package's.

``vqacl_tpu_torch.vision.video`` (frame and clip sampling, the frame
sources, ``_resize_square``, ``extract_videos`` with the RGB-difference
motion half and with the 3D ResNeXt, the app_mot h5) and
``vision.resnext3d`` (grouped ``F.conv3d``, ``maxpool3d``, the pooled
features, the checkpoint converter) on the same numpy inputs and
weights as ``vqacl_tpu.vision``. Both packages run at reduced depth
(``torch_parity.patch_small_stages``: the detector's stage tables and
``R3D101_STAGES`` monkeypatched to a few narrow blocks). Features in f32
at rtol 1e-4 of their largest magnitude (another summation order);
indices, shapes and frames exactly equal.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_resnext3d import _full_101_state_dict, _make_torch  # noqa: E402
from torch_parity import (SMALL_R3D, patch_small_stages,  # noqa: E402
                          small_detector, small_resnext3d)
from vqacl_tpu.vision import resnext3d as JX  # noqa: E402
from vqacl_tpu.vision import video as JV  # noqa: E402
from vqacl_tpu_torch.vision import resnext3d as PX  # noqa: E402
from vqacl_tpu_torch.vision import video as PV  # noqa: E402
from vqacl_tpu_torch.vision.convert_weights import to_jax_params  # noqa: E402

RTOL = 1e-4


def close(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), err


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("total,n", [(160, 16), (4, 16), (0, 16), (37, 5)])
def test_sample_indices_equal_jax(total, n):
    ours = PV.sample_indices(total, n)
    np.testing.assert_array_equal(ours, JV.sample_indices(total, n))
    assert ours.dtype == np.int64


def test_load_frames_and_clips_equal_jax(tmp_path):
    """From a .npy array and from a directory of frame images (PIL)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    clip = rng.integers(0, 255, size=(40, 12, 16, 3), dtype=np.uint8)
    np.save(tmp_path / "v1.npy", clip)
    fdir = tmp_path / "v2"
    os.makedirs(fdir)
    for i in range(20):
        Image.fromarray(clip[i]).save(fdir / f"f{i:03d}.png")
    for src in (str(tmp_path / "v1.npy"), str(fdir)):
        frames = PV.load_frames(src)
        np.testing.assert_array_equal(frames, JV.load_frames(src))
        assert frames.shape == (16, 12, 16, 3)
        clips = PV.load_clips(src, n_clips=4, clip_len=8)
        np.testing.assert_array_equal(
            clips, JV.load_clips(src, n_clips=4, clip_len=8))
        assert clips.shape == (4, 8, 12, 16, 3)
    assert PV.enumerate_video_sources(str(tmp_path)) == \
        JV.enumerate_video_sources(str(tmp_path))


def test_resize_square_equal_jax(monkeypatch):
    """Frames already side × side come back as f32 without PIL (blocked
    here), equal to JAX's PIL copy; another size goes through PIL's
    bilinear resize, equal to JAX's."""
    rng = np.random.default_rng(1)
    same = rng.integers(0, 255, size=(3, 32, 32, 3), dtype=np.uint8)
    other = rng.integers(0, 255, size=(3, 20, 28, 3), dtype=np.uint8)
    ref_same = JV._resize_square(same, 32)
    ref_other = JV._resize_square(other, 32)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        ours = PV._resize_square(same, 32)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref_same)
    np.testing.assert_array_equal(PV._resize_square(other, 32), ref_other)


def test_resnext3d_features_equal_jax(monkeypatch):
    """Stem, maxpool3d, grouped conv3d bottlenecks (projection and
    identity shortcuts) and the pooled features at reduced stages."""
    patch_small_stages(monkeypatch)
    p, jp = small_resnext3d(2)
    x = np.random.default_rng(2).normal(size=(2, 8, 16, 16, 3)).astype(
        np.float32) * 50
    ref = JX.resnext3d_features(jtree(jp), jnp.asarray(x))
    ours = PX.resnext3d_features(p, torch.from_numpy(
        x.transpose(0, 4, 1, 2, 3).copy()))
    assert ours.shape == (2, 128)
    close(ours, ref)
    # maxpool3d alone at odd and even sizes: exact
    y = np.random.default_rng(3).normal(size=(1, 5, 7, 6, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(
        PX.maxpool3d(torch.from_numpy(y.transpose(0, 4, 1, 2, 3).copy()))
        .numpy().transpose(0, 2, 3, 4, 1),
        np.asarray(JX.maxpool3d(jnp.asarray(y))))


def test_from_torch_state_dict_equals_jax(tmp_path):
    """A state dict of the published layout (module. prefixes, fc.*,
    num_batches_tracked): the same folded tree as JAX's converter, and
    the same features as the torch module it came from; the checkpoint
    file loads; leftovers raise."""
    net = _make_torch(SMALL_R3D, seed=1)
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    ours = PX.from_torch_state_dict(sd, stages=SMALL_R3D)
    ref = JX.from_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                   stages=SMALL_R3D)
    got = to_jax_params(ours)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v  # noqa
                      in jax.tree_util.tree_flatten_with_path(t)[0]}
    g, r = flat(got), flat(ref)
    assert set(g) == set(r)
    for k in r:
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 3, 8, 16, 16)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
    close(PX.resnext3d_features(ours, x, SMALL_R3D), want)
    path = str(tmp_path / "resnext-101-kinetics.pth")
    torch.save({"state_dict": net.state_dict(), "epoch": 1}, path)
    loaded = PX.load_torch_checkpoint(path, stages=SMALL_R3D)
    close(PX.resnext3d_features(loaded, x, SMALL_R3D), want)
    bad = dict(sd, **{"module.layer9.0.conv1.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unconsumed"):
        PX.from_torch_state_dict(bad, stages=SMALL_R3D)


def test_full_101_converter_layout():
    """The full 3/4/23/3 layout converts with every entry consumed, into
    OIDHW kernels (groups from the kernel's shape)."""
    p = PX.from_torch_state_dict(_full_101_state_dict())
    assert tuple(p["stem"]["w"].shape) == (64, 3, 7, 7, 7)
    st2 = p["stage_2"]
    assert len(st2) == 23
    assert tuple(st2["block_0"]["conv2"]["w"].shape) == (512, 16, 3, 3, 3)
    assert tuple(st2["block_0"]["shortcut"]["w"].shape) == (1024, 512, 1, 1,
                                                            1)
    assert "shortcut" not in st2["block_1"]
    assert PX.preprocess_clip(np.full((1, 2, 2, 3), 128, np.uint8)).dtype \
        == np.float32
    np.testing.assert_array_equal(
        PX.preprocess_clip(np.full((1, 2, 2, 3), 128, np.uint8)),
        JX.preprocess_clip(np.full((1, 2, 2, 3), 128, np.uint8)))


@pytest.mark.parametrize("motion", ["rgb_diff", "resnext3d"])
def test_extract_videos_equal_jax(tmp_path, monkeypatch, motion):
    """extract_videos over .npy videos (a moving and a static one) into
    the app_mot h5: the RGB-difference motion half (frame 0 against
    frame T−1) or the 3D ResNeXt over 16 consecutive-frame clips."""
    patch_small_stages(monkeypatch)
    rng = np.random.default_rng(5)
    moving = rng.integers(0, 255, size=(24, 32, 32, 3), dtype=np.uint8)
    np.save(tmp_path / "vid_mov.npy", moving)
    np.save(tmp_path / "vid_sta.npy", np.tile(moving[:1], (24, 1, 1, 1)))
    p, jp = small_detector(4)
    kw, jkw = {}, {}
    if motion == "resnext3d":
        mp, jmp = small_resnext3d(5)
        kw = dict(motion_params=mp, motion_stages=SMALL_R3D, motion_side=16)
        jkw = dict(motion_params=jtree(jmp), motion_stages=SMALL_R3D,
                   motion_side=16)
    sources = PV.enumerate_video_sources(str(tmp_path))
    # the h5 holds [appearance 2048 ‖ motion 2048]: the reduced 3D
    # ResNeXt's 128-d motion half is compared as a table only
    h5 = motion == "rgb_diff"
    out, ref_out = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    ours = PV.extract_videos(p, sources, out_h5=out if h5 else None, side=32,
                             **kw)
    ref = JV.extract_videos(jtree(jp), sources,
                            out_h5=ref_out if h5 else None, side=32, **jkw)
    width = 2048 + (128 if motion == "resnext3d" else 2048)
    assert sorted(ours) == sorted(ref) == ["vid_mov", "vid_sta"]
    for vid in ours:
        assert ours[vid].shape == (16, width) and ours[vid].dtype == \
            np.float32
        close(ours[vid][:, :2048], ref[vid][:, :2048])
        close(ours[vid][:, 2048:], ref[vid][:, 2048:])
    if not h5:
        return
    import h5py
    with h5py.File(out) as a, h5py.File(ref_out) as b:
        assert list(a["ids"][()]) == list(b["ids"][()])
        np.testing.assert_array_equal(a["feat"][()][0], ours["vid_mov"])
