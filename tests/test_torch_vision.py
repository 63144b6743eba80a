"""The port's detector (``vqacl_tpu_torch.vision``: resnet, rpn, frcnn)
against the JAX package's on the same numpy inputs and weights.

The weights come from the port's seeded init and reach JAX through
``convert_weights.to_jax_params`` (OIHW → HWIO, every key kept). The
backbone runs at reduced depth: ``torch_parity.patch_small_stages``
monkeypatches both packages' ``R101_STAGES``/``RES5`` to one narrow
bottleneck per stage, with C4 at 1024 and res5 at 2048 so the RPN and
the heads keep their widths. Tolerances: f32 activations at rtol 1e-4
(the same convolutions summed in another order), integer outputs
(indices, class ids, keep masks) and the host resize/pad exactly equal.
``select_proposals`` is held bit-equal on identical inputs; the whole
``_extract_regions_impl`` runs with the RPN objectness drawn larger,
its deltas and the class head smaller, so that its proposals lie on the
image and its scores lie far apart: its selections do not hang on f32
noise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import patch_small_stages, small_detector  # noqa: E402
from vqacl_tpu.vision import frcnn as JF  # noqa: E402
from vqacl_tpu.vision import resnet as JRN  # noqa: E402
from vqacl_tpu.vision import rpn as JRPN  # noqa: E402
from vqacl_tpu_torch.vision import frcnn as PF  # noqa: E402
from vqacl_tpu_torch.vision import resnet as PRN  # noqa: E402
from vqacl_tpu_torch.vision import rpn as PRPN  # noqa: E402
from vqacl_tpu_torch.vision.convert_weights import (from_jax_params,  # noqa: E402
                                                    to_jax_params)

RTOL = 1e-4


def close(ours, ref, rtol=RTOL):
    """max |ours - ref| <= rtol * max |ref| (f32, another summation
    order)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rtol * scale, (err, scale)


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture
def small(monkeypatch):
    patch_small_stages(monkeypatch)
    return small_detector(0)


def test_init_tree_matches_jax_init(small):
    """init_frcnn's tree has JAX init's keys and (after the bridge)
    shapes, at the patched stages."""
    _, jp = small
    shapes = jax.eval_shape(lambda: JF.init_frcnn(jax.random.PRNGKey(0)))
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v
              in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_t = {jax.tree_util.keystr(k): v.shape for k, v
              in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat_t == flat_j


@pytest.mark.parametrize("k,stride,H,W", [
    (7, 2, 16, 20), (7, 2, 15, 17), (3, 1, 9, 8), (3, 2, 9, 10),
    (1, 2, 7, 8), (1, 1, 5, 5)])
def test_conv_bn_equals_jax(k, stride, H, W):
    """"SAME" at stride 1 and 2 on odd and even sizes (XLA pads 2 before
    and 3 after for the 7×7/2 stem on an even size)."""
    rng = np.random.default_rng(k * 100 + H)
    cin, cout = 3, 5
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    p = {"w": w, "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
         "bias": rng.normal(size=cout).astype(np.float32)}
    x = rng.normal(size=(2, H, W, cin)).astype(np.float32)
    for relu in (True, False):
        ref = JRN.conv_bn(jtree(p), jnp.asarray(x), stride, relu=relu)
        ours = PRN.conv_bn(from_jax_params(p), nchw(x), stride, relu=relu)
        close(nhwc(ours), ref)


@pytest.mark.parametrize("H,W", [(7, 7), (8, 8), (9, 12), (10, 5)])
def test_caffe_maxpool_equals_jax(H, W):
    """Ceil mode: pads only bottom and right, with -inf (exact)."""
    x = np.random.default_rng(H * W).normal(size=(2, H, W, 3)).astype(
        np.float32) - 5.0
    ref = np.asarray(JRN.caffe_maxpool(jnp.asarray(x)))
    ours = nhwc(PRN.caffe_maxpool(nchw(x)))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("cin,cout,stride", [(16, 32, 2), (32, 32, 1),
                                             (16, 32, 1)])
def test_bottleneck_equals_jax(cin, cout, stride):
    """Stride on the 1×1 (stride_in_1x1), projection or identity
    shortcut."""
    g = torch.Generator().manual_seed(cin + cout + stride)
    p = PRN.init_bottleneck(g, cin, cout, 8)
    x = np.random.default_rng(1).normal(size=(2, 9, 10, cin)).astype(
        np.float32)
    if "shortcut" not in p and stride > 1:
        pytest.skip("identity shortcut has stride 1")
    ref = JRN.bottleneck(jtree(to_jax_params(p)), jnp.asarray(x), stride)
    close(nhwc(PRN.bottleneck(p, nchw(x), stride)), ref)


def test_backbone_and_res5_equal_jax(small):
    p, jp = small
    x = np.random.default_rng(2).uniform(-100, 100, (1, 70, 94, 3)).astype(
        np.float32)
    ref = JRN.backbone_c4(jtree(jp["backbone"]), jnp.asarray(x))
    feat = PRN.backbone_c4(p["backbone"], nchw(x))
    assert feat.shape == (1, 1024, 5, 6)
    close(nhwc(feat), ref)
    roi = np.random.default_rng(3).normal(size=(3, 14, 14, 1024)).astype(
        np.float32)
    ref5 = JRN.res5_head(jtree(jp["backbone"]), jnp.asarray(roi))
    r5 = PRN.res5_head(p["backbone"], nchw(roi))
    assert r5.shape == (3, 2048, 7, 7)
    close(nhwc(r5), ref5)


def test_rpn_head_anchors_and_deltas_equal_jax(small):
    p, jp = small
    feat = np.random.default_rng(4).normal(size=(1, 3, 5, 1024)).astype(
        np.float32)
    lj, dj = JRPN.rpn_head(jtree(jp["rpn"]), jnp.asarray(feat))
    lt, dt = PRPN.rpn_head(p["rpn"], nchw(feat))
    assert lt.shape == (1, 3 * 5 * 15) and dt.shape == (1, 3 * 5 * 15, 4)
    close(lt, lj)
    close(dt, dj)
    a_ref = np.asarray(JRPN.anchor_grid(3, 5))
    np.testing.assert_array_equal(PRPN.anchor_grid(3, 5).numpy(), a_ref)
    deltas = np.random.default_rng(5).normal(size=(225, 4)).astype(
        np.float32)
    deltas[0, 2] = deltas[1, 3] = 50.0       # clamped at log(1000/16)
    ref = np.asarray(JRPN.decode_deltas(jnp.asarray(a_ref),
                                        jnp.asarray(deltas)))
    ours = PRPN.decode_deltas(torch.from_numpy(a_ref.copy()),
                              torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("n,pre,post,hw", [
    (500, 200, 50, (220.0, 220.0)),     # -inf ties from boxes off the image
    (240, 6000, 300, (90.0, 130.0)),    # k = 240 < 300: short output
    (3000, 2000, 300, (400.0, 300.0)),
])
def test_select_proposals_bit_equal(n, pre, post, hw):
    """Identical logits and decoded boxes → bit-equal proposals and
    validity, with many boxes that cannot be kept (score -inf, ranked by
    index as lax.top_k ranks ties) and k < post_nms_topk."""
    rng = np.random.default_rng(n)
    boxes = rng.uniform(-50, 450, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(-5, 80, (n, 2))
    logits = rng.normal(size=n).astype(np.float32)
    logits[::5] = logits[1]                    # finite ties too
    ref_p, ref_v = JRPN.select_proposals(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(hw, jnp.float32),
        pre_nms_topk=pre, post_nms_topk=post)
    ours_p, ours_v = PRPN.select_proposals(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        torch.tensor(hw, dtype=torch.float32), pre_nms_topk=pre,
        post_nms_topk=post)
    assert ours_p.shape == (min(post, pre, n), 4)
    np.testing.assert_array_equal(ours_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(ours_v.numpy(), np.asarray(ref_v))
    assert ours_v.any()
    # boxes entirely off the image clip to zero width: score -inf
    off = (np.minimum(boxes[:, 2], hw[1]) <= np.maximum(boxes[:, 0], 0)) \
        | (np.minimum(boxes[:, 3], hw[0]) <= np.maximum(boxes[:, 1], 0))
    assert off.sum() > 10


def _regions_equal(ours, ref):
    ours = {k: v.numpy() for k, v in ours._asdict().items()}
    for k in ("obj_id", "attr_id", "valid"):
        np.testing.assert_array_equal(ours[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    for k in ("features", "boxes", "obj_conf", "attr_conf"):
        close(ours[k], getattr(ref, k))


def test_extract_regions_equals_jax(monkeypatch):
    """The whole ``_extract_regions_impl`` (backbone → RPN with N1's
    plain path → RoIAlign → res5 → heads → the 36-box sweep) on a
    padded image with a smaller true size: the same boxes, classes,
    attributes and validity, features within tolerance."""
    patch_small_stages(monkeypatch)
    p, jp = small_detector(1, cls_scale=0.01, obj_scale=100.0,
                           delta_scale=1e-3)
    rng = np.random.default_rng(6)
    img = np.zeros((96, 128, 3), np.float32)
    img[:80, :112] = rng.uniform(0, 255, (80, 112, 3))
    hw = np.asarray([80.0, 112.0], np.float32)
    ref = JF._extract_regions_impl(jtree(jp), jnp.asarray(img),
                                   jnp.asarray(hw), n_boxes=10,
                                   n_proposals=40)
    stages = []
    ours = PF._extract_regions_impl(p, torch.from_numpy(img),
                                    torch.from_numpy(hw), n_boxes=10,
                                    n_proposals=40, mark=stages.append)
    assert stages == ["start", "backbone", "rpn", "roi_align", "res5_heads",
                      "nms36", "attr"]
    assert ours.features.shape == (10, 2048)
    # valid boxes whose scores lie far apart (relative gaps ≫ f32 noise)
    conf = np.sort(ours.obj_conf.numpy())
    assert ours.valid.all() and np.diff(conf).min() > 1e-5 * conf.max()
    _regions_equal(ours, ref)
    # the batch path: the backbone once over two images, the same tail
    imgs = np.stack([img, img[::-1].copy()])
    hws = np.stack([hw, np.asarray([96.0, 128.0], np.float32)])
    batch = PF.extract_regions_batch(p, torch.from_numpy(imgs),
                                     torch.from_numpy(hws), n_boxes=10,
                                     n_proposals=40)
    assert batch.features.shape == (2, 10, 2048)
    single = PF.extract_regions(p, torch.from_numpy(imgs[1]),
                                torch.from_numpy(hws[1]), n_boxes=10,
                                n_proposals=40)
    for k in ("obj_id", "valid"):
        assert torch.equal(getattr(batch, k)[1], getattr(single, k))
    close(batch.features[0], ours.features)
    close(batch.features[1], single.features)


def test_extract_given_boxes_equals_jax(small):
    p, jp = small
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (64, 80, 3)).astype(np.float32)
    boxes = np.asarray([[0, 0, 40, 30], [10, 5, 79, 63], [20, 20, 21, 21]],
                       np.float32)
    fj, ij, cj = JF.extract_given_boxes(jtree(jp), jnp.asarray(img),
                                        jnp.asarray(boxes))
    ft, it, ct = PF.extract_given_boxes(p, torch.from_numpy(img),
                                        torch.from_numpy(boxes))
    close(ft, fj)
    close(ct, cj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("h,w", [(24, 32), (480, 640), (375, 500),
                                 (1200, 300)])
def test_resize_and_pad_bit_equal(h, w):
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3)).astype(
        np.float32)
    r_ours, s_ours = PF.resize_shortest_edge(img)
    r_ref, s_ref = JF.resize_shortest_edge(img)
    assert s_ours == s_ref
    np.testing.assert_array_equal(r_ours, r_ref)
    np.testing.assert_array_equal(PF.pad_to_bucket(r_ours),
                                  JF.pad_to_bucket(r_ref))
    assert PF.PAD_BUCKETS == JF.PAD_BUCKETS


def test_extract_image_record_equals_jax(monkeypatch):
    """The host pipeline (resize, pad, device, rescale to original
    pixels) at a small resize target: the reference record schema,
    equal to JAX's."""
    patch_small_stages(monkeypatch)
    for m in (PF, JF):
        orig = m.resize_shortest_edge
        monkeypatch.setattr(
            m, "resize_shortest_edge",
            lambda img, short=64, max_size=128, orig=orig: orig(img, short,
                                                               max_size))
        monkeypatch.setattr(m, "PAD_BUCKETS", (64, 96, 128))
    p, jp = small_detector(2, cls_scale=0.01, obj_scale=100.0,
                           delta_scale=1e-3)
    bgr = np.random.default_rng(8).integers(0, 256, (50, 70, 3)).astype(
        np.uint8)
    ours = PF.extract_image(p, bgr, n_boxes=12)
    ref = JF.extract_image(jtree(jp), bgr, n_boxes=12)
    assert set(ours) == set(ref)
    for k in ("obj_id", "attr_id"):
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype
    for k in ("features", "boxes", "obj_conf", "attr_conf"):
        close(ours[k], ref[k])
    assert (ours["img_h"], ours["img_w"]) == (50, 70)
    assert ours["boxes"][:, (0, 2)].max() <= 70
