"""The port's NMS and RoI ops against the JAX package's.

``vqacl_tpu_torch.ops.nms`` (``box_iou``, ``nms_mask``,
``max_nms_fixed`` and the N1 wrapper ``greedy_nms``) and
``ops.roi_align`` (``roi_align``, ``roi_pool``) on the same numpy inputs
as ``vqacl_tpu.ops``: indices and keep masks exactly equal, IoU and
RoI features at atol 1e-5 in f32 (the same arithmetic in another
library; the IoUs here come out bit-equal). On CPU tensors ``greedy_nms``
takes its plain loop; it is held against JAX's ``lax.scan`` sweep and
against its own contract, and its argument checks raise before any
launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.ops import nms as J  # noqa: E402
from vqacl_tpu.ops import roi_align as JR  # noqa: E402
from vqacl_tpu.vision import rpn as JRPN  # noqa: E402
from vqacl_tpu_torch.ops import nms as P  # noqa: E402
from vqacl_tpu_torch.ops import roi_align as PR  # noqa: E402

ATOL = 1e-5


def random_boxes(rng, n, size=100.0):
    x1y1 = rng.uniform(0, size * 0.7, size=(n, 2))
    wh = rng.uniform(1, size * 0.3, size=(n, 2))
    return np.concatenate([x1y1, x1y1 + wh], axis=1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_box_iou_equals_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 40), random_boxes(rng, 25)
    b[3] = b[3, [2, 3, 0, 1]]            # an inverted box: area clipped to 0
    ours = P.box_iou(t(a), t(b)).numpy()
    ref = np.asarray(J.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    assert ours.dtype == np.float32 and ours.shape == (40, 25)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_mask_equals_jax(thresh):
    rng = np.random.default_rng(1)
    boxes = random_boxes(rng, 120)
    scores = rng.uniform(0, 1, 120).astype(np.float32)
    ours = P.nms_mask(t(boxes), t(scores), thresh).numpy()
    ref = np.asarray(J.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                thresh))
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.sum() < 120


@pytest.mark.parametrize("case", ["sweep", "scarce", "ties", "all_invalid",
                                  "fewer_than_keep"])
def test_max_nms_fixed_equals_jax(case):
    """The threshold sweep (first of 0.5..0.9 with ≥36 kept), the padding
    with the best suppressed boxes when even 0.9 keeps fewer, stable
    ties, all scores -1 (no valid proposal), and fewer boxes than
    n_keep: indices and valid flags exactly equal."""
    rng = np.random.default_rng(2)
    n_keep = 36
    if case == "sweep":
        boxes = random_boxes(rng, 300)
        scores = rng.uniform(0, 1, 300).astype(np.float32)
    elif case == "scarce":
        boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (10, 1))
        boxes[5:] += 3.0
        scores = np.linspace(0.1, 1.0, 10).astype(np.float32)
        n_keep = 4
    elif case == "ties":
        boxes = random_boxes(rng, 60, size=30.0)
        scores = np.full(60, 0.5, np.float32)
        scores[::7] = 0.75
    elif case == "all_invalid":
        boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (20, 1))
        scores = np.full(20, -1.0, np.float32)
        n_keep = 6
    else:
        boxes = random_boxes(rng, 20)
        scores = rng.uniform(0, 1, 20).astype(np.float32)
    idx, valid = P.max_nms_fixed(t(boxes), t(scores), n_keep=n_keep)
    ridx, rvalid = J.max_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                   n_keep=n_keep)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert idx.shape == (min(n_keep, len(boxes)),)
    if case == "scarce":
        assert 0 < int(valid.sum()) < n_keep


@pytest.mark.parametrize("N,thresholds,frac_valid", [
    (257, (0.7,), 0.8),                        # RPN-like: invalid rows
    (300, (0.5, 0.6, 0.7, 0.8, 0.9), 1.0),     # the 36-box sweep
    (64, (0.3, 0.7), 0.0),                     # nothing valid
    (1, (0.5,), 1.0),
])
def test_greedy_nms_plain_path_equals_jax_scan(N, thresholds, frac_valid):
    """N1's wrapper on CPU tensors (the plain loop) against the JAX
    package's scans: the sweep scan for all-valid inputs, the RPN's scan
    (validity = finite score) for the others; keep masks equal. Invalid
    rows come last, as the RPN's top-k ranks its -inf scores."""
    rng = np.random.default_rng(N)
    boxes = random_boxes(rng, N, size=60.0)
    valid = np.arange(N) < round(frac_valid * N)
    thr = np.asarray(thresholds, np.float32)
    before = P.greedy_nms.launches
    keep = P.greedy_nms(t(boxes), t(valid), t(thr)).numpy()
    assert P.greedy_nms.launches == before       # no kernel on the CPU
    assert keep.shape == (len(thresholds), N) and keep.dtype == bool
    if valid.all():
        # scores already in order: the sweep's argsort is the identity
        scores = np.linspace(1.0, 0.0, N).astype(np.float32)
        ref = np.asarray(J._nms_sweep_masks(jnp.asarray(boxes),
                                            jnp.asarray(scores),
                                            jnp.asarray(thr)))
        np.testing.assert_array_equal(keep, ref)
    for ti, th in enumerate(thresholds):
        # the RPN's scan: select_proposals with no clipping or top-k
        # reordering (sorted logits, -inf where invalid)
        logits = np.where(valid, np.linspace(5.0, 1.0, N), -np.inf
                          ).astype(np.float32)
        props, kept = JRPN.select_proposals(
            jnp.asarray(logits), jnp.asarray(boxes),
            jnp.asarray([1e4, 1e4], jnp.float32), pre_nms_topk=N,
            post_nms_topk=N, nms_thresh=float(th))
        order = np.argsort(~keep[ti], kind="stable")
        np.testing.assert_array_equal(np.asarray(kept), keep[ti][order])
        np.testing.assert_array_equal(np.asarray(props), boxes[order])


def test_greedy_nms_contract():
    """Box i kept iff valid and no earlier kept box has IoU > t."""
    rng = np.random.default_rng(5)
    boxes = random_boxes(rng, 90, size=40.0)
    valid = rng.uniform(size=90) < 0.9
    thr = np.asarray([0.4, 0.6], np.float32)
    keep = P.greedy_nms(t(boxes), t(valid), t(thr)).numpy()
    iou = P.box_iou(t(boxes), t(boxes)).numpy()
    for ti, th in enumerate(thr):
        for i in range(90):
            sup = any(keep[ti, j] and iou[j, i] > th for j in range(i))
            assert keep[ti, i] == (valid[i] and not sup)


@pytest.mark.parametrize("bad", ["n_zero", "n_big", "t_big", "dtype",
                                 "valid_dtype", "shape"])
def test_greedy_nms_validates_before_launch(bad):
    boxes = torch.zeros(8, 4)
    valid = torch.ones(8, dtype=torch.bool)
    thr = torch.tensor([0.5])
    if bad == "n_zero":
        boxes, valid = boxes[:0], valid[:0]
    elif bad == "n_big":
        boxes = torch.zeros(P.NMS_MAX_N + 1, 4)
        valid = torch.ones(P.NMS_MAX_N + 1, dtype=torch.bool)
    elif bad == "t_big":
        thr = torch.full((P.NMS_MAX_T + 1,), 0.5)
    elif bad == "dtype":
        boxes = boxes.double()
    elif bad == "valid_dtype":
        valid = valid.float()
    else:
        boxes = torch.zeros(8, 5)
    with pytest.raises(ValueError, match="greedy_nms"):
        P.greedy_nms(boxes, valid, thr)


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_equals_jax(aligned):
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(3, 16, 20)).astype(np.float32)
    rois = np.array([[1.0, 2.0, 15.0, 12.0],
                     [0.0, 0.0, 19.9, 15.9],
                     [5.5, 3.2, 9.7, 8.8],
                     [-6.0, -4.0, 3.0, 2.0],      # partly outside: zeros
                     [30.0, 30.0, 44.0, 40.0]], np.float32)
    ours = PR.roi_align(t(feat), t(rois), spatial_scale=0.5,
                        output_size=(7, 7), sampling_ratio=2,
                        aligned=aligned).numpy()
    ref = np.asarray(JR.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                  spatial_scale=0.5, output_size=(7, 7),
                                  sampling_ratio=2, aligned=aligned))
    assert ours.shape == (5, 3, 7, 7)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_roi_align_chunks_equal_one_pass(monkeypatch):
    """Chunking over RoIs (the extractor's 300 RoIs × 1024 channels) gives
    the same values as one pass."""
    rng = np.random.default_rng(4)
    feat = t(rng.normal(size=(8, 12, 12)).astype(np.float32))
    rois = t(random_boxes(rng, 11, size=180.0))
    whole = PR.roi_align(feat, rois, 1 / 16, (14, 14), 2, False)
    monkeypatch.setattr(PR, "CHUNK_BYTES", 3 * 8 * 28 * 28 * 4)
    chunked = PR.roi_align(feat, rois, 1 / 16, (14, 14), 2, False)
    assert torch.equal(whole, chunked)


def test_roi_pool_equals_jax():
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(4, 12, 14)).astype(np.float32)
    rois = np.array([[0.0, 0.0, 13.0, 11.0],
                     [2.0, 3.0, 10.0, 9.0],
                     [7.0, 7.0, 77.0, 7.4],       # exact 77/7 bin edges
                     [20.0, 20.0, 30.0, 30.0]],   # outside: empty bins
                    np.float32)
    for scale in (1.0, 0.5):
        ours = PR.roi_pool(t(feat), t(rois), spatial_scale=scale,
                           output_size=(7, 7)).numpy()
        ref = np.asarray(JR.roi_pool(jnp.asarray(feat), jnp.asarray(rois),
                                     spatial_scale=scale,
                                     output_size=(7, 7)))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
