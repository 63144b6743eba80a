"""The port's extraction entry points and small utilities against the
JAX package's.

``vqacl_tpu_torch.cli.extract_features`` (h5, ``--pack``, given boxes)
and ``cli.extract_video_features`` run beside the JAX CLIs on the same
tiny images and videos: first with the model calls stubbed exactly as
``tests/test_extract_cli.py`` stubs them (the CLI glue: enumeration,
given-box padding and scaling, output formats, flag plumbing), then for
real with one ``--weights`` npz at reduced depth
(``torch_parity.patch_small_stages`` monkeypatches both packages' stage
tables; the resize target is cut to 64 px, as the JAX package's own
end-to-end test cuts it). Also ``validate_features.match_and_score``,
``vision.datasets.enumerate_dataset`` for the five datasets,
``vision.visualize.draw_boxes``, ``utils.profiling`` and
``utils.backbones``. Features at rtol 1e-4 (f32, another summation
order); ids, boxes given by the caller, enumeration and stub outputs
exactly equal.
"""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_extract_cli import _fake_record  # noqa: E402
from torch_parity import patch_small_stages, small_detector  # noqa: E402
from vqacl_tpu.cli import extract_features as JE  # noqa: E402
from vqacl_tpu.cli import extract_video_features as JEV  # noqa: E402
from vqacl_tpu.vision import frcnn as JF  # noqa: E402
from vqacl_tpu.vision import video as JV  # noqa: E402
from vqacl_tpu_torch.cli import extract_features as PE  # noqa: E402
from vqacl_tpu_torch.cli import extract_video_features as PEV  # noqa: E402
from vqacl_tpu_torch.vision import frcnn as PF  # noqa: E402
from vqacl_tpu_torch.vision import video as PV  # noqa: E402
from vqacl_tpu_torch.vision.convert_weights import save_npz_params  # noqa: E402

CPU = ["--platform", "cpu"]


@pytest.fixture
def image_dir(tmp_path):
    from PIL import Image
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in ("COCO_val2014_000000000001.jpg", "im2.png"):
        arr = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / name)
    (d / "notes.txt").write_text("ignored: not an image")
    return str(d)


@pytest.fixture
def stubs(monkeypatch):
    """Both packages' model entry points stubbed alike; the calls each
    package makes are recorded."""
    calls = {"jax": {"image": [], "boxes": []},
             "port": {"image": [], "boxes": []}}
    for name, mod in (("jax", JF), ("port", PF)):
        rec = calls[name]
        monkeypatch.setattr(mod, "init_frcnn",
                            lambda *a, **k: {"stub": True})

        def fake_image(params, bgr, n_boxes=36, rec=rec):
            assert params == {"stub": True}
            rec["image"].append(bgr.shape)
            return _fake_record(str(bgr.shape), *bgr.shape[:2], n_boxes)

        def fake_boxes(params, img, boxes, rec=rec):
            rec["boxes"].append(np.asarray(boxes))
            n = len(boxes)
            return (np.zeros((n, 2048), np.float32),
                    np.zeros((n,), np.int64), np.ones((n,), np.float32))

        monkeypatch.setattr(mod, "extract_image", fake_image)
        monkeypatch.setattr(mod, "extract_given_boxes", fake_boxes)
    return calls


def h5_dict(path):
    import h5py
    with h5py.File(path) as f:
        return {k: {d: np.asarray(f[k][d]) for d in f[k]} for k in f}


def assert_h5_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert sorted(a[k]) == sorted(b[k]), k
        for d in a[k]:
            np.testing.assert_array_equal(a[k][d], b[k][d], err_msg=f"{k}/{d}")


def test_extract_cli_h5_equals_jax(image_dir, stubs, tmp_path):
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    PE.main(["--images", image_dir, "--out", ours] + CPU)
    JE.main(["--images", image_dir, "--out", ref])
    assert stubs["port"]["image"] == stubs["jax"]["image"]
    assert len(stubs["port"]["image"]) == 2
    assert_h5_equal(h5_dict(ours), h5_dict(ref))


def test_extract_cli_given_boxes_equals_jax(image_dir, stubs, tmp_path):
    """--boxes_json: only listed images, short lists padded by repeating
    the last row, boxes scaled by the resize on their way to the model,
    the originals in the file."""
    boxes_json = str(tmp_path / "boxes.json")
    with open(boxes_json, "w") as f:
        json.dump({"im2": [[0.0, 0.0, 16.0, 12.0], [4.0, 4.0, 20.0, 20.0]]},
                  f)
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    PE.main(["--images", image_dir, "--out", ours, "--boxes_json",
             boxes_json] + CPU)
    JE.main(["--images", image_dir, "--out", ref, "--boxes_json",
             boxes_json])
    sent, want = stubs["port"]["boxes"], stubs["jax"]["boxes"]
    assert len(sent) == len(want) == 1 and sent[0].shape == (36, 4)
    np.testing.assert_array_equal(sent[0], want[0])
    a, b = h5_dict(ours), h5_dict(ref)
    assert list(a) == ["im2"]
    assert_h5_equal(a, b)


def test_extract_cli_pack_equals_jax(image_dir, stubs, tmp_path):
    from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
    ours, ref = str(tmp_path / "ours.vfpack"), str(tmp_path / "ref.vfpack")
    PE.main(["--images", image_dir, "--out", ours, "--pack"] + CPU)
    JE.main(["--images", image_dir, "--out", ref, "--pack"])
    a, b = PackedFeatureStore(ours), PackedFeatureStore(ref)
    try:
        assert a.n_images == b.n_images == 2 and a.n_boxes == 36
        for img_id in ("im2", "COCO_val2014_000000000001"):
            for x, y in zip(a.get(img_id), b.get(img_id)):
                np.testing.assert_array_equal(x, y)
    finally:
        a.close()
        b.close()


@pytest.fixture
def small_weights(tmp_path, monkeypatch):
    """One npz both packages load, at reduced depth and a 64-px resize."""
    patch_small_stages(monkeypatch)
    for m in (PF, JF):
        orig = m.resize_shortest_edge
        monkeypatch.setattr(
            m, "resize_shortest_edge",
            lambda img, short=64, max_size=128, orig=orig: orig(img, short,
                                                               max_size))
        monkeypatch.setattr(m, "PAD_BUCKETS", (64, 96, 128))
    p, _ = small_detector(5, cls_scale=0.01, obj_scale=100.0,
                          delta_scale=1e-3)
    path = str(tmp_path / "frcnn_small.npz")
    save_npz_params(path, p)
    return path


def _close(a, b, rtol=1e-4):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(b).max()


@pytest.mark.parametrize("mode", ["rpn", "given"])
def test_extract_cli_real_run_equals_jax(image_dir, small_weights, tmp_path,
                                         mode):
    """Unstubbed: both CLIs over the same images and weights, h5 out;
    with --boxes_json the given-box path."""
    extra = []
    if mode == "given":
        boxes_json = str(tmp_path / "boxes.json")
        with open(boxes_json, "w") as f:
            json.dump({"im2": [[0, 0, 16, 12], [4, 4, 20, 20]],
                       "COCO_val2014_000000000001": [[2, 2, 30, 22]]}, f)
        extra = ["--boxes_json", boxes_json]
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    PE.main(["--images", image_dir, "--out", ours, "--weights",
             small_weights, "--n_boxes", "8"] + extra + CPU)
    JE.main(["--images", image_dir, "--out", ref, "--weights",
             small_weights, "--n_boxes", "8"] + extra)
    a, b = h5_dict(ours), h5_dict(ref)
    assert sorted(a) == sorted(b) == ["COCO_val2014_000000000001", "im2"]
    for k in a:
        assert sorted(a[k]) == sorted(b[k])
        np.testing.assert_array_equal(a[k]["obj_id"], b[k]["obj_id"])
        for d in ("img_h", "img_w"):
            np.testing.assert_array_equal(a[k][d], b[k][d])
        for d in ("features", "boxes", "obj_conf"):
            _close(a[k][d], b[k][d])
        assert a[k]["features"].shape == (8, 2048)


def test_extract_video_cli_plumbing_equals_jax(tmp_path, monkeypatch):
    """Video CLI: the sources and arguments both CLIs hand
    extract_videos, with the extractor stubbed."""
    vids = tmp_path / "vids"
    vids.mkdir()
    np.save(vids / "vid001.npy", np.zeros((8, 16, 16, 3), np.uint8))
    (vids / "frames002").mkdir()
    (vids / "README").write_text("not a video")
    recs = {}
    for name, fr, vmod in (("jax", JF, JV), ("port", PF, PV)):
        monkeypatch.setattr(fr, "init_frcnn", lambda *a, **k: {"stub": True})

        def fake(params, sources, out_h5, side, verbose, motion_params,
                 motion_side, name=name):
            recs[name] = dict(params=params, sources=sources, out=out_h5,
                              side=side, verbose=verbose,
                              motion_params=motion_params,
                              motion_side=motion_side)

        monkeypatch.setattr(vmod, "extract_videos", fake)
    out = str(tmp_path / "app_mot_train.h5")
    argv = ["--videos", str(vids), "--out", out, "--side", "64",
            "--motion_side", "96"]
    PEV.main(argv + CPU)
    JEV.main(argv)
    assert recs["port"] == recs["jax"]
    assert sorted(recs["port"]["sources"]) == ["frames002", "vid001"]


def test_extract_video_cli_real_run_equals_jax(tmp_path, small_weights):
    vids = tmp_path / "vids"
    vids.mkdir()
    rng = np.random.default_rng(7)
    for i in range(2):
        np.save(vids / f"v{i}.npy",
                rng.integers(0, 255, (20, 32, 32, 3), dtype=np.uint8))
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    argv = ["--videos", str(vids), "--weights", small_weights, "--side",
            "32"]
    PEV.main(argv + ["--out", ours] + CPU)
    JEV.main(argv + ["--out", ref])
    import h5py
    with h5py.File(ours) as a, h5py.File(ref) as b:
        assert list(a["ids"][()]) == list(b["ids"][()]) == [b"v0", b"v1"]
        _close(a["feat"][()], b["feat"][()])
        assert a["feat"].shape == (2, 16, 4096)


def test_match_and_score_equals_jax():
    from vqacl_tpu.cli.validate_features import match_and_score as jms
    from vqacl_tpu_torch.cli.validate_features import match_and_score
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(8, 32)).astype(np.float32)
    boxes = rng.uniform(0, 50, (8, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] + 5
    ref_boxes = boxes + rng.normal(0, 2.0, boxes.shape).astype(np.float32)
    ref_feats = feats + rng.normal(0, 0.3, feats.shape).astype(np.float32)
    ours = {"features": feats, "boxes": boxes}
    a = match_and_score(ours, ref_feats, ref_boxes)
    b = jms(ours, ref_feats, ref_boxes)
    assert a["n_matched"] == b["n_matched"] > 0
    for k in ("mean_iou", "mean_feature_cosine"):
        assert abs(a[k] - b[k]) <= 1e-6
    same = match_and_score(ours, feats, boxes)
    assert same["n_matched"] == 8 and same["mean_iou"] > 0.999


def _dataset_root(root):
    """COCO (proposal + GT), Flickr30k, VCR, RefCOCOg and RefCOCOg-MAttNet
    layouts under one root."""
    from PIL import Image

    def img(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.new("RGB", (8, 6)).save(path)

    for i in (7, 3):
        img(f"{root}/images/val2014/COCO_val2014_{i:012d}.jpg")
    os.makedirs(f"{root}/annotations")
    with open(f"{root}/annotations/instances_val2014.json", "w") as f:
        json.dump({"annotations": [
            {"image_id": 3, "bbox": [1, 2, 10, 20]},
            {"image_id": 3, "bbox": [0, 0, 4, 4]},
            {"image_id": 7, "bbox": [5, 5, 1, 1]}]}, f)
    img(f"{root}/flickr30k_images/flickr30k_images/42.jpg")
    img(f"{root}/vcr1images/movie/0001.jpg")
    with open(f"{root}/vcr1images/movie/0001.json", "w") as f:
        json.dump({"boxes": [[1, 2, 3, 4, 0.9], [5, 6, 7, 8, 0.8]]}, f)
    row = {"img_id": "m-1", "img_fn": "movie/0001.jpg",
           "metadata_fn": "movie/0001.json"}
    with open(f"{root}/val.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in (row, row)))
    os.makedirs(f"{root}/refcocog")
    refs = [{"image_id": 419645, "split": "val",
             "file_name": "COCO_train2014_000000419645_398406.jpg"},
            {"image_id": 8, "split": "val",
             "file_name": "COCO_train2014_000000000008_12.jpg"},
            {"image_id": 5, "split": "train",
             "file_name": "COCO_train2014_000000000005_1.jpg"}]
    with open(f"{root}/refcocog/refs(umd).p", "wb") as f:
        pickle.dump(refs, f)
    with open(f"{root}/refcocog/instances.json", "w") as f:
        json.dump({"annotations": [
            {"image_id": 419645, "bbox": [10, 10, 5, 5]},
            {"image_id": 8, "bbox": [1, 1, 2, 2]}]}, f)
    os.makedirs(f"{root}/detections/refcocog_umd")
    with open(f"{root}/detections/refcocog_umd/"
              "res101_coco_minus_refer_notime_dets.json", "w") as f:
        json.dump([{"image_id": 419645, "box": [10, 20, 30, 40]},
                   {"image_id": 999, "box": [1, 1, 2, 2]}], f)


@pytest.mark.parametrize("name,gt", [
    ("coco", False), ("coco", True), ("flickr30k", False), ("vcr", False),
    ("vcr", True), ("refcocog", True), ("refcocog_mattnet", True)])
def test_enumerate_dataset_equals_jax(tmp_path, name, gt):
    from vqacl_tpu.vision.datasets import enumerate_dataset as jenum
    from vqacl_tpu_torch.vision.datasets import enumerate_dataset
    root = str(tmp_path)
    _dataset_root(root)
    kw = dict(gt=gt, coco_images_dir="/coco/train2014")
    ours = list(enumerate_dataset(name, root, None, **kw))
    ref = list(jenum(name, root, None, **kw))
    assert len(ours) == len(ref) > 0
    for (i, p, b), (ri, rp, rb) in zip(ours, ref):
        assert (i, p) == (ri, rp)
        assert (b is None) == (rb is None)
        if b is not None:
            np.testing.assert_array_equal(b, rb)
    with pytest.raises(ValueError):
        enumerate_dataset("refcocog", root, "val", gt=False,
                          coco_images_dir="/coco/train2014")


def test_draw_boxes(tmp_path):
    from vqacl_tpu_torch.vision.visualize import draw_boxes
    img = np.zeros((60, 80, 3), np.uint8)
    boxes = np.array([[5, 5, 30, 30], [40, 10, 70, 50]], np.float32)
    out = str(tmp_path / "viz.png")
    assert draw_boxes(img, boxes, labels=["cat", "dog"],
                      scores=np.array([0.9, 0.5]), out_path=out) is None
    assert os.path.getsize(out) > 0
    fig = draw_boxes(img, boxes)
    assert len(fig.axes[0].patches) == 2


def test_step_timer_equals_jax():
    from vqacl_tpu.utils.profiling import StepTimer as JT
    from vqacl_tpu_torch.utils.profiling import StepTimer
    t, j = StepTimer(sync_every=2), JT(sync_every=2)
    for _ in range(6):
        t.step(sync_value=torch.tensor(1.0))
        j.step(sync_value=np.float32(1.0))
    assert t.summary()["steps"] == j.summary()["steps"] == 6
    assert len(t.times) == len(j.times) == 3
    assert t.summary()["ms_per_step"] > 0.0
    assert StepTimer().summary()["ms_per_step"] == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    from vqacl_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_download_backbones_reports_local_files(tmp_path, monkeypatch):
    """Nothing is fetched: a missing backbone reports where to put one (as
    JAX's does offline), a local checkpoint directory is found."""
    from vqacl_tpu_torch.utils.backbones import download_backbones
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    status = download_backbones(("definitely-not-a-model-xyz",),
                                cache_dir=str(tmp_path))
    assert set(status) == {"definitely-not-a-model-xyz"}
    assert status["definitely-not-a-model-xyz"].startswith("unavailable")
    snap = tmp_path / "models--t5-base" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "model.safetensors").write_bytes(b"")
    local = tmp_path / "my_t5"
    local.mkdir()
    (local / "pytorch_model.bin").write_bytes(b"")
    status = download_backbones(("t5-base", str(local)),
                                cache_dir=str(tmp_path))
    assert status["t5-base"] == f"ok ({snap})"
    assert status[str(local)] == f"ok ({local})"
