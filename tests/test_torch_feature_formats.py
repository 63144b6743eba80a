"""The port's feature converters (``data/tsv_convert.py``,
``data/arrow_store.py``) against the JAX package's.

An LXMERT tsv (the public COCO features' layout: one image per line,
arrays in base64, a short detection too) is decoded alike by both
``load_obj_tsv`` (``topk`` too); ``tsv_to_h5`` and ``tsv_to_pack`` of
both packages write files that read back equal, group for group and
byte for byte; Arrow files written by either package read back equal in
the other (``pyarrow`` is optional in both); ``parse_img_id`` maps COCO
and VQA file names, bare ids and digit-free names (crc32) alike; and the
port's Arrow functions raise ImportError where there is no ``pyarrow``.
"""

import base64
import csv

import numpy as np
import pytest

from vqacl_tpu.data import arrow_store as JA
from vqacl_tpu.data import tsv_convert as JC
from vqacl_tpu_torch.data import arrow_store as TA
from vqacl_tpu_torch.data import tsv_convert as TC

N_BOXES, FEAT_DIM = 6, 8


def _records(n, seed=0, short=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 3 if i in short else N_BOXES
        xy = rng.uniform(0, 50, (k, 2)).astype(np.float32)
        out.append((f"COCO_val2014_{i + 1:012d}", {
            "features": rng.normal(size=(k, FEAT_DIM)).astype(np.float32),
            "boxes": np.concatenate([xy, xy + 10], axis=1),
            "img_h": 60 + i, "img_w": 80 + i,
            "obj_id": rng.integers(0, 1600, k),
            "obj_conf": rng.uniform(0, 1, k).astype(np.float32),
            "attr_id": rng.integers(0, 400, k),
            "attr_conf": rng.uniform(0, 1, k).astype(np.float32)}))
    return out


def _write_tsv(path, records):
    b64 = lambda a: base64.b64encode(np.ascontiguousarray(a).tobytes()
                                     ).decode()
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        for img_id, r in records:
            w.writerow([img_id, r["img_h"], r["img_w"],
                        b64(r["obj_id"].astype(np.int64)), b64(r["obj_conf"]),
                        b64(r["attr_id"].astype(np.int64)),
                        b64(r["attr_conf"]), r["features"].shape[0],
                        b64(r["boxes"]), b64(r["features"])])
    return str(path)


def test_load_obj_tsv_matches_jax(tmp_path):
    recs = _records(5, short=(2,))
    tsv = _write_tsv(tmp_path / "a.tsv", recs)
    for topk in (None, 3):
        got = list(TC.load_obj_tsv(tsv, topk))
        want = list(JC.load_obj_tsv(tsv, topk))
        assert len(got) == len(want) == (topk or 5)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert TC.FIELDNAMES == JC.FIELDNAMES
    first = next(TC.load_obj_tsv(tsv))
    np.testing.assert_array_equal(first["features"], recs[0][1]["features"])


def test_tsv_to_h5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    recs = _records(8, seed=1)
    tsvs = [_write_tsv(tmp_path / "a.tsv", recs[:4]),
            _write_tsv(tmp_path / "b.tsv", recs[4:])]
    paths = [str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")]
    assert TC.tsv_to_h5(tsvs, paths[0], topk=3) == \
        JC.tsv_to_h5(tsvs, paths[1], topk=3) == 6
    with h5py.File(paths[0]) as t, h5py.File(paths[1]) as j:
        assert sorted(t) == sorted(j) and len(t) == 6
        for img in j:
            assert sorted(t[img]) == sorted(j[img])
            for k in j[img]:
                a, b = t[img][k][()], j[img][k][()]
                assert np.asarray(a).dtype == np.asarray(b).dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_tsv_to_pack_matches_jax(tmp_path):
    from vqacl_tpu.data.packed_cache import PackedFeatureStore as JStore
    from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore as TStore

    recs = _records(5, seed=2)
    tsv = _write_tsv(tmp_path / "a.tsv", recs)
    paths = [str(tmp_path / "port.vfpack"), str(tmp_path / "jax.vfpack")]
    kw = dict(n_boxes=N_BOXES, feat_dim=FEAT_DIM)
    assert TC.tsv_to_pack([tsv], paths[0], **kw) == \
        JC.tsv_to_pack([tsv], paths[1], **kw) == 5
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    t, j = TStore(paths[0]), JStore(paths[1])
    try:
        for img, _ in recs:
            for x, y in zip(t.get(img), j.get(img)):
                np.testing.assert_array_equal(x, y)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_arrow_written_by_either_reads_in_the_other(writer, tmp_path):
    pytest.importorskip("pyarrow")
    recs = _records(5, seed=3, short=(1, 4))
    path = str(tmp_path / "feats.arrow")
    w = TA if writer == "port" else JA
    assert w.write_arrow(path, recs, n_boxes=N_BOXES, feat_dim=FEAT_DIM,
                         batch_rows=2) == 5
    t, j = TA.ArrowFeatureStore(path), JA.ArrowFeatureStore(path)
    assert len(t) == len(j) == 5 and sorted(t.keys()) == sorted(j.keys())
    for img, rec in recs:
        (tf, tb), (jf, jb) = t.get(img), j.get(img)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tb, jb)
        assert tf.shape == (N_BOXES, FEAT_DIM)
        k = rec["features"].shape[0]
        np.testing.assert_array_equal(tf[:k], rec["features"])
        assert t.get_with_size(img)[2] == j.get_with_size(img)[2] == [
            float(rec["img_h"]), float(rec["img_w"])]
    assert TA.arrow_schema(N_BOXES, FEAT_DIM) == \
        JA.arrow_schema(N_BOXES, FEAT_DIM)


def test_arrow_files_are_equal(tmp_path):
    pytest.importorskip("pyarrow")
    recs = _records(3, seed=4)
    a, b = str(tmp_path / "port.arrow"), str(tmp_path / "jax.arrow")
    TA.write_arrow(a, recs, n_boxes=N_BOXES, feat_dim=FEAT_DIM)
    JA.write_arrow(b, recs, n_boxes=N_BOXES, feat_dim=FEAT_DIM)
    with open(a, "rb") as x, open(b, "rb") as y:
        assert x.read() == y.read()


@pytest.mark.parametrize("img_id", [
    42, np.int64(7), "COCO_val2014_000000000042",
    "COCO_train2014_000000123456.jpg", "/data/images/COCO_test2015_0009.png",
    "img_77", "123", "frame_00x12", "abc", "my-photo.jpeg", "x_y_z"])
def test_parse_img_id_matches_jax(img_id):
    got = TA.parse_img_id(img_id)
    assert got == JA.parse_img_id(img_id) and isinstance(got, int)
    assert 0 <= got <= 0x7FFFFFFF or isinstance(img_id, (int, np.integer))


def test_parse_img_id_hashes_names_without_digits():
    import zlib

    assert TA.parse_img_id("abc") == zlib.crc32(b"abc") & 0x7FFFFFFF
    assert TA.parse_img_id("dir/abc.jpg") == TA.parse_img_id("abc")


def test_arrow_without_pyarrow_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TA, "HAVE_ARROW", False)
    with pytest.raises(ImportError, match="pyarrow"):
        TA.write_arrow(str(tmp_path / "x.arrow"), _records(1))
    with pytest.raises(ImportError, match="pyarrow"):
        TA.ArrowFeatureStore(str(tmp_path / "x.arrow"))
    # parse_img_id needs no pyarrow
    assert TA.parse_img_id("COCO_val2014_000000000005") == 5
