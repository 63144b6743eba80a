"""The port's serving extras against the JAX package's.

``VQAPredictor(num_beams, device_cache, slot_of)`` answers as JAX's
predictor does (f32, tiny config, the Pallas kernel in interpret mode);
the HTTP front end (``cli/serve_http.py``) serves the cases of
``tests/test_serve_http.py`` on port 0 with the same payloads and the
same Prometheus text as JAX's; ``VQAServer``'s close and pipelined paths
resolve every request. ``H5FeatureStore``, ``write_h5`` and
``subset_h5`` read and write the files JAX's do, and a feature pack
written by either package reads in the other.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_tiny_params, proto_banks, torch_cfg_like  # noqa: E402
from vqacl_tpu.data import device_cache as JD  # noqa: E402
from vqacl_tpu.data import features as JF  # noqa: E402
from vqacl_tpu.data import packed_cache as JP  # noqa: E402
from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.serve import VQAPredictor as JPredictor  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.cli.serve_http import (make_http_server,  # noqa: E402
                                            serve_forever_in_thread)
from vqacl_tpu_torch.data import device_cache as TD  # noqa: E402
from vqacl_tpu_torch.data import features as TF  # noqa: E402
from vqacl_tpu_torch.data import packed_cache as TP  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.serve import VQAPredictor, VQAServer  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

N_IMG = 8


@pytest.fixture(scope="module")
def setup():
    jm, params = jax_tiny_params(0, vocab_size=32200)
    params["shared"][0] = 0.0
    jm.fused_attention = True
    jm.fused_interpret = True
    jc, tc = JConfig(), TConfig()
    jc.model, tc.model = jm, torch_cfg_like(jm)
    q, v = proto_banks(jm, seed=1)
    jproto = JProto.create(jm.n_ques_types, jm.n_categories,
                           jm.d_model)._replace(q_proto=jnp.asarray(q),
                                                v_proto=jnp.asarray(v))
    tproto = TProto.create(jm.n_ques_types, jm.n_categories, jm.d_model,
                           device="cpu")._replace(q_proto=torch.from_numpy(q),
                                                  v_proto=torch.from_numpy(v))
    rng = np.random.default_rng(0)
    store = TF.MemoryFeatureStore()
    for i in range(N_IMG):
        store.put(f"img{i}",
                  rng.normal(size=(jm.n_boxes, jm.feat_dim)).astype(
                      np.float32),
                  rng.uniform(0, 1, (jm.n_boxes, 4)).astype(np.float32))
    qs = [f"what is in picture {i}?" for i in range(6)]
    imgs = [f"img{i}" for i in (3, 0, 7, 1, 5, 3)]
    pred = VQAPredictor(tc, from_jax_params(params), tproto, VLT5Tokenizer(),
                        store, batch_size=4, dtype=torch.float32,
                        device="cpu")
    return dict(jc=jc, tc=tc, params=params, jproto=jproto, tproto=tproto,
                store=store, qs=qs, imgs=imgs, pred=pred)


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("cached", [False, True])
def test_predictor_answers_equal_jax(setup, num_beams, cached):
    s = setup
    kw, jkw = {}, {}
    if cached:
        ids = sorted(s["store"].table)
        tcache, slot_of = TD.DeviceFeatureCache.from_store(
            s["store"], ids, device="cpu", feat_dtype=torch.float32)
        jcache, jslot_of = JD.DeviceFeatureCache.from_store(
            s["store"], ids, feat_dtype=jnp.float32)
        kw = dict(device_cache=tcache, slot_of=slot_of)
        jkw = dict(device_cache=jcache, slot_of=jslot_of)
    jpred = JPredictor(s["jc"], jax.tree.map(jnp.asarray, s["params"]),
                       s["jproto"], JTok(), None if cached else s["store"],
                       batch_size=4, num_beams=num_beams, dtype=jnp.float32,
                       **jkw)
    tpred = VQAPredictor(s["tc"], from_jax_params(s["params"]), s["tproto"],
                         VLT5Tokenizer(), None if cached else s["store"],
                         batch_size=4, num_beams=num_beams,
                         dtype=torch.float32, device="cpu", **kw)
    ref = jpred.answer(s["qs"], s["imgs"])
    out = tpred.answer(s["qs"], s["imgs"])
    assert out == ref
    exs = tpred._examples(s["qs"][:4], s["imgs"][:4])
    assert ("slot" in exs[0]) == cached
    np.testing.assert_array_equal(
        tpred.dispatch_chunk(exs).numpy(),
        np.asarray(jpred.dispatch_chunk(jpred._examples(s["qs"][:4],
                                                        s["imgs"][:4]))))
    if num_beams == 1:      # the cached predictor answers as the host one
        assert out == s["pred"].answer(s["qs"], s["imgs"])


def test_device_cache_without_slot_map_raises(setup):
    s = setup
    cache, _ = TD.DeviceFeatureCache.from_store(
        s["store"], sorted(s["store"].table), device="cpu")
    with pytest.raises(ValueError, match="slot_of"):
        VQAPredictor(s["tc"], from_jax_params(s["params"]), s["tproto"],
                     VLT5Tokenizer(), None, device="cpu",
                     device_cache=cache)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def test_http_roundtrip(setup):
    s = setup
    pred = s["pred"]
    want = pred.answer(["what is this?", "a?", "b?"], ["img1", "img2", "img3"])
    with VQAServer(pred, max_wait_ms=20.0) as srv:
        httpd = make_http_server(srv, host="127.0.0.1", port=0)
        thread = serve_forever_in_thread(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert json.load(r) == {"ok": True}
            assert _post(base + "/v1/vqa", {"question": "what is this?",
                                            "img_id": "img1"}) == \
                {"answer": want[0]}
            assert _post(base + "/v1/vqa", {"items": [
                {"question": "a?", "img_id": "img2"},
                {"question": "b?", "img_id": "img3"}]}) == \
                {"answers": want[1:]}
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                st = json.load(r)
            assert st["requests"] == 3 and st["batch_capacity"] == 4
            assert st["errors"] == 0
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                assert r.headers["Content-Type"] == \
                    "text/plain; version=0.0.4"
                text = r.read().decode()
            assert "# TYPE vqa_requests counter\nvqa_requests 3\n" in text
            assert "# TYPE vqa_mean_batch_fill gauge" in text
            for payload, code in (({"question": "x?", "img_id": "missing"},
                                   400), ({"question": "x?"}, 400)):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(base + "/v1/vqa", payload)
                assert ei.value.code == code
            bad = urllib.request.Request(base + "/v1/vqa", data=b"{nope",
                                         headers={"Content-Length": "5"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=30)
            assert ei.value.code == 400
            for path in ("/nope", "/v1/other"):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(base + path, timeout=30)
                assert ei.value.code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    assert not thread.is_alive()


class _FixedServer:
    """A stand-in for ``VQAServer`` with fixed stats: its answers and
    its errors are those the handlers pass on."""

    def stats(self):
        return {"requests": 7, "batches": 3, "errors": 1,
                "mean_batch_fill": 2.0, "batch_capacity": 4,
                "latency_p50_ms": 1.5, "latency_p99_ms": None}

    def submit(self, question, img_id):
        from concurrent.futures import Future
        fut = Future()
        if img_id == "boom":
            fut.set_exception(RuntimeError("device failed"))
        elif img_id == "missing":
            raise KeyError(img_id)
        else:
            fut.set_result(f"{question}|{img_id}")
        return fut


def _serve(make, server):
    httpd = make(server, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _fetch(url, payload=None):
    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_payloads_and_metrics_equal_jax():
    from vqacl_tpu.cli.serve_http import make_http_server as jax_make

    servers = [_serve(make, _FixedServer())
               for make in (jax_make, make_http_server)]
    try:
        for path, payload in (
                ("/healthz", None), ("/stats", None), ("/metrics", None),
                ("/nope", None), ("/v1/vqa", {"question": "q", "img_id": "a"}),
                ("/v1/vqa", {"items": [{"question": "q", "img_id": "a"},
                                       {"question": "r", "img_id": "b"}]}),
                ("/v1/vqa", {"question": "q", "img_id": "missing"}),
                ("/v1/vqa", {"question": "q", "img_id": "boom"}),
                ("/v1/vqa", {"img_id": "a"}), ("/v2", {"a": 1})):
            got = [_fetch(base + path, payload) for _, base in servers]
            assert got[1] == got[0], path
    finally:
        for httpd, _ in servers:
            httpd.shutdown()
            httpd.server_close()


def test_concurrent_http_clients_coalesce(setup):
    pred = setup["pred"]
    qs = [f"question {i}?" for i in range(8)]
    imgs = [f"img{i}" for i in range(8)]
    want = pred.answer(qs, imgs)
    with VQAServer(pred, max_wait_ms=250.0) as srv:
        httpd, base = _serve(make_http_server, srv)
        try:
            results = [None] * 8
            start = threading.Barrier(8)

            def client(i):
                start.wait()
                results[i] = _post(base + "/v1/vqa", {
                    "question": qs[i], "img_id": imgs[i]})["answer"]

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            st = srv.stats()
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert results == want
    assert st["requests"] == 8 and st["errors"] == 0
    assert st["batches"] <= 5 and st["mean_batch_fill"] > 1.0


def test_close_fails_requests_stranded_behind_sentinel(setup):
    from concurrent.futures import Future

    pred = setup["pred"]
    srv = VQAServer(pred, max_wait_ms=1.0)
    srv.close()
    fut = Future()
    srv._q.put((pred._examples(["raced?"], ["img0"])[0], fut,
                time.monotonic()))
    srv.close()
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)


def test_pipelined_server_resolves_all(setup):
    pred = setup["pred"]
    qs = [f"question {i}?" for i in range(8)]
    imgs = [f"img{i}" for i in range(8)]
    with VQAServer(pred, max_wait_ms=5.0) as sync_srv:
        expected = sync_srv.answer(qs, imgs)
    with VQAServer(pred, max_wait_ms=5.0, pipeline_depth=2) as srv:
        assert srv.answer(qs, imgs) == expected
        assert srv.stats()["errors"] == 0


def test_cli_main_requires_one_feature_source(capsys):
    from vqacl_tpu_torch.cli import serve_http

    for argv in (["--checkpoint", "x"],
                 ["--checkpoint", "x", "--coco_h5", "a", "--pack", "b"]):
        with pytest.raises(SystemExit):
            serve_http.main(argv)
    assert "--coco_h5" in capsys.readouterr().err


# ---- host feature stores ---------------------------------------------------

def _records(n, seed=0, n_boxes=36, feat_dim=64):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        boxes = rng.uniform(0, 50, size=(n_boxes, 4)).astype(np.float32)
        boxes[:, 2:] += boxes[:, :2]
        out.append((f"COCO_val2014_{i:06d}",
                    rng.normal(size=(n_boxes, feat_dim)).astype(np.float32),
                    boxes, 90.0 + i, 120.0 - i))
    return out


def _h5_records(recs):
    return [(img, {"features": f, "boxes": b, "img_h": int(h),
                   "img_w": int(w), "obj_id": np.arange(len(b))})
            for img, f, b, h, w in recs]


def test_h5_store_and_subset_equal_jax(tmp_path):
    pytest.importorskip("h5py")
    recs = _records(6)
    tpath, jpath = str(tmp_path / "t_obj36.h5"), str(tmp_path / "j_obj36.h5")
    TF.write_h5(tpath, _h5_records(recs))
    JF.write_h5(jpath, _h5_records(recs))
    for path in (tpath, jpath):
        t = TF.H5FeatureStore({"val2014": path}, cache_items=2)
        j = JF.H5FeatureStore({"val2014": path}, cache_items=2)
        for img, *_ in recs + recs[:2]:
            for a, b in zip(t.get(img), j.get(img)):
                np.testing.assert_array_equal(a, b)
        assert len(t._cache) == 2
        assert recs[0][0] in t and "COCO_val2014_999" not in t
        with pytest.raises(KeyError):
            t.get("COCO_val2014_999")
    two = TF.H5FeatureStore({"val2014": tpath, "train2014": jpath})
    with pytest.raises(KeyError, match="route"):
        two.get("COCO_test2015_1")
    ids = [recs[4][0], {"img_id": recs[1][0]}, "absent"]
    tsub, jsub = str(tmp_path / "tsub.h5"), str(tmp_path / "jsub.h5")
    assert TF.subset_h5(tpath, tsub, ids) == JF.subset_h5(tpath, jsub, ids) \
        == 2
    import h5py
    with h5py.File(tsub, "r") as a, h5py.File(jsub, "r") as b:
        assert sorted(a.keys()) == sorted(b.keys()) == sorted(
            [recs[4][0], recs[1][0]])
        for g in a:
            assert sorted(a[g].keys()) == sorted(b[g].keys())
            for k in a[g]:
                np.testing.assert_array_equal(a[g][k][()], b[g][k][()])


def test_h5_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: TF.write_h5(str(tmp_path / "x.h5"), []),
                 lambda: TF.subset_h5("a.h5", "b.h5", []),
                 lambda: TF.H5FeatureStore({"x": "a.h5"}).get("x1"),
                 lambda: TP.pack_from_h5(["a.h5"], str(tmp_path / "p"))):
        with pytest.raises(ImportError, match="h5py"):
            call()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pack_reads_in_both_packages(tmp_path, writer):
    recs = _records(12, seed=1)
    path = str(tmp_path / f"{writer}.vfpack")
    (TP if writer == "port" else JP).write_pack(path, recs, n_boxes=36,
                                                feat_dim=64)
    t, j = TP.PackedFeatureStore(path, n_threads=3), JP.PackedFeatureStore(path)
    assert (t.n_images, t.n_boxes, t.feat_dim) == (12, 36, 64)
    ids = [recs[i][0] for i in (5, 3, 11, 0, 5)] + ["absent"]
    tf, tb = t.get_batch(ids)
    jf, jb = j.get_batch(ids)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tf[0], recs[5][1])
    assert not tf[-1].any() and not tb[-1].any()
    img, feats, boxes, h, w = recs[3]
    f, b = t.get(img)
    np.testing.assert_array_equal(f, feats)
    want = boxes.copy()
    want[:, (0, 2)] *= np.float32(1) / np.float32(w)
    want[:, (1, 3)] *= np.float32(1) / np.float32(h)
    np.testing.assert_allclose(b, want.clip(0, 1), rtol=1e-6)
    assert img in t and "absent" not in t
    with pytest.raises(KeyError):
        t.get("absent")
    t.close()
    t.close()                                    # idempotent


def test_pack_from_h5_and_hash_equal_jax(tmp_path):
    pytest.importorskip("h5py")
    recs = _records(3, seed=2, feat_dim=2048)
    h5 = str(tmp_path / "ref_obj36.h5")
    TF.write_h5(h5, _h5_records(recs))
    tp, jp = str(tmp_path / "t.vfpack"), str(tmp_path / "j.vfpack")
    assert TP.pack_from_h5([h5], tp) == JP.pack_from_h5([h5], jp) == 3
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for s in ("", "COCO_val2014_000000001", "synt_12", "ünï"):
        assert TP.fnv1a(s) == JP.fnv1a(s)
    with pytest.raises(ValueError, match="expected"):
        TP.write_pack(str(tmp_path / "bad"), recs[:1], n_boxes=36,
                      feat_dim=64)


def test_pack_library_is_named_by_its_source(tmp_path, monkeypatch):
    path = TP._lib_path()
    assert os.path.dirname(path) == TP.BUILD_DIR
    assert TP.BUILD_DIR.endswith(os.path.join("build", "native"))
    TP._lib()
    assert os.path.exists(path)
    src = tmp_path / "feature_cache.cpp"
    src.write_bytes(open(TP.SOURCE, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(TP, "SOURCE", str(src))
    assert TP._lib_path() != path
