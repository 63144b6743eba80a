"""The port's serving slice as a whole against the JAX package.

JAX parameters → ``from_jax_params`` → the port's ``make_eval_step``
(CPU tensors: the fused attention takes its plain version) must give the
same tokens as JAX ``make_eval_step`` with the Pallas kernel in
interpret mode: exactly in f32 (dropout 0), including rows that emit EOS
and are pad-filled after it and a batch in which every row finishes
early. A checkpoint written by the JAX package is served by the port
with the same answer strings. The package and ``chip_smoke.py`` import
nothing of JAX, and entry points never fall back to the CPU on their
own.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (encoder_inputs, jax_tiny_params, proto_banks,  # noqa: E402
                          torch_cfg_like)
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from vqacl_tpu.utils.config import Config as JConfig  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState as TProto  # noqa: E402
from vqacl_tpu_torch.train.step import make_eval_step  # noqa: E402
from vqacl_tpu_torch.utils.config import Config as TConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 6


def _configs(jcfg):
    jcfg.fused_attention = True
    jcfg.fused_interpret = True
    jc = JConfig()
    jc.model = jcfg
    tc = TConfig()
    tc.model = torch_cfg_like(jcfg)
    return jc, tc


def _protos(cfg):
    q, v = proto_banks(cfg, seed=1)
    jp = JProto.create(cfg.n_ques_types, cfg.n_categories, cfg.d_model)
    jp = jp._replace(q_proto=jnp.asarray(q), v_proto=jnp.asarray(v))
    tp = TProto.create(cfg.n_ques_types, cfg.n_categories, cfg.d_model,
                       device="cpu")
    tp = tp._replace(q_proto=torch.from_numpy(q), v_proto=torch.from_numpy(v))
    return jp, tp


@pytest.fixture(scope="module")
def slice_setup():
    jcfg, params = jax_tiny_params(0, vocab_size=32200)
    jc, tc = _configs(jcfg)
    ids, feats, boxes = encoder_inputs(jcfg, B, seed=5)
    batch = {"input_ids": ids, "vis_feats": feats, "boxes": boxes}
    jproto, tproto = _protos(jcfg)
    return dict(jc=jc, tc=tc, params=params, batch=batch,
                jproto=jproto, tproto=tproto,
                jax_eval={}, )


def _jax_eval(s, dtype):
    if dtype not in s["jax_eval"]:
        s["jax_eval"][dtype] = jax_make_eval_step(s["jc"], dtype=dtype)
    return s["jax_eval"][dtype]


def _jax_tokens(s, params, dtype=jnp.float32):
    return np.asarray(_jax_eval(s, dtype)(
        jax.tree.map(jnp.asarray, params), s["jproto"],
        {k: jnp.asarray(v) for k, v in s["batch"].items()}))


def _params(s, eos_gain=None):
    """The test weights. The pad/start row (0) is zeroed: with random
    weights the decoder otherwise repeats its start token. With
    ``eos_gain`` the EOS row (1) becomes ``eos_gain`` × the mean of the
    rows the decoder picks first, so that some rows (gain 1.2) or all
    rows (gain 2) emit EOS."""
    shared = s["params"]["shared"].copy()
    shared[0] = 0.0
    params = {**s["params"], "shared": shared}
    if eos_gain is not None:
        if "first" not in s:
            s["first"] = _jax_tokens(s, params)[:, 0]
        shared = shared.copy()
        shared[1] = eos_gain * shared[s["first"]].mean(axis=0)
        params = {**params, "shared": shared}
    return params


def test_param_tree_matches_jax_init():
    """The parameter tree the tests use (and ``init_vlt5_params`` makes)
    has JAX init's keys, shapes and dtypes."""
    from vqacl_tpu.models.vlt5 import init_vlt5_params as jax_init

    jcfg, params = jax_tiny_params(0)
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    flat_j = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype)) for k, v
              in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_t = {jax.tree_util.keystr(k): (v.shape, v.dtype) for k, v
              in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert flat_t == flat_j


@pytest.mark.parametrize("case,eos_gain", [
    ("varied", None),
    ("some_rows_finish", 1.2),
    ("all_rows_finish", 2.0),
])
def test_eval_step_tokens_exactly_equal_f32(slice_setup, case, eos_gain):
    s = slice_setup
    params = _params(s, eos_gain)
    ref = _jax_tokens(s, params)
    ev = make_eval_step(s["tc"], dtype=torch.float32, device="cpu")
    out = ev(from_jax_params(params), s["tproto"], s["batch"])
    assert out.dtype == torch.int32
    assert out.shape == (B, s["tc"].model.gen_max_length - 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    finished = (ref == 1).any(axis=1)
    if case == "all_rows_finish":
        assert finished.all()
    if case == "some_rows_finish":
        assert finished.any() and not finished.all()
    for row in ref[finished]:                 # pad fill after EOS
        assert (row[int(np.argmax(row == 1)) + 1:] == 0).all()


def test_eval_step_bf16_agreement_bound(slice_setup):
    """bf16 rounds at other places in the two frameworks (e.g. XLA may
    fuse a product and its cast), so tokens are not bit-comparable; the
    bound: at least 5 of the 6 rows decode to the same tokens."""
    s = slice_setup
    params = _params(s, 1.2)
    ref = _jax_tokens(s, params, jnp.bfloat16)
    ev = make_eval_step(s["tc"], dtype=torch.bfloat16, device="cpu")
    out = ev(from_jax_params(params), s["tproto"], s["batch"]).numpy()
    assert (out == ref).all(axis=1).sum() >= B - 1


def _store_and_questions(cfg, n=5):
    from vqacl_tpu_torch.data.features import MemoryFeatureStore

    _, feats, boxes = encoder_inputs(cfg, n, seed=6)
    store = MemoryFeatureStore()
    for i in range(n):
        store.put(f"img{i}", feats[i], boxes[i])
    qs = [f"what is in picture {i}?" for i in range(n)]
    return store, qs, [f"img{i}" for i in range(n)]


def test_jax_checkpoint_served_by_port_with_same_answers(slice_setup,
                                                         tmp_path):
    from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok
    from vqacl_tpu.serve import VQAPredictor as JPredictor
    from vqacl_tpu.train.checkpoint import save_checkpoint as jax_save
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok
    from vqacl_tpu_torch.serve import VQAPredictor

    s = slice_setup
    params = _params(s, 1.2)
    path = str(tmp_path / "ckpt")
    jax_save(path, params, s["jproto"], step=7)
    store, qs, imgs = _store_and_questions(s["jc"].model)

    jpred = JPredictor(s["jc"], jax.tree.map(jnp.asarray, params),
                       s["jproto"], JTok(), store, batch_size=B,
                       dtype=jnp.float32)
    tpred = VQAPredictor.from_checkpoint(path, TTok(), store, cfg=s["tc"],
                                         batch_size=B, dtype=torch.float32,
                                         device="cpu")
    ref = jpred.answer(qs, imgs)
    out = tpred.answer(qs, imgs)
    assert out == ref
    # the same examples through the same step give the same token ids
    exs = tpred._examples(qs, imgs)
    np.testing.assert_array_equal(
        tpred.dispatch_chunk(exs).numpy(),
        np.asarray(jpred.dispatch_chunk(jpred._examples(qs, imgs))))


def test_port_checkpoint_loads_in_jax(slice_setup, tmp_path):
    from vqacl_tpu.train.checkpoint import load_checkpoint as jax_load
    from vqacl_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

    s = slice_setup
    tp = from_jax_params(s["params"])
    path = str(tmp_path / "port_ckpt")
    save_checkpoint(path, tp, s["tproto"], step=3)
    jparams, jproto, step = jax_load(path)
    assert step == 3
    for (k, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree_util.tree_flatten_with_path(s["params"])[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(k))
    np.testing.assert_array_equal(jproto.q_proto, s["tproto"].q_proto.numpy())
    back, proto, step = load_checkpoint(path)
    assert step == 3 and proto.task_id.dtype == torch.int32
    np.testing.assert_array_equal(back["shared"].numpy(), s["params"]["shared"])


@pytest.mark.parametrize("pipeline_depth", [0, 1])
def test_server_coalesces_and_isolates_bad_requests(slice_setup,
                                                    pipeline_depth):
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.serve import VQAPredictor, VQAServer

    s = slice_setup
    store, qs, imgs = _store_and_questions(s["jc"].model, n=4)
    pred = VQAPredictor(s["tc"], from_jax_params(s["params"]), s["tproto"],
                        VLT5Tokenizer(), store, batch_size=4,
                        dtype=torch.float32, device="cpu")
    want = pred.answer(qs * 2, imgs * 2)
    with VQAServer(pred, max_wait_ms=200.0,
                   pipeline_depth=pipeline_depth) as srv:
        bad = srv.submit("where?", "no-such-image")
        results = [None] * 8
        start = threading.Barrier(8)

        def client(i):
            start.wait()
            results[i] = srv.submit(qs[i % 4], imgs[i % 4]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        with pytest.raises(KeyError):
            bad.result(timeout=10)
        st = srv.stats()
    assert results == want
    assert st["requests"] == 9 and st["errors"] == 1
    assert st["batches"] < 8 and st["latency_p50_ms"] is not None
    with pytest.raises(RuntimeError):
        srv.submit("late?", imgs[0]).result(timeout=10)


def test_tokenizer_and_collate_match_jax():
    from vqacl_tpu.data.synthetic import synthetic_batch as jbatch
    from vqacl_tpu.data.tokenizer import VLT5Tokenizer as JTok
    from vqacl_tpu_torch.data.synthetic import synthetic_batch as tbatch
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer as TTok

    jt, tt = JTok(), TTok()
    for text in ("vqa: what color is the cat?", "VQA: How MANY dogs", ""):
        assert tt.encode(text, max_length=6) == jt.encode(text, max_length=6)
        assert tt.encode(text) == jt.encode(text)
    ids = tt.encode("vqa: a b c d")
    assert ids == jt.encode("vqa: a b c d")
    assert tt.decode(ids + [0, 0]) == jt.decode(ids + [0, 0]) \
        == "vqa: a b c d"
    assert (tt.vocab_size, tt.extra_id(0), tt.vis_extra_id(99)) == \
        (jt.vocab_size, jt.extra_id(0), jt.vis_extra_id(99))
    a = jbatch(5, seed=3, feat_dim=16, n_boxes=4, text_len=6, vocab_size=256)
    b = tbatch(5, seed=3, feat_dim=16, n_boxes=4, text_len=6, vocab_size=256)
    for k, v in a["tensors"].items():
        np.testing.assert_array_equal(b["tensors"][k], v, err_msg=k)


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py with its phase modules
    (``smoke/``), imports with ``jax``, ``vqacl_tpu``, ``h5py``,
    ``ml_dtypes``, ``transformers``, ``safetensors``, ``orbax``, ``yaml``,
    ``pyarrow``, ``nltk``, ``tokenizers``, ``PIL``, ``cv2``,
    ``matplotlib`` and ``torchvision`` blocked (a None entry in sys.modules makes any import of them raise);
    the weight files and the directory checkpoint are written and read
    with them blocked too, and so are the detector's weights (npz) and a
    pack of extracted records made from a decoded array. The parallel
    modules and the protocol scripts (ablation, soak) are among them, and
    a one-process mesh starts."""
    code = r"""
import importlib, os, pkgutil, runpy, sys, tempfile
BLOCKED = ("jax", "jaxlib", "vqacl_tpu", "h5py", "ml_dtypes", "transformers",
           "safetensors", "orbax", "yaml", "pyarrow", "nltk", "tokenizers",
           "PIL", "cv2", "matplotlib", "torchvision")
for name in BLOCKED:
    sys.modules[name] = None
import vqacl_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(vqacl_tpu_torch.__path__,
                                              "vqacl_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"vqacl_tpu_torch.parallel.mesh", "vqacl_tpu_torch.parallel.multihost",
        "vqacl_tpu_torch.parallel.sharding",
        "vqacl_tpu_torch.parallel.pipeline", "vqacl_tpu_torch.ablation",
        "vqacl_tpu_torch.soak"} <= set(mods)
from vqacl_tpu_torch import make_mesh
assert make_mesh(device="cpu").dp == 1
runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_check")["phases"]()
from vqacl_tpu_torch.models import hf_import, vlt5
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.train import checkpoint
from vqacl_tpu_torch.utils.config import tiny_model_config
cfg = tiny_model_config()
p = vlt5.init_vlt5_params(0, cfg, device="cpu")
with tempfile.TemporaryDirectory() as d:
    hf_import.write_safetensors(hf_import.to_state_dict(p, cfg),
                                os.path.join(d, "model.safetensors"))
    hf_import.load_t5_base(cfg, d)
    hf_import.save_reference_pth(p, os.path.join(d, "m.pth"), cfg)
    hf_import.load_reference_pth(os.path.join(d, "m.pth"), cfg)
    checkpoint.save_checkpoint_dcp(os.path.join(d, "dcp"), p,
                                   ProtoState.create(10, 80, 32, device="cpu"))
    checkpoint.load_checkpoint_dcp(os.path.join(d, "dcp"))
    # the extraction path over decoded arrays: a pack, no PIL, no h5py
    import numpy as np
    from vqacl_tpu_torch.cli import extract_features as ef
    from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
    from vqacl_tpu_torch.vision import convert_weights, frcnn, resnet, video
    resnet.R101_STAGES = [("res2", 1, 32, 8, 1), ("res3", 1, 64, 8, 2),
                          ("res4", 1, 1024, 16, 2)]
    resnet.RES5 = ("res5", 1, 2048, 16, 2)
    det = frcnn.init_frcnn(0, device="cpu")
    convert_weights.save_npz_params(os.path.join(d, "w.npz"), det)
    det = convert_weights.load_npz_params(os.path.join(d, "w.npz"))
    rs = frcnn.resize_shortest_edge
    frcnn.resize_shortest_edge = lambda img: rs(img, 32, 64)
    frcnn.PAD_BUCKETS = (32, 64)
    args = ef.parse_args(["--out", os.path.join(d, "r.vfpack"), "--pack",
                          "--n_boxes", "4"])
    img = np.zeros((24, 32, 3), np.uint8)
    ef.write(args, ef.records(det, [("a", img, None)], 4, "cpu"))
    assert PackedFeatureStore(args.out).get("a")[0].shape == (4, 2048)
    assert video._resize_square(np.zeros((2, 8, 8, 3), np.uint8), 8).shape \
        == (2, 8, 8, 3)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED + ("flax",)
       and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(mods))
print("imported", len(mods))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 18
    imported = set(r.stdout.split())
    for m in ("train.optim", "train.state", "train.step", "profile_train",
              "ops.fused_attention", "ops._build", "ops.dw", "mm_bench",
              "cl.tasks", "cl.metrics", "cl.exemplar", "cl.regularizers",
              "cl.trainer", "cl.comp_trainer", "evaluation.vqa_acc",
              "data.partition", "data.synthetic_module", "cli.serve_http",
              "data.device_cache", "data.packed_cache", "models.hf_import",
              "models.bart", "cli.export_pth", "train.checkpoint",
              "cli.args", "cli.vqacl_train", "cli.nextqa_train",
              "cli.validate_wordnet", "data.vqa_module", "data.tsv_convert",
              "data.arrow_store", "evaluation.taxonomy",
              "evaluation.wordnet_db", "evaluation.wups", "nextqa.data",
              "utils.boxes", "ops.nms", "ops.roi_align", "ops.topk",
              "vision.resnet", "vision.rpn", "vision.frcnn",
              "vision.convert_weights", "vision.datasets",
              "vision.visualize", "cli.extract_features",
              "cli.validate_features", "vision.resnext3d", "vision.video",
              "cli.extract_video_features", "utils.profiling",
              "utils.backbones"):
        assert f"vqacl_tpu_torch.{m}" in imported, m


def test_entry_points_need_a_device_without_cuda(slice_setup):
    """Without a card, an entry point called with no ``device`` raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models.vlt5 import init_vlt5_params
    from vqacl_tpu_torch.serve import VQAPredictor

    s = slice_setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(s["tc"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_vlt5_params(0, s["tc"].model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQAPredictor(s["tc"], from_jax_params(s["params"]), s["tproto"],
                     VLT5Tokenizer(), None)
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule

    tok = VLT5Tokenizer()
    data = SyntheticDataModule(tok, tasks=["q_recognition"],
                               n_train_per_task=4, n_val_per_task=2,
                               n_test_per_task=2, feat_dim=16, n_boxes=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQACLTrainer(s["tc"], data, tok,
                     init_params=from_jax_params(s["params"]))
