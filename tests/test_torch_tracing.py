"""The port's span and counter recorder (``utils/profiling.py``).

Off, it records nothing and hands out one shared no-op context. On, spans
nest per thread with parent ids and self times, sit on the profiler's
clock (a span around ``torch.mm`` contains the CPU trace's ``aten::mm``),
and ``trace`` writes them into its Chrome trace. A tiny-config train step
records its phases in order under one root, and records them without
changing a bit of the loss or the parameters; the batch's copies count
their bytes from host memory. ``attribute`` assigns
made-up kernels to spans by the time of their launch call, whatever
thread made it, and splits the device's idle gaps over the spans. A
multi-worker or single-producer loader left early stops its threads.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.data.partition import BatchLoader  # noqa: E402
from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule  # noqa: E402
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState  # noqa: E402
from vqacl_tpu_torch.models.vlt5 import init_vlt5_params  # noqa: E402
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves  # noqa: E402
from vqacl_tpu_torch.train.state import TrainState  # noqa: E402
from vqacl_tpu_torch.train.step import make_train_step  # noqa: E402
from vqacl_tpu_torch.utils import profiling as P  # noqa: E402
from vqacl_tpu_torch.utils.config import Config, tiny_model_config  # noqa: E402


@pytest.fixture
def rec():
    """The recorder on, and off and empty again after the test."""
    P.take()
    P.enable()
    yield P
    P.enable(False)
    P.take()


def test_off_records_nothing_and_shares_one_noop():
    P.enable(False)
    P.take()
    a, b = P.span("step.train"), P.span("step.forward")
    assert a is b
    with a:
        with b:
            P.count("x", 3)
    taken = P.take()
    assert taken.spans == [] and taken.counters == {}


def test_nesting_parent_ids_and_self_time(rec):
    with P.span("root"):
        with P.span("a"):
            time.sleep(0.002)
        with P.span("b"):
            with P.span("c"):
                time.sleep(0.002)
        P.count("n")
        P.count("n", 2)
    seen = []

    def other():
        with P.span("thread"):
            seen.append(1)

    t = threading.Thread(target=other)
    t.start()
    t.join(5)
    assert not t.is_alive() and seen
    taken = P.take()
    by = {name: (sid, parent, s, e) for name, sid, parent, s, e in
          taken.spans}
    assert [s[0] for s in taken.spans] == ["a", "c", "b", "root", "thread"]
    assert by["root"][1] == 0 and by["thread"][1] == 0
    assert by["a"][1] == by["b"][1] == by["root"][0]
    assert by["c"][1] == by["b"][0]
    selfs = P.self_ns(taken.spans)
    dur = {k: v[3] - v[2] for k, v in by.items()}
    assert selfs["root"] == dur["root"] - dur["a"] - dur["b"]
    assert selfs["b"] == dur["b"] - dur["c"] and selfs["c"] == dur["c"]
    assert selfs["a"] >= 2e6
    assert taken.counters == {"n": 3}
    assert P.take().spans == []


def test_batch_copies_count_the_bytes_from_host_memory(rec):
    from vqacl_tpu_torch.train.step import _to_device
    batch = {"a": np.zeros((2, 3), np.float32),
             "b": torch.zeros(4, dtype=torch.int64)}
    out = _to_device(batch, ("a", "b"), torch.device("meta"))
    assert out["a"].device.type == "meta"
    _to_device(batch, ("a",), torch.device("cpu"))     # no copy, no count
    taken = P.take()
    assert taken.counters == {"h2d_bytes": 24 + 32}
    assert [s[0] for s in taken.spans] == ["step.inputs"] * 2
    from vqacl_tpu_torch.parallel.mesh import MeshContext, shard_batch
    out = shard_batch(MeshContext(device=torch.device("meta")),
                      dict(batch, meta=[1]))
    assert out["b"].device.type == "meta" and out["meta"] == [1]
    taken = P.take()
    assert taken.counters == {"h2d_bytes": 24 + 32}
    assert [s[0] for s in taken.spans] == ["batch.shard"]


def test_spans_sit_on_the_profilers_clock(rec, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    torch.mm(a, b)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span("mm"):
                torch.mm(a, b)
    taken = P.take()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    mms = sorted((e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
                 if e.get("name") == "aten::mm" and e.get("ph") == "X")
    assert len(mms) == 3
    for (_, _, _, s, e), (m0, m1) in zip(taken.spans, mms):
        assert P.profiler_us(s, taken.anchor, base) <= m0 + 50.0
        assert P.profiler_us(e, taken.anchor, base) >= m1 - 50.0


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(32, 32) @ torch.ones(32, 32)
            P.count("rows", 32)
    assert prof.key_averages()
    assert P.span("after") is P.span("off")
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    spans = {e["name"]: e for e in doc["traceEvents"]
             if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert doc["programCounters"] == {"rows": 32}
    assert P.take().spans == []


def _tiny_step(seed=0):
    cfg = Config()
    cfg.model = tiny_model_config()
    m = cfg.model
    params = init_vlt5_params(seed, m, device="cpu")
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cpu")
    state = TrainState.create(params, make_transform(cfg.train), proto,
                              seed=seed, warmup_iters=1.0, t_total=10.0)
    batch = next(SyntheticVQA(4, seed=seed, feat_dim=m.feat_dim,
                              n_boxes=m.n_boxes, text_len=m.max_text_length,
                              vocab_size=m.vocab_size, answer_vocab=8
                              ).batches(4, seed=seed))["tensors"]
    step = make_train_step(cfg, dtype=torch.float32, device="cpu")
    return step, state, batch


def test_train_step_records_its_phases_in_order(rec):
    step, state, batch = _tiny_step()
    step(state, batch)
    spans = sorted(P.take().spans, key=lambda s: s[3])
    assert [s[0] for s in spans] == ["step.train", "step.inputs",
                                     "step.forward", "step.backward",
                                     "step.optimizer"]
    root = spans[0]
    assert root[2] == 0 and all(s[2] == root[1] for s in spans[1:])
    for a, b in zip(spans[1:], spans[2:]):
        assert a[4] <= b[3]


def test_tracing_changes_no_bit_of_the_step():
    out = {}
    for on in (False, True):
        P.take()
        P.enable(on)
        try:
            step, state, batch = _tiny_step(seed=1)
            for _ in range(2):
                state, met = step(state, batch)
        finally:
            P.enable(False)
        out[on] = (met["loss"], tree_leaves(state.params))
    assert P.take().spans          # the second run recorded
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def _spans_ns(*rows):
    """Made-up spans (name, id, parent, start_us, end_us) in ns; with the
    anchor ``ANCHOR`` and base ``BASE`` their µs are the trace's."""
    return [(n, i, p, int(s * 1000), int(e * 1000)) for n, i, p, s, e in rows]


BASE = 10 ** 18
ANCHOR = (0, BASE)


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribute_by_launch_call_and_idle_split():
    spans = _spans_ns(("step.train", 1, 0, 0, 100),
                      ("step.forward", 2, 1, 10, 40),
                      ("step.backward", 3, 1, 40, 70),
                      ("step.optimizer", 4, 1, 70, 100))
    events = [
        # the forward's launch on the step's thread, run late on the card
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("kernel", "fwd_k", 45, 5, corr=1),
        # the backward's launch from the autograd engine's thread
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2, tid=7),
        ev("kernel", "bwd_k", 60, 10, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 80, 1, corr=3),
        ev("kernel", "opt_k", 90, 20, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 120, 5, corr=4),
        # a launch before the spans, and a kernel whose call is missing
        ev("cuda_runtime", "cudaLaunchKernel", -5, 1, corr=5),
        ev("kernel", "early_k", 0, 2, corr=5),
        ev("kernel", "lost_k", 130, 2, corr=99),
    ]
    out = P.attribute({"traceEvents": events, "baseTimeNanoseconds": BASE},
                      spans, ANCHOR)
    assert out["launches"] == {"step.forward": 1, "step.backward": 1,
                               "step.optimizer": 1, "outside": 2}
    assert sum(out["launches"].values()) == 5
    assert out["no_launch_call"] == 1
    assert out["kernels"]["step.backward"] == {"bwd_k": 1}
    # each span's kernels' device time: the kernel's duration, by launch
    dev = {k: pytest.approx(v * 1e6) for k, v in out["device_s"].items()}
    assert dev == {"step.forward": 5.0, "step.backward": 10.0,
                   "step.optimizer": 20.0, "outside": 4.0}
    idle = {k: pytest.approx(v * 1e6) for k, v in out["idle_s"].items()}
    # busy: [0,2] [45,50] [60,70] [90,110] [120,125] [130,132]
    # gaps: 2→45 (train 2→10, forward 10→40, backward 40→45),
    # 50→60 backward, 70→90 optimizer, 110→120 and 125→130 outside
    assert idle == {"step.train": 8.0, "step.forward": 30.0,
                    "step.backward": 15.0, "step.optimizer": 20.0,
                    "outside": 15.0}


def test_segments_innermost_and_overlap_across_threads():
    spans = _spans_ns(("a", 1, 0, 0, 10), ("b", 2, 1, 2, 4),
                      ("w", 3, 0, 8, 15))      # another thread's span
    seg = P.Segments(spans, ANCHOR, BASE)
    assert [seg.at(t) for t in (1, 3, 5, 9, 12, 20, -1)] == \
        ["a", "b", "a", "w", "w", "outside", "outside"]
    assert seg.split(-2, 16) == {"outside": 3.0, "a": 6.0, "b": 2.0,
                                 "w": 7.0}


@pytest.mark.parametrize("workers", [1, 4])
def test_a_loader_left_early_stops_its_threads(workers, rec):
    data = SyntheticDataModule(VLT5Tokenizer(), tasks=["q_recognition"],
                               n_train_per_task=48, n_val_per_task=4,
                               n_test_per_task=4, feat_dim=16, n_boxes=4,
                               answer_vocab=4, seed=0)
    ds = data.make_dataset(data._items["q_recognition"]["train"], "train", 0)
    loader = BatchLoader(ds, np.arange(len(ds)), 4, num_workers=workers,
                         collate_kw=dict(max_text_length=6, n_boxes=4,
                                         target_max_length=5, feat_dim=16))
    before = set(threading.enumerate())
    it = iter(loader)
    for _ in range(2):
        next(it)
    time.sleep(0.1)                 # the threads run ahead and block
    mine = set(threading.enumerate()) - before
    assert len(mine) == workers
    it.close()
    deadline = time.monotonic() + 2.0
    while any(t.is_alive() for t in mine) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(t.is_alive() for t in mine)
    # the consumer's waits are spans of its own thread only
    waits = [s for s in P.take().spans if s[0] == "loader.wait"]
    assert all(s[2] == 0 for s in waits)
    # a loader left early runs again from the start
    assert len(list(loader)) == len(loader)
