"""The train step's CUDA-graph wrapper (``train/graph.py``) on the CPU.

A CUDA graph needs a card, so these tests run ``GraphedStep`` through
``torch_graph_fake.FakeGraphs`` (a capture that leaves no trace, replays
that count nothing themselves): which calls stay eager, how graphs are
keyed by the batch's signature and bounded, the state slots' aliasing
contract, fresh metrics, the counters a replay adds, and a graphed run
equal to the eager one bit for bit. The card's own check is
``chip_smoke.py`` phase 17. Also the head loss's rescale as a host
scalar, bit for bit the former 0-dim device tensor.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_graph_fake import install  # noqa: E402

from vqacl_tpu_torch.cl.regularizers import init_reg_state  # noqa: E402
from vqacl_tpu_torch.data.synthetic import SyntheticVQA  # noqa: E402
from vqacl_tpu_torch.models import vlt5 as V  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState  # noqa: E402
from vqacl_tpu_torch.ops import adamw as AW  # noqa: E402
from vqacl_tpu_torch.train import graph as G  # noqa: E402
from vqacl_tpu_torch.train import step as ST  # noqa: E402
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves  # noqa: E402
from vqacl_tpu_torch.train.state import TrainState  # noqa: E402
from vqacl_tpu_torch.utils import profiling as P  # noqa: E402
from vqacl_tpu_torch.utils.config import Config, tiny_model_config  # noqa: E402


def _cfg(**train):
    cfg = Config()
    cfg.model = tiny_model_config()
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _state(cfg, seed=0):
    m = cfg.model
    params = V.init_vlt5_params(seed, m, device="cpu")
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cpu")
    return TrainState.create(params, make_transform(cfg.train), proto,
                             seed=seed, warmup_iters=1.0, t_total=10.0)


def _batch(cfg, B=4, seed=0):
    m = cfg.model
    return next(SyntheticVQA(B, seed=seed, feat_dim=m.feat_dim,
                             n_boxes=m.n_boxes, text_len=m.max_text_length,
                             vocab_size=m.vocab_size, answer_vocab=8
                             ).batches(B, seed=seed))["tensors"]


def _all(state):
    return [t.clone() for t in G.state_leaves(state)]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def rec():
    P.take()
    P.enable()
    yield P
    P.enable(False)
    P.take()


# -- which calls stay eager ----------------------------------------------

def test_cpu_states_stay_eager(rec):
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    assert isinstance(step, G.GraphedStep) and step.eligible
    state = _state(cfg)
    for _ in range(2):
        state, _ = step(state, _batch(cfg))
    assert (step.eager_steps, step.captures, step.replays) == (2, 0, 0)
    assert step.slots is None
    assert rec.take().counters["graph.eager_steps"] == 2


@pytest.mark.parametrize("kw", [
    dict(remat=True), dict(remat="dots"), dict(grad_accum=2),
    dict(mesh=True), dict(fsdp=True), dict(tp=True)])
def test_ineligible_steps_stay_eager(monkeypatch, rec, kw):
    install(monkeypatch)
    cfg = _cfg(grad_accum=kw.get("grad_accum", 1))
    mk = dict(dtype=torch.float32, device="cpu", remat=kw.get("remat", False))
    if kw.get("mesh"):
        mk["mesh_ctx"] = types.SimpleNamespace(distributed=True, dp=1, pp=1)
    for name in ("fsdp", "tp"):
        if kw.get(name):
            mk[name] = object()
    step = ST.make_train_step(cfg, **mk)
    assert not step.eligible
    if "mesh_ctx" in mk or "fsdp" in mk or "tp" in mk:
        return             # the layouts need ranks: eligibility alone
    state = _state(cfg)
    for _ in range(2):
        state, _ = step(state, _batch(cfg))
    assert (step.eager_steps, step.captures, step.replays) == (2, 0, 0)
    assert rec.take().counters == {"graph.eager_steps": 2,
                                   "optim.eager_leaves": 2 * len(
                                       tree_leaves(state.params))}


def test_a_regularizer_keeps_the_call_eager(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu",
                              reg_lambda=1.0)
    state = _state(cfg)
    reg = init_reg_state(state.params)
    state, _ = step(state, _batch(cfg), reg)
    state, _ = step(state, _batch(cfg), reg)
    assert (step.eager_steps, step.captures, step.replays) == (2, 0, 0)
    state, _ = step(state, _batch(cfg))         # no reg: graphed
    state, _ = step(state, _batch(cfg))
    assert (step.eager_steps, step.captures, step.replays) == (3, 1, 1)


def test_a_state_of_another_generator_stays_eager(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    state, _ = step(_state(cfg), _batch(cfg))
    other = _state(cfg, seed=1)
    _, m = step(other, _batch(cfg))
    assert (step.eager_steps, step.captures, step.replays) == (2, 1, 0)
    assert m["loss"].shape == ()


# -- graphed == eager ------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_steps_equal_eager_steps_bit_for_bit(monkeypatch, dtype):
    cfg = _cfg()
    batches = [_batch(cfg, seed=s) for s in (1, 2)]
    runs = {}
    for graphed in (False, True):
        if graphed:
            install(monkeypatch)
        step = ST.make_train_step(cfg, dtype=dtype, device="cpu")
        step.eligible = graphed
        state = _state(cfg, seed=3)
        out = []
        for i in range(5):      # train and replay batches in turns
            state, m = step(state, batches[i % 2])
            out.append(([m[k].clone() for k in G.METRICS], _all(state),
                        state.generator.get_state()))
        runs[graphed] = out
        if graphed:
            assert (step.eager_steps, step.captures, step.replays) \
                == (1, 1, 4)
    for (me, se, ge), (mg, sg, gg) in zip(runs[False], runs[True]):
        assert _equal(me, mg)
        assert _equal(se, sg)
        assert torch.equal(ge, gg)


def test_cached_batches_are_gathered_inside_the_step(monkeypatch):
    # a prepare function (the device cache's gather) runs in the body, so
    # the batch the graph keeps is the slots'
    install(monkeypatch)
    cfg = _cfg()
    full = _batch(cfg)
    feats = {"vis_feats": torch.from_numpy(full["vis_feats"]),
             "boxes": torch.from_numpy(full["boxes"])}

    def prepare(b):
        b = dict(b)
        idx = b.pop("slots").long()
        return dict(b, vis_feats=feats["vis_feats"][idx],
                    boxes=feats["boxes"][idx])

    slots = {k: v for k, v in full.items() if k not in feats}
    slots["slots"] = np.arange(4, dtype=np.int32)
    ref = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    ref.eligible = False
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu",
                              prepare=prepare)
    s0, s1 = _state(cfg), _state(cfg)
    for _ in range(3):
        s0, m0 = ref(s0, full)
        s1, m1 = step(s1, slots)
    assert torch.equal(m0["loss"], m1["loss"])
    assert _equal(_all(s0), _all(s1))
    (key,) = step.entries
    assert [k for k, _, _ in key] == sorted(ST._TRAIN_KEYS[:1]
                                            + ST._TRAIN_KEYS[3:]
                                            + ("slots",))


# -- signatures ------------------------------------------------------------

def test_graphs_are_keyed_by_the_batch_signature_and_bounded(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    state = _state(cfg)
    sizes = [2, 2, 4, 4, 2, 6, 8, 10, 10, 4]
    for B in sizes:
        state, _ = step(state, _batch(cfg, B=B))
    # 2, 4, 6 and 8 each captured once; 10 is past the bound: eager
    assert step.captures == G.MAX_SIGNATURES == len(step.entries)
    assert sorted(k[0][1][0] for k in step.entries) == [2, 4, 6, 8]
    assert step.replays == 4          # 2 twice more, 4 twice more
    assert step.eager_steps == 4 + 2  # four warm-ups, two of size 10
    b = _batch(cfg, B=2)
    b["scores"] = b["scores"].astype(np.float64)      # another dtype
    assert G.signature(b, ST._TRAIN_KEYS) \
        != G.signature(_batch(cfg, B=2), ST._TRAIN_KEYS)
    t = {k: torch.from_numpy(v) for k, v in _batch(cfg, B=2).items()}
    assert G.signature(t, ST._TRAIN_KEYS) \
        == G.signature(_batch(cfg, B=2), ST._TRAIN_KEYS)


# -- the aliasing contract -------------------------------------------------

def test_a_foreign_state_is_copied_in_and_left_as_it_was(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    s0 = _state(cfg)
    before = _all(s0)
    s1, _ = step(s0, _batch(cfg))
    s2, _ = step(s1, _batch(cfg))
    s3, _ = step(s2, _batch(cfg))
    assert _equal(_all(s0), before)
    assert s1 is step.slots[1].state and s2 is step.slots[0].state
    assert s3 is s1                          # two slots, in turns
    # a state made from a slot (here: a fresh optimizer) is copied in
    fresh = s3.reset_optimizer(make_transform(cfg.train), 1.0, 10.0)
    own = lambda s: [s.step, s.sched, s.opt_state.count,  # noqa: E731
                     *tree_leaves(s.opt_state.mu),
                     *tree_leaves(s.opt_state.nu)]
    kept = [t.clone() for t in own(fresh)]
    s4, _ = step(fresh, _batch(cfg))
    assert _equal(own(fresh), kept)      # its parameters are slot 1's
    assert s4 is step.slots[1].state
    assert int(s4.step) == 1 and int(s4.opt_state.count) == 1
    assert step.captures == 1 and step.replays == 3


def test_a_returned_state_lasts_one_more_step(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    s, _ = step(_state(cfg), _batch(cfg))
    s, _ = step(s, _batch(cfg))
    kept = _all(s)
    nxt, _ = step(s, _batch(cfg))
    assert _equal(_all(s), kept)            # read by the step after it
    step(nxt, _batch(cfg))
    assert not _equal(_all(s), kept)        # overwritten by the next one


def test_metrics_are_fresh_each_step(monkeypatch):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    state, losses = _state(cfg), []
    for s in range(5):
        state, m = step(state, _batch(cfg, seed=s))
        losses.append((m["loss"], float(m["loss"])))
        assert set(m) == set(G.METRICS)
    assert step.replays == 4
    assert [float(t) for t, _ in losses] == [v for _, v in losses]
    assert len({v for _, v in losses}) == 5
    ptrs = {t.data_ptr() for t, _ in losses}
    assert len(ptrs) == 5


# -- counters and spans ----------------------------------------------------

def test_replays_count_what_the_eager_step_counts(monkeypatch, rec):
    # the fused optimizer's launch counter and the recorder's counts, as a
    # wrapper on the card counts them, through replays and eager steps
    def counted(tcfg, grads, opt_state, params, step, sched, g_norm=None,
                out=None):
        AW.fused_adamw.launches += 1 + (g_norm is None)
        P.count("optim.fused_leaves", len(tree_leaves(params)))
        return AW.adamw_reference(tcfg, grads, opt_state, params, step,
                                  sched, g_norm, out)

    monkeypatch.setattr(ST, "adamw_step", counted)
    monkeypatch.setattr(AW.fused_adamw, "launches", 0)
    cfg = _cfg()
    got = {}
    for graphed in (False, True):
        if graphed:
            install(monkeypatch)
        step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
        step.eligible = graphed
        AW.fused_adamw.launches = 0
        state = _state(cfg)
        for _ in range(4):
            state, _ = step(state, _batch(cfg))
        got[graphed] = (AW.fused_adamw.launches, rec.take().counters)
    n = len(tree_leaves(state.params))
    assert got[False][0] == got[True][0] == 8
    assert got[False][1] == {"graph.eager_steps": 4,
                             "optim.fused_leaves": 4 * n,
                             "optim.eager_leaves": 4 * n}
    assert got[True][1] == {"graph.eager_steps": 1, "graph.captures": 1,
                            "graph.replays": 3,
                            "optim.fused_leaves": 4 * n,
                            "optim.eager_leaves": 4 * n}


def test_a_replay_is_one_span_in_the_train_span(monkeypatch, rec):
    install(monkeypatch)
    cfg = _cfg()
    step = ST.make_train_step(cfg, dtype=torch.float32, device="cpu")
    state, _ = step(_state(cfg), _batch(cfg))
    first = [s[0] for s in rec.take().spans]
    assert set(first) == {"step.train", "step.inputs", "step.forward",
                          "step.backward", "step.optimizer"}
    step(state, _batch(cfg))
    spans = sorted(rec.take().spans, key=lambda s: s[3])
    assert [s[0] for s in spans] == ["step.train", "step.graph_replay"]
    assert spans[1][2] == spans[0][1]


def test_diverted_counts_go_aside_recorder_on_or_off():
    P.take()
    with P.diverted() as d:
        P.count("a", 2)
        with P.span("x"):
            P.count("a")
    assert d == {"a": 3}
    P.enable()
    try:
        with P.diverted() as d2:
            with P.span("y"):
                P.count("b")
        P.count("c")
    finally:
        P.enable(False)
    taken = P.take()
    assert d2 == {"b": 1} and taken.counters == {"c": 1}
    assert taken.spans == []


# -- the head loss's rescale as a host scalar --------------------------------

@pytest.mark.parametrize("d_model", [768, 512, 1024, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rescale_as_a_host_scalar_is_bit_equal(monkeypatch, d_model, dtype):
    r = d_model ** -0.5
    g = torch.Generator().manual_seed(d_model)
    B, T, D, Vn = 3, 5, 16, 40
    hidden = (torch.randn(B, T, D, generator=g) * 4).to(dtype)
    shared = torch.randn(Vn, D, generator=g)
    labels = torch.randint(0, Vn, (B, T), generator=g)
    labels[0, 3:] = -100
    scores = torch.rand(B, generator=g)

    def run():
        h = hidden.clone().requires_grad_()
        s = shared.clone().requires_grad_()
        sc = scores.clone().requires_grad_()
        loss = V.fused_head_loss(h, s, labels, sc, r)
        return (loss,) + torch.autograd.grad(loss, (h, s, sc))

    scalar = run()
    # the former form: a 0-dim tensor of the compute dtype
    monkeypatch.setattr(V, "rounded",
                        lambda x, dt: torch.tensor(x, dtype=dt))
    tensor = run()
    for a, b in zip(scalar, tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
