"""VL-Moonlight (models/moonlight.py, ops/moe.py) on the CPU at tiny
sizes: the port's loss and every leaf's gradient against the plain f32
reference (reference_torch/moonlight.py), the layers' spans over the
backward, the expert-parallel share test, routing edge cases of the
grouped experts, the refusals, the CL trainer through train, replay and
validation, the selection bias through a checkpoint, and the fused
optimizer's plan at the cell's tree."""

import tempfile
import time

import pytest
import torch

from reference_torch import moonlight as R
from vqacl_tpu_torch.models import moonlight as ML
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import moe as M
from vqacl_tpu_torch.train.optim import tree_leaves, tree_map
from vqacl_tpu_torch.utils import profiling
from vqacl_tpu_torch.utils.config import Config, tiny_model_config

# 1 dense + 2 MoE layers, 8 experts of which 4 held, top-2, 1 shared
TINY = dict(arch="moonlight", d_model=32, num_heads=2, vocab_size=300,
            num_hidden_layers=3, first_k_dense_replace=1,
            intermediate_size=48, moe_intermediate_size=16,
            router_experts=8, experts_held=4, num_experts_per_tok=2,
            n_shared_experts=1, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, layer_norm_epsilon=1e-5,
            use_prototype=False)
# Both sides compute in f32 on the CPU with the same equations; they
# differ in the order of sums (the port sorts the choices by expert and
# gathers them back; the reference adds each expert's rows in turn) and
# in the RoPE layout (de-interleaved and rotated vs rotated pairs), so
# they agree to f32 round-off: 1e-5 relative on the loss, 1e-4 on each
# leaf's gradient (its norm's relative gap). A wrong term, a missing
# expert or a wrong weight moves a gradient by O(1).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny runs are bound by the host's dispatch: one intra-op thread
    (a thread per core oversubscribes a host the test workers share)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return tiny_model_config(**{**TINY, **kw})


def _batch(cfg, B=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    L, N, T = cfg.max_text_length, cfg.n_boxes, cfg.target_max_length
    b = {"input_ids": torch.randint(3, 200, (B, L), generator=g),
         "vis_feats": torch.randn(B, N, cfg.feat_dim, generator=g),
         "boxes": torch.rand(B, N, 4, generator=g),
         "target_ids": torch.randint(3, 200, (B, T), generator=g),
         "scores": torch.rand(B, generator=g)}
    b["input_ids"][0, 4:] = 0          # question pads, masked as keys
    b["target_ids"][1, 3:] = -100
    return b


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [".".join(prefix)]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_every_gradient_match_the_reference(seed):
    cfg = _cfg()
    params = ML.init_params(seed, cfg, "cpu")
    batch = _batch(cfg, seed=seed)
    bias = torch.randn(ML.moe_layers(cfg), cfg.router_experts,
                       generator=torch.Generator().manual_seed(seed)) * 0.01
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    proto = ProtoState.create(10, 80, cfg.d_model, device="cpu")
    out = ML.forward_train(live, cfg, batch, proto, bias,
                           dtype=torch.float32)
    grads = torch.autograd.grad(out.loss, tree_leaves(live))
    loss, balance, load, _, ref = R.loss_and_grads(params, cfg, batch, bias)
    assert abs(float(out.loss.detach()) - float(loss)) \
        <= LOSS_RTOL * float(loss)
    assert abs(float(out.balance) - float(balance)) <= 1e-5 * float(balance)
    assert torch.equal(out.load, load)
    paths = _paths(params)
    assert sorted(paths) == sorted(ref)
    for path, g in zip(paths, grads):
        r = ref[path]
        assert float(r.norm()) > 0, path
        gap = float((g - r).norm()) / float(r.norm())
        assert gap <= GRAD_RTOL, (path, gap)
    # the selection bias moves against the load
    new = ML.update_bias(bias, out.load, 1e-3)
    assert torch.allclose(new, R.update_bias(bias, load, 1e-3))
    over = out.load > out.load.mean(-1, keepdim=True)
    assert bool((new[over] < bias[over]).all())


def test_layer_spans_cover_the_backward():
    # with the recorder on, each attention (``mla``) and each MoE layer
    # (``moe``) is a span in the forward and again over its backward; the
    # MoE layer's parts are spans of the forward inside ``moe``
    cfg = _cfg()
    live = tree_map(lambda t: t.detach().requires_grad_(),
                    ML.init_params(0, cfg, "cpu"))
    bias = torch.zeros(ML.moe_layers(cfg), cfg.router_experts)
    proto = ProtoState.create(10, 80, cfg.d_model, device="cpu")
    profiling.take()
    profiling.enable()
    try:
        out = ML.forward_train(live, cfg, _batch(cfg), proto, bias,
                               dtype=torch.float32)
        t_bwd = time.perf_counter_ns()
        torch.autograd.grad(out.loss, tree_leaves(live))
    finally:
        profiling.enable(False)
    spans = profiling.take().spans
    n_moe, n_layers = ML.moe_layers(cfg), cfg.num_hidden_layers
    for name, fwd, bwd in (("mla", n_layers, n_layers),
                           ("moe", n_moe, n_moe)):
        starts = [s for nm, _, _, s, _ in spans if nm == name]
        assert sum(s < t_bwd for s in starts) == fwd, name
        assert sum(s > t_bwd for s in starts) == bwd, name
    ids = {sid: nm for nm, sid, _, _, _ in spans}
    for part in ("moe.router", "moe.dispatch", "moe.experts", "moe.shared",
                 "moe.combine"):
        got = [(s, ids[parent]) for nm, _, parent, s, _ in spans
               if nm == part]
        assert len(got) == n_moe and all(s < t_bwd and par == "moe"
                                         for s, par in got), part


def test_two_shares_of_the_experts_add_up_to_the_uncut_layer():
    """Expert parallelism 2 over 8 experts: share A holds experts 0-3,
    share B experts 4-7 (its router's rows turned so that they are its
    ids 0-3). Their routed parts summed, with the shared expert counted
    once, are the uncut reference's MoE layer."""
    full = _cfg(experts_held=8)
    params = ML.init_params(3, full, "cpu")
    p = params["layers"][ML.layer_name(1)]["moe"]
    x = torch.randn(2, 7, full.d_model,
                    generator=torch.Generator().manual_seed(5))
    bias = torch.randn(8, generator=torch.Generator().manual_seed(6)) * 0.01
    want = R.moe(p, full, x, bias)[0]
    half = _cfg(experts_held=4)
    turn = torch.tensor([4, 5, 6, 7, 0, 1, 2, 3])

    def share(lo):
        ex = {k: v[lo:lo + 4] for k, v in p["experts"].items()}
        router = p["router"] if lo == 0 else p["router"][turn]
        b = bias if lo == 0 else bias[turn]
        return ML.moe({"router": router, "experts": ex,
                       "shared": p["shared"]}, half, x, b, torch.float32)[0]

    shared = ML.swiglu(p["shared"], x, torch.float32)
    got = share(0) + share(4) - shared
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def _per_token(x, idx, w, ex, held):
    """Each token's held choices through their experts, one at a time."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            if e < held:
                h = x[t:t + 1]
                a = torch.nn.functional.silu(h @ ex["w_gate"][e]) \
                    * (h @ ex["w_up"][e])
                out[t] += w[t, j] * (a @ ex["w_down"][e])[0]
    return out


@pytest.mark.parametrize("case", ["all_to_one", "some_empty", "none_held"])
def test_grouped_experts_drop_no_token(case):
    T, k, E, D, F = 10, 3, 4, 16, 8
    g = torch.Generator().manual_seed(2)
    x = torch.randn(T, D, generator=g)
    ex = {"w_gate": torch.randn(E, D, F, generator=g) * 0.3,
          "w_up": torch.randn(E, D, F, generator=g) * 0.3,
          "w_down": torch.randn(E, F, D, generator=g) * 0.3}
    if case == "all_to_one":      # every token's first choice: expert 2
        idx = torch.stack([torch.full((T,), 2), torch.full((T,), 5),
                           torch.full((T,), 6)], 1)
    elif case == "some_empty":    # experts 0 and 3 get no rows
        idx = torch.stack([torch.randint(1, 3, (T,), generator=g),
                           torch.randint(4, 9, (T,), generator=g),
                           torch.full((T,), 7)], 1)
    else:
        idx = torch.randint(4, 9, (T, k), generator=g)
    w = torch.rand(T, k, generator=g)
    plan = M.route_plan(idx, E)
    held = int((idx < E).sum())
    counts = plan.offsets[1:] - plan.offsets[:-1]
    assert int(plan.offsets[-1]) == held
    for e in range(E):
        assert int(counts[e]) == int((idx == e).sum())
    # every held choice has its own row, holding its token
    rows = plan.pos[plan.held]
    assert sorted(rows.tolist()) == list(range(held))
    toks = torch.arange(T)[:, None].expand(T, k)[plan.held]
    assert torch.equal(plan.rows[rows].long(), toks)
    out = M.grouped_swiglu(x, plan, ex["w_gate"], ex["w_up"], ex["w_down"])
    got = M.combine(out, plan, w)
    want = _per_token(x, idx, w, ex, E)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_prototypes_are_refused_with_moonlight():
    from vqacl_tpu_torch.train.step import make_train_step

    cfg = Config()
    cfg.model = _cfg(use_prototype=True)
    with pytest.raises(ValueError, match="no prototypes"):
        make_train_step(cfg, dtype=torch.float32, device="cpu")
    cfg.model.use_prototype = False
    with pytest.raises(ValueError, match="no prototypes"):
        make_train_step(cfg, dtype=torch.float32, device="cpu",
                        use_prototype=True)
    cfg.model.arch = "llama"
    with pytest.raises(ValueError, match="model.arch"):
        make_train_step(cfg, dtype=torch.float32, device="cpu")


def _trainer(cfg=None, data=None, n_train=48):
    """A VL-Moonlight ``VQACLTrainer`` over two synthetic tasks on the
    CPU → (trainer, cfg, data, tokenizer)."""
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer

    tok = VLT5Tokenizer()
    if cfg is None:
        cfg = Config()
        cfg.model = _cfg(vocab_size=32200)
        cfg.train.lr = 1e-3
        cfg.train.batch_size = cfg.train.valid_batch_size = 16
        cfg.train.epochs = 1
        cfg.train.m_size = 16
        cfg.output = tempfile.mkdtemp()
    if data is None:
        data = SyntheticDataModule(
            tok, tasks=["q_recognition", "q_location"],
            n_train_per_task=n_train, n_val_per_task=16,
            n_test_per_task=16, feat_dim=16, n_boxes=4, answer_vocab=4,
            seed=0)
    tr = VQACLTrainer(cfg, data, tok, verbose=False, device="cpu",
                      dtype=torch.float32)
    return tr, cfg, data, tok


def test_train_task_runs_train_replay_and_validation():
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer

    tr, cfg, data, tok = _trainer()
    b0 = tr.state.router_bias.clone()
    tr.train_task(0, first_trained=True)
    tr.train_task(1)
    assert tr.counts["train_steps"] > 0 and tr.counts["replay_steps"] > 0
    assert tr.counts["predict_batches"] > 0      # validation ran greedily
    losses = tr.step_losses["train"] + tr.step_losses["replay"]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert not torch.equal(tr.state.router_bias, b0)
    with pytest.raises(ValueError, match="cl_reg"):
        cfg.train.cl_reg = "ewc"
        VQACLTrainer(cfg, data, tok, verbose=False, device="cpu",
                     dtype=torch.float32)


def test_checkpoints_keep_the_selection_bias():
    # the bias is saved with the parameters; a reloaded trainer routes
    # as the trained one did, and a checkpoint without it is refused
    import numpy as np
    from vqacl_tpu_torch.train.checkpoint import save_checkpoint

    tr, cfg, data, _ = _trainer(n_train=16)
    task = tr.tasks[0]
    tr.train_task(0, first_trained=True)
    tr._save(save_checkpoint, "LAST", task)
    trained = tr.state.router_bias.clone()
    assert bool(trained.abs().sum() > 0)
    fresh, *_ = _trainer(cfg, data)
    assert bool(fresh.state.router_bias.abs().sum() == 0)
    fresh.test(task, load=True)
    assert torch.equal(fresh.state.router_bias, trained)
    for a, b in zip(tree_leaves(fresh.state.params),
                    tree_leaves(tr.state.params)):
        assert torch.equal(a, b)
    path = f"{cfg.output}/{task}_LAST.npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("extra")}
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="router_bias"):
        fresh._load(task)


def _cell_model():
    """The cell's model sizes (portbench/configs/vl_moonlight_a3b_vqa.json):
    14 layers, 8 of 64 experts held."""
    return tiny_model_config(
        arch="moonlight", d_model=2048, num_heads=16, vocab_size=163840,
        num_hidden_layers=14, first_k_dense_replace=1,
        intermediate_size=11264, moe_intermediate_size=1408,
        router_experts=64, experts_held=8, num_experts_per_tok=6,
        n_shared_experts=2, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, feat_dim=2048, n_boxes=36,
        use_prototype=False)


def test_fused_adamw_plan_at_the_cells_tree():
    """The fused optimizer's plan for the 2.06 B-element tree, from its
    sizes alone (nothing allocated): at most 512 leaves, leaves placed in
    order with no gap, every chunk's output offset right past 2³¹ in the
    bf16 moments buffer's second half, and the norms undecayed."""
    import numpy as np

    from vqacl_tpu_torch.ops import adamw as A
    from vqacl_tpu_torch.train.optim import decay_mask

    cfg = _cell_model()
    lay = ML.layout(cfg)
    numels = tuple(int(np.prod(s)) for _, s, _ in lay)
    total = sum(numels)
    assert 2.0e9 < total < 2 ** 31        # f32 buffer's indices fit int32
    assert 2 * total > 2 ** 31            # the moments' do not
    tree = {}
    for path, shape, _ in lay:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(0)  # a stand-in: only names are read
    flags = A.leaf_flags(tree, freeze=False)
    assert len(flags) == len(numels) <= A.MAX_LEAVES
    plan = A.adamw_plan(numels, flags)
    assert plan.total == total
    assert plan.offsets == tuple(np.cumsum((0,) + numels[:-1]).tolist())
    table = plan.table()
    assert table.dtype == np.int64
    leaf = table[:, 0] & 0xffffffff
    start = table[:, 1] & 0xffffffff
    n = table[:, 1] >> 32
    off = np.asarray(plan.offsets, dtype=np.int64)
    assert np.array_equal(table[:, 2], off[leaf] + start)
    assert int(table[-1, 2] + n[-1]) == total
    assert int(n.sum()) == total and int(n.max()) <= A.CHUNK
    # v's elements follow m's in one bf16 buffer of 2·total elements:
    # the last element's index, as the wrapper's pointer arithmetic
    # makes it, is past 2³¹ and exact in Python's integers
    assert total + int(table[-1, 2] + n[-1]) - 1 == 2 * total - 1
    decay = dict(zip(_paths(tree), tree_leaves(decay_mask(tree))))
    for path, d in decay.items():
        name = path.split(".")[-1]
        assert d == (not (name.endswith("_norm") or name.endswith("_b"))), \
            path
    assert not decay["layers.layer_05.attn.kv_norm"]
    assert decay["layers.layer_05.moe.experts.w_gate"]


def test_a_moonlight_config_round_trips(tmp_path):
    """A saved VL-Moonlight configuration loads back whole; a VL-T5 one
    leaves the backbone's fields out (the JAX package reads it)."""
    pytest.importorskip("yaml")
    from vqacl_tpu_torch.utils.config import MOONLIGHT_FIELDS

    cfg = Config()
    cfg.model = _cfg()
    path = str(tmp_path / "m.yaml")
    cfg.save(path)
    assert Config.load(path) == cfg
    assert set(MOONLIGHT_FIELDS) <= set(cfg.to_dict()["model"])
    assert not set(MOONLIGHT_FIELDS) & set(Config().to_dict()["model"])
