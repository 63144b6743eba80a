"""The fused optimizer's wrapper (``ops/adamw.py``) on the CPU.

The kernels of ``csrc/fused_adamw.cu`` run only on a card
(``chip_smoke.py`` holds them bit for bit against the eager chain there,
in every combination of ``adam_impl``, moment dtype, ``freeze`` and
clip). Here: the chunk plan the kernel is handed covers every element of
every leaf once, in sorted-leaf order, with each leaf's decay and
trainable flags, and its table encodes exactly that; column slices of a
wider gradient are handed over in place, other layouts copied; the
kernel route refuses what it cannot take before anything is built; the
trees it returns are rebuilt with no reference cycle; the wrapper's CPU
route returns the plain version's results in the kernel route's order;
the recorder's counters name the route that ran; the kernel's constants
match the wrapper's.
"""

import dataclasses
import gc
import os
import re
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.models.vlt5 import init_vlt5_params  # noqa: E402
from vqacl_tpu_torch.ops import adamw  # noqa: E402
from vqacl_tpu_torch.train import optim  # noqa: E402
from vqacl_tpu_torch.utils import profiling as P  # noqa: E402
from vqacl_tpu_torch.utils.config import (TrainConfig,  # noqa: E402
                                          tiny_model_config)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vqacl_tpu_torch", "csrc", "fused_adamw.cu")


def _small_tree(rng, scale=1.0):
    """Names that exercise both masks: decayed weights and layer norms,
    undecayed ``*_b`` and ``rel_bias``, the ``shared`` embedding that
    ``freeze`` keeps training; numels that are not multiples of 4."""
    n = lambda *s: torch.from_numpy(
        (scale * rng.normal(size=s)).astype(np.float32))
    return {"shared": n(12, 5),
            "encoder": {"rel_bias": n(8, 2), "final_ln": n(7),
                        "block_0": {"attn": {"wq": n(4, 6)}, "ln1": n(4)}},
            "visual_embedding": {"feat_w": n(5, 3), "feat_b": n(3)}}


def _trees():
    rng = np.random.default_rng(0)
    big = {"shared": torch.zeros(3 * adamw.CHUNK + 5),
           "a_b": torch.zeros(adamw.CHUNK), "z": torch.zeros(0)}
    return {"small": _small_tree(rng),
            "tiny_vlt5": init_vlt5_params(0, tiny_model_config(),
                                          device="cpu"),
            "leaves_past_a_chunk": big}


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("name", sorted(_trees()))
def test_plan_covers_every_element_once_in_leaf_order(name, freeze):
    params = _trees()[name]
    leaves = optim.tree_leaves(params)
    numels = tuple(x.numel() for x in leaves)
    plan = adamw.adamw_plan(numels, adamw.leaf_flags(params, freeze))
    assert adamw.adamw_plan(numels, adamw.leaf_flags(params, freeze)) \
        is plan                                  # computed once
    decay = optim.tree_leaves(optim.decay_mask(params))
    train = optim.tree_leaves(optim.freeze_mask(params)) if freeze else \
        [True] * len(leaves)
    assert plan.numels == numels
    assert plan.flags == tuple(adamw.DECAY * d + adamw.TRAINABLE * t
                               for d, t in zip(decay, train))
    # each leaf's elements exactly once, chunk after chunk in order
    seen = [0] * len(leaves)
    last = -1
    for leaf, start, n in plan.chunks:
        assert leaf >= last and 0 < n <= adamw.CHUNK
        assert start == seen[leaf]
        seen[leaf] += n
        last = leaf
    assert seen == list(plan.numels)
    # outputs: the leaves one after the other, as the views cut them
    assert plan.offsets == tuple(np.cumsum((0,) + plan.numels[:-1]))
    assert plan.total == sum(plan.numels)
    # the kernel's table decodes to the same chunks
    t = plan.table().astype(np.uint64)
    assert t.shape == (len(plan.chunks), 3)
    for row, (leaf, start, n) in zip(t, plan.chunks):
        assert int(row[0]) & 0xffffffff == leaf
        assert int(row[0]) >> 32 == plan.flags[leaf]
        assert (int(row[1]) & 0xffffffff, int(row[1]) >> 32) == (start, n)
        assert int(row[2]) == plan.offsets[leaf] + start


def _state_of(params, moments=torch.bfloat16):
    return optim.AdamState(
        torch.zeros((), dtype=torch.int32),
        optim.tree_map(lambda p: torch.zeros(p.shape, dtype=moments),
                       params),
        optim.tree_map(lambda p: torch.zeros(p.shape, dtype=moments),
                       params))


def _bad_inputs(case):
    """(tcfg, grads, state, params, step, sched, g_norm) with one fault."""
    tcfg = TrainConfig()
    params = _small_tree(np.random.default_rng(4))
    grads = optim.tree_map(torch.zeros_like, params)
    state = _state_of(params)
    step = torch.zeros((), dtype=torch.int32)
    sched = torch.tensor([2.0, 10.0])
    g_norm = None
    if case == "adam_impl":
        tcfg = dataclasses.replace(tcfg, adam_impl="adafactor")
    elif case == "moments_f16":
        state = _state_of(params, torch.float16)
    elif case == "grads_bf16":
        grads = optim.tree_map(lambda g: g.bfloat16(), grads)
    elif case == "a_grad_missing":
        grads = dict(grads)
        del grads["shared"]
    elif case == "shapes_differ":
        grads = dict(grads, shared=torch.zeros(5, 12))
    elif case == "step_int64":
        step = step.long()
    elif case == "sched_short":
        sched = sched[:1]
    elif case == "g_norm_f64":
        g_norm = torch.zeros((), dtype=torch.float64)
    return tcfg, grads, state, params, step, sched, g_norm


@pytest.mark.parametrize("case", [
    "adam_impl", "moments_f16", "grads_bf16", "a_grad_missing",
    "shapes_differ", "step_int64", "sched_short", "g_norm_f64"])
def test_kernel_route_refuses_what_it_cannot_take(case):
    # the wrapper's checks, which run before anything is built or
    # launched (the device's type aside, which only a card can pass)
    args = _bad_inputs(case)
    adamw._inputs(*_bad_inputs(None))               # the unfaulted call
    with pytest.raises(ValueError):
        adamw._inputs(*args)


def test_trees_past_the_kernels_leaf_table_are_refused():
    n = adamw.MAX_LEAVES
    adamw.adamw_plan((3,) * n, (adamw.TRAINABLE,) * n)
    with pytest.raises(ValueError, match=f"at most {n}"):
        adamw.adamw_plan((3,) * (n + 1), (adamw.TRAINABLE,) * (n + 1))


@pytest.mark.parametrize("layout,read", [
    ("contiguous", (0, 0)), ("merged_qkv_slice", (8, 24)),
    ("unaligned_slice", (8, 13)), ("transposed", "copy"),
    ("slice_of_3d", "copy")])
def test_grad_rows_reads_column_slices_in_place(layout, read):
    # a merged q/k/v projection's gradient arrives as column slices of
    # one matrix: the kernel reads their rows in place, no copy
    base = torch.arange(6 * 24, dtype=torch.float32).reshape(6, 24)
    g = {"contiguous": base[:, :8].contiguous(),
         "merged_qkv_slice": base[:, 8:16],
         "unaligned_slice": base[:, :13].contiguous()[:, 3:11],
         "transposed": base[:, :8].t(),
         "slice_of_3d": base.reshape(6, 4, 6)[:, 1:3, :]}[layout]
    out, cols, stride = adamw.grad_rows(g)
    assert torch.equal(out, g)
    if read == "copy":
        assert out.is_contiguous() and (cols, stride) == (0, 0)
        return
    assert out is g and (cols, stride) == read
    if cols:     # row r, column c of the leaf at r * stride + c
        flat = torch.as_strided(g, (g.untyped_storage().nbytes() // 4,),
                                (1,), 0)
        r, c = 5, 7
        assert flat[g.storage_offset() + r * stride + c] == g[r, c]


def test_rebuilt_trees_leave_no_reference_cycle():
    # the kernel route's outputs are views of one flat buffer each: a
    # cycle holding one tree (a recursive closure over its leaves) would
    # keep the whole buffer until the garbage collector runs
    like = {"b": {"c": 0, "a": 0}, "d": 0}
    gc.disable()
    try:
        leaves = tuple(torch.zeros(2) for _ in range(3))
        refs = [weakref.ref(x) for x in leaves]
        tree = optim.tree_unflatten(like, leaves)
        assert optim.tree_leaves(tree) == list(leaves)
        assert list(tree) == ["b", "d"] and list(tree["b"]) == ["c", "a"]
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_cpu_route_returns_the_plain_versions_results():
    # the wrapper's plumbing; the chain itself is held against JAX through
    # _apply_update by the train-step tests, the kernel against the chain
    # on the card by chip_smoke.py
    tcfg = dataclasses.replace(TrainConfig(), lr=1e-2, weight_decay=0.01,
                               schedule="linear_warmup")
    tx = optim.make_transform(tcfg)
    rng = np.random.default_rng(3)
    params = _small_tree(rng)
    grads = _small_tree(rng)
    st = tx.init(params)
    step = torch.tensor(3, dtype=torch.int32)
    sched = torch.tensor([2.0, 6.0])
    gn = optim.global_norm(grads)
    u, st_want = tx.update(grads, st, params, gn)
    lr_want = optim.dynamic_lr(step.float(), sched, tcfg.lr, tcfg.schedule)
    p_want = optim.tree_map(lambda p, x: p - lr_want * x, params, u)
    given = torch.tensor(7.0)
    for g_norm in (None, given):
        p, st_new, lr, out_norm = adamw.adamw_step(tcfg, grads, st, params,
                                                   step, sched, g_norm)
        assert torch.equal(lr, lr_want)
        if g_norm is None:
            assert torch.equal(out_norm, gn)
            for a, b in ((p, p_want), (st_new.mu, st_want.mu),
                         (st_new.nu, st_want.nu)):
                assert all(torch.equal(x, y) for x, y in zip(
                    optim.tree_leaves(a), optim.tree_leaves(b)))
            assert torch.equal(st_new.count, st_want.count)
        else:       # the caller's norm, passed through and used
            assert out_norm is given
            assert not torch.equal(optim.tree_leaves(st_new.mu)[0],
                                   optim.tree_leaves(st_want.mu)[0])
        assert list(p) == list(params)               # the tree's key order


@pytest.fixture
def rec():
    P.take()
    P.enable()
    yield P
    P.enable(False)
    P.take()


def test_counters_name_the_route(rec):
    tcfg = TrainConfig()
    rng = np.random.default_rng(5)
    params = _small_tree(rng)
    st = optim.make_transform(tcfg).init(params)
    one = torch.zeros((), dtype=torch.int32)
    sched = torch.tensor([0.0, 10.0])
    for _ in range(2):
        params, st, _, _ = adamw.adamw_step(tcfg, _small_tree(rng), st,
                                            params, one, sched)
    # refused before anything is built or counted
    with pytest.raises(ValueError, match="CUDA tensors only"):
        adamw.fused_adamw(tcfg, _small_tree(rng), st, params, one, sched)
    counters = P.take().counters
    assert counters == {"optim.eager_leaves": 2 * 7}
    assert "optim.fused_leaves" not in counters


def test_other_devices_are_refused():
    tcfg = TrainConfig()
    meta = {"w": torch.empty(4, device="meta")}
    st = optim.AdamState(torch.zeros((), dtype=torch.int32, device="meta"),
                         meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        adamw.adamw_step(tcfg, meta, st, meta,
                         torch.zeros((), dtype=torch.int32), torch.ones(2))


def test_kernel_constants_match_the_wrapper():
    src = open(CSRC).read()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kMaxLeaves") == adamw.MAX_LEAVES
    assert const("kNormBlocks") == adamw.NORM_BLOCKS
    # the leaf table (four addresses and a gradient's row length and
    # stride per leaf) travels in the kernel's parameters: under CUDA's
    # 32,764-byte limit with room for the other arguments
    assert (4 * 8 + 2 * 4) * adamw.MAX_LEAVES + 256 <= 32764
