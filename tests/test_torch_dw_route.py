"""K5's routes and its stream-K plan, on the CPU (nothing is built).

``ops.dw.dw_route`` picks the wgmma, mma or f32 kernel of
``csrc/dw_splitk.cu`` from the dtype, D, F and the operands' alignment,
and raises for what no route takes. ``ops.dw.dw_plan`` is the plan the
wgmma kernel runs (it is passed to the kernel as it is computed here):
every (tile, k-block) iteration once, one contiguous range per unit (a
cluster of two blocks), the ranges within one iteration of each other,
one summing unit per split tile that adds the others' partials in the
order of their k ranges. A plain emulation of that arithmetic (each
piece summed over its k-blocks in order in f32, the pieces added in k
order) is held against ``pallas_dw`` in interpret mode within the
tolerance ``chip_smoke.py`` holds the kernel to, 1e-5·Σ_k|x·g| + 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_dw import pallas_dw  # noqa: E402
from vqacl_tpu_torch.ops import dw  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _tensors(K, D, F, dtype, x_offset=0, g_offset=0):
    """x [K,D] and g [K,F] as contiguous views that start ``*_offset``
    elements into a larger buffer."""
    xb = torch.zeros(K * D + x_offset, dtype=dtype)
    gb = torch.zeros(K * F + g_offset, dtype=dtype)
    return (xb[x_offset:].view(K, D), gb[g_offset:].view(K, F))


@pytest.mark.parametrize("dtype,K,D,F,x_off,g_off,want", [
    (BF16, 4480, 768, 3072, 0, 0, "wgmma"),     # the probe
    (BF16, 16, 64, 128, 0, 0, "wgmma"),         # one k-step, one tile
    (BF16, 100, 40, 72, 0, 0, "wgmma"),         # DW_ODD's first
    (BF16, 97, 131, 257, 0, 0, "mma"),          # DW_ODD's second
    (BF16, 64, 36, 72, 0, 0, "mma"),            # D not a multiple of 8
    (BF16, 64, 40, 70, 0, 0, "mma"),            # F not a multiple of 8
    (BF16, 64, 40, 72, 1, 0, "mma"),            # x's base off 16 bytes
    (BF16, 64, 40, 72, 0, 4, "mma"),            # g's base off 16 bytes
    (BF16, 64, 40, 72, 8, 8, "wgmma"),          # both on 16 bytes
    (F32, 4480, 768, 3072, 0, 0, "f32"),
    (F32, 97, 131, 257, 1, 0, "f32"),
])
def test_dw_route_picks_by_dtype_shape_and_alignment(dtype, K, D, F, x_off,
                                                     g_off, want):
    x, g = _tensors(K, D, F, dtype, x_off, g_off)
    assert x.is_contiguous() and g.is_contiguous()
    assert dw.dw_route(K, D, F, dtype, x, g) == want
    if not (x_off or g_off):     # alignment only narrows the choice
        assert dw.dw_route(K, D, F, dtype) == want


@pytest.mark.parametrize("dtype,K,D,F,match", [
    (torch.float16, 64, 40, 72, "not supported"),
    (torch.float64, 64, 40, 72, "not supported"),
    (BF16, 0, 40, 72, "empty"),
    (F32, 64, 0, 72, "empty"),
    (BF16, 64, 40, 2 ** 31, "int32"),
])
def test_dw_route_refuses_what_no_route_takes(dtype, K, D, F, match):
    with pytest.raises(ValueError, match=match):
        dw.dw_route(K, D, F, dtype)


PLAN_SHAPES = [(4480, 768, 3072), (4480, 768, 768), (1000, 768, 3072),
               (100, 40, 72), (16, 64, 128)]


# the H100's SMs, the H100 PCIe's, half and a handful of them, and one
# cluster (a single unit runs everything)
SM_COUNTS = [132, 114, 66, 7, 2]


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("K,D,F", PLAN_SHAPES)
def test_dw_plan_covers_each_iteration_once_in_even_ranges(K, D, F, n_sm):
    plan = dw.dw_plan(K, D, F, n_sm)
    kbs = -(-K // dw.K_BLOCK)
    tiles = -(-D // dw.TILE_D) * -(-F // dw.TILE_N)
    total = tiles * kbs
    assert (plan.k_blocks, plan.tiles) == (kbs, tiles)
    # never more units (clusters of two blocks) than iterations or SMs
    assert plan.units == min(n_sm // dw.CLUSTER, total) >= 1
    assert plan.blocks == dw.CLUSTER * plan.units <= n_sm
    starts = np.asarray(plan.starts)
    assert starts[0] == 0 and starts[-1] == total
    sizes = np.diff(starts)
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    # the pieces: each unit's in order and contiguous, every iteration once
    seen = []
    for unit in range(plan.units):
        mine = [p for p in plan.pieces() if p[0] == unit]
        its = [t * kbs + k for _, t, k0, k1 in mine for k in range(k0, k1)]
        assert its == list(range(starts[unit], starts[unit + 1]))
        seen += its
        # only a unit's first piece may start inside a tile: one partial
        # slot per block
        assert all(k0 == 0 for _, _, k0, _ in mine[1:])
    assert sorted(seen) == list(range(total))


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("K,D,F", PLAN_SHAPES)
def test_dw_plan_names_one_summing_unit_per_split_tile(K, D, F, n_sm):
    plan = dw.dw_plan(K, D, F, n_sm)
    pieces = plan.pieces()
    by_tile = {}
    for unit, tile, k0, k1 in pieces:
        by_tile.setdefault(tile, []).append((unit, k0, k1))
    splits = plan.splits()
    assert set(splits) == {t for t, ps in by_tile.items() if len(ps) > 1}
    for tile, units in splits.items():
        ps = by_tile[tile]
        assert units == [u for u, _, _ in ps]
        # the units in k order, consecutive, their ranges abutting
        assert units == list(range(units[0], units[0] + len(units)))
        assert ps[0][1] == 0 and ps[-1][2] == plan.k_blocks
        assert all(a[2] == b[1] for a, b in zip(ps, ps[1:]))
        # the summing unit holds k-block 0 and reaches it last in its
        # range; each partial is its unit's first piece
        summer = units[0]
        assert [p for p in pieces if p[0] == summer][-1][1] == tile
        for u in units[1:]:
            assert [p for p in pieces if p[0] == u][0][1] == tile
    for tile, ps in by_tile.items():
        if tile not in splits:
            assert ps == [(ps[0][0], 0, plan.k_blocks)]


def test_dw_plan_at_the_probe_shape():
    """72 tiles of 128 × 256 would be the one-block tiling; a unit's tile
    is 256 rows, so 36 tiles × 70 k-blocks over 66 clusters of 132 SMs."""
    plan = dw.dw_plan(4480, 768, 3072, 132)
    assert (plan.tiles, plan.k_blocks, plan.units) == (36, 70, 66)
    assert set(np.diff(plan.starts)) == {38, 39}
    # every tile is split: 24 have two partials, 12 one
    splits = plan.splits()
    assert len(splits) == 36
    assert sorted(len(u) for u in splits.values()) == [2] * 12 + [3] * 24


@pytest.mark.parametrize("n_sm", [1, 0, -2])
def test_dw_plan_refuses_fewer_sms_than_a_cluster(n_sm):
    with pytest.raises(ValueError, match="n_sm"):
        dw.dw_plan(100, 40, 72, n_sm)


def emulate(x, g, plan):
    """The wgmma route's arithmetic in f32: each piece of each block (128
    rows of its unit's 256-row tile) summed over its k-blocks in order,
    then the summing unit's piece plus the others' partials in k order."""
    K, D = x.shape
    F = g.shape[1]
    xf, gf = x.float(), g.float()
    out = torch.zeros(D, F)
    part = {}
    for unit, tile, k0, k1 in plan.pieces():
        td, tf = divmod(tile, plan.tiles_f)
        for rank in range(dw.CLUSTER):
            d0 = (td * dw.CLUSTER + rank) * dw.BLOCK_D
            f0 = tf * dw.TILE_N
            acc = torch.zeros(dw.BLOCK_D, dw.TILE_N)
            for kb in range(k0, k1):
                xs = torch.zeros(dw.K_BLOCK, dw.BLOCK_D)
                gs = torch.zeros(dw.K_BLOCK, dw.TILE_N)
                rows = slice(kb * dw.K_BLOCK, min(K, (kb + 1) * dw.K_BLOCK))
                n = rows.stop - rows.start
                xd = xf[rows, d0:d0 + dw.BLOCK_D]
                gd = gf[rows, f0:f0 + dw.TILE_N]
                xs[:n, :xd.shape[1]] = xd
                gs[:n, :gd.shape[1]] = gd
                acc = acc + xs.t() @ gs
            part[(unit, rank, tile)] = acc
    for tile in range(plan.tiles):
        units = plan.splits().get(tile) or [
            u for u, t, _, _ in plan.pieces() if t == tile]
        td, tf = divmod(tile, plan.tiles_f)
        for rank in range(dw.CLUSTER):
            acc = part[(units[0], rank, tile)]
            for u in units[1:]:
                acc = acc + part[(u, rank, tile)]
            d0 = (td * dw.CLUSTER + rank) * dw.BLOCK_D
            f0 = tf * dw.TILE_N
            blk = out[d0:d0 + dw.BLOCK_D, f0:f0 + dw.TILE_N]
            blk.copy_(acc[:blk.shape[0], :blk.shape[1]])
    return out


@pytest.mark.parametrize("K,D,F,n_sm", [
    (96, 40, 72, 7),            # two k-blocks, one tile, a split
    (1000, 40, 72, 7),          # a K tail: 16 k-blocks over 3 units
    (256, 264, 264, 10),        # 2 x 2 tiles, ragged D and F, 5 units
    (16, 64, 128, 132),         # one k-step, one tile, one unit
])
def test_plan_emulation_matches_pallas_dw(K, D, F, n_sm):
    rng = np.random.default_rng(K + D + F)
    xn = rng.standard_normal((K, D), dtype=np.float32)
    gn = rng.standard_normal((K, F), dtype=np.float32)
    x = torch.from_numpy(xn).to(BF16)
    g = torch.from_numpy(gn).to(BF16)
    plan = dw.dw_plan(K, D, F, n_sm)
    if n_sm < 132:
        assert plan.splits()
    ref = np.asarray(pallas_dw(jnp.asarray(xn, jnp.bfloat16),
                               jnp.asarray(gn, jnp.bfloat16),
                               nt=3 if F % 3 == 0 else 2, kt=4))
    out = emulate(x, g, plan).numpy()
    scale = (x.float().abs().t() @ g.float().abs()).numpy()
    err = np.abs(out - ref)
    assert (err <= 1e-5 * scale + 1e-6).all(), float(err.max())


@pytest.mark.parametrize("dtype,D,F", [(BF16, 40, 72), (BF16, 131, 257),
                                        (F32, 40, 72)])
def test_wrapper_takes_the_plain_version_on_cpu(dtype, D, F):
    x, g = (torch.randn(100, D).to(dtype), torch.randn(100, F).to(dtype))
    before = dict(dw.dw_splitk.route_launches)
    out = dw.dw_splitk(x, g)
    assert torch.equal(out, dw.dw_splitk_reference(x, g))
    assert dw.dw_splitk.route_launches == before


def test_workspace_holds_partials_then_zeroed_flags():
    """One 128 × 256 f32 slot per block, then one int32 flag per block,
    zero when made; cached per (device, stream, blocks)."""
    plan = dw.dw_plan(4480, 768, 3072, 132)
    ws = dw._workspace(torch.device("cpu"), 0, plan)
    try:
        assert ws.dtype == torch.int32
        assert ws.numel() == plan.blocks * (dw.BLOCK_D * 256 + 1)
        assert not ws.any()
        assert dw._workspace(torch.device("cpu"), 0, plan) is ws
    finally:
        dw._workspaces.clear()
