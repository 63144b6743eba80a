"""The head loss's kernel route on the CPU: ``ops/head_loss.py``'s route
choice and plan as pure Python, the op on that route
(``head_loss_forward`` / ``head_loss_backward``: H1, H2 and K5 taking
their plain versions on CPU tensors, through
``models/vlt5.py::fused_head_loss`` with the route taken as on the card)
against JAX's ``fused_head_loss`` and the port's plain version: rescale
1 and d^-0.5, a label in the last, ragged chunk, a row of all -100, a
row-strided hidden, rows that are not a multiple of 8. The kernels
themselves run only on the card (``chip_smoke.py`` phase 2,
``smoke/kernels.py::check_head_loss``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vqacl_tpu.models import vlt5 as jvlt5  # noqa: E402
from vqacl_tpu_torch.models import vlt5 as tvlt5  # noqa: E402
from vqacl_tpu_torch.ops import dw  # noqa: E402
from vqacl_tpu_torch.ops import head_loss as HL  # noqa: E402
from vqacl_tpu_torch.utils import profiling as P  # noqa: E402

BF16 = torch.bfloat16


# ---- the route --------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,rows,D,V,want", [
    ("cuda", BF16, 800, 768, 32200, "wgmma"),       # VL-T5's train step
    ("cuda", BF16, 800, 2048, 163840, "wgmma"),     # VL-Moonlight's
    ("cuda", BF16, 130, 768, 32200, "wgmma"),       # a short last batch
    ("cuda", torch.float32, 800, 768, 32200, "plain"),
    ("cpu", BF16, 800, 768, 32200, "plain"),
    ("cpu", torch.float32, 40, 32, 50, "plain"),    # the tiny f32 surrogate
])
def test_route_by_device_and_dtype(device, dtype, rows, D, V, want):
    assert HL.head_loss_route(device, dtype, rows, D, V) == want


@pytest.mark.parametrize("device,dtype,rows,D,V,match", [
    ("cuda", BF16, 800, 32, 32200, "multiple of 64"),
    ("cuda", BF16, 800, 768, 32201, "multiple of 64 and V=32201 of 8"),
    ("cuda", torch.float16, 800, 768, 32200, "not supported"),
    ("mps", BF16, 800, 768, 32200, "unsupported device"),
    ("cuda", BF16, 0, 768, 32200, "empty operand"),
])
def test_route_refuses_what_the_kernels_cannot_take(device, dtype, rows, D,
                                                    V, match):
    with pytest.raises(ValueError, match=match):
        HL.head_loss_route(device, dtype, rows, D, V)


@pytest.mark.parametrize("layout", ["offset", "strided"])
def test_route_refuses_misaligned_or_strided_operands(layout):
    buf = torch.zeros(9 * 64, dtype=BF16)
    t = buf[1:1 + 8 * 64].view(8, 64) if layout == "offset" \
        else buf.view(9, 64)[:, :32]
    with pytest.raises(ValueError, match="contiguous with 16-byte"):
        HL.head_loss_route("cuda", BF16, 8, 64, 8, t)


def test_the_wrappers_refuse_f32_on_the_card_and_bad_operands(monkeypatch):
    hs = torch.zeros(4, 64)
    labels = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        HL.head_lse(hs.to(BF16), hs.to(BF16), labels.long())
    with pytest.raises(ValueError, match="differ"):
        HL.head_lse(hs, hs.to(BF16), labels)
    with pytest.raises(ValueError, match="contiguous f32"):
        HL.head_dlogits(hs, hs, labels, torch.zeros(4, dtype=BF16),
                        torch.zeros(4))
    # a CUDA f32 call would take the plain version: the kernels refuse it
    # before anything is built
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="plain version, not the kernels"):
        HL._check_route("head_lse", hs, hs)


# ---- the plan --------------------------------------------------------------

@pytest.mark.parametrize("rows,D,V,m_tiles,chunks,ragged,rows_pad", [
    (800, 768, 32200, 7, 126, 200, 800),
    (800, 2048, 163840, 7, 640, 256, 800),
    (480, 768, 32200, 4, 126, 200, 480),       # NExT-QA's 80 x 6 rows
    (130, 768, 32200, 2, 126, 200, 136),       # rows not a multiple of 8
    (21, 64, 1032, 1, 5, 8, 24),
])
def test_plan_shapes(rows, D, V, m_tiles, chunks, ragged, rows_pad):
    p = HL.head_plan(rows, D, V)
    assert (p.m_tiles, p.chunks, p.ragged, p.rows_pad) == (
        m_tiles, chunks, ragged, rows_pad)
    assert p.k_steps == D // HL.BLOCK_K and p.blocks == m_tiles * chunks


@pytest.mark.parametrize("rows,D,V", [(800, 768, 32200), (800, 2048, 163840),
                                      (130, 768, 32200)])
def test_the_backward_products_take_k5s_wgmma_route(rows, D, V):
    # dh = d(logits)·W from the transposed copy [V, rows_pad], dshared =
    # d(logits)ᵀ·h from [rows, V]: both on K5's stream-K wgmma route
    rp = HL.head_plan(rows, D, V).rows_pad
    assert dw.dw_route(V, rp, D, BF16) == "wgmma"
    assert dw.dw_route(rows, V, D, BF16) == "wgmma"
    for K, Dd in ((V, rp), (rows, V)):
        plan = dw.dw_plan(K, Dd, D, 132)
        assert plan.starts[-1] == plan.tiles * plan.k_blocks


def test_mirrors_mask_the_ragged_tail_and_pad_the_transpose():
    g = torch.Generator().manual_seed(1)
    rows, D, V = 13, 64, 600                       # last chunk: 88 columns
    hs = torch.randn(rows, D, generator=g).to(BF16)
    wb = torch.randn(V, D, generator=g).to(BF16)
    labels = torch.randint(0, V, (rows,), generator=g, dtype=torch.int32)
    labels[0] = V - 1
    lse, ll = HL.lse_reference(hs, wb, labels)
    lg = hs.float() @ wb.float().t()
    torch.testing.assert_close(lse, torch.logsumexp(lg, 1), rtol=1e-6,
                               atol=1e-5)
    assert torch.equal(ll, lg.gather(1, labels.long()[:, None])[:, 0])
    w = torch.rand(rows, generator=g)
    d, d_t = HL.dlogits_reference(hs, wb, labels, lse, w)
    p = torch.softmax(lg, 1) - torch.nn.functional.one_hot(
        labels.long(), V).float()
    torch.testing.assert_close(d.float(), p * w[:, None], rtol=8e-3,
                               atol=1e-6)
    assert d_t.shape == (V, 16) and torch.equal(d_t[:, :rows], d.t())
    assert not d_t[:, rows:].any()


@pytest.mark.parametrize("B,T,rs", [(2, 5, 1.0), (3, 4, 0.125)])
def test_the_kernel_routes_pair_matches_the_plain_version(B, T, rs):
    # head_loss_forward/_backward on CPU tensors (H1, H2 and K5 on their
    # plain versions): 10 rows, below the transpose's 16, and 12 of 16,
    # the head cast once, int32 labels, dh in bf16 then times rs
    D, V = 64, 600
    g = torch.Generator().manual_seed(B * T)
    hidden = torch.randn(B, T, D, generator=g).to(BF16)
    shared = torch.randn(V, D, generator=g) * 0.3
    safe = torch.randint(0, V, (B, T), generator=g)
    w = torch.rand(B, T, generator=g)
    lse, ll, res = HL.head_loss_forward(hidden, shared, safe, rs)
    hs, wb, labels = res
    assert hs.shape == (B * T, D) and hs.is_contiguous()
    assert wb.dtype == BF16 and labels.dtype == torch.int32
    plse, pll, pres = tvlt5._plain_forward(hidden, shared, safe, rs)
    assert lse.shape == ll.shape == (B, T)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(ll, pll, rtol=1e-6, atol=1e-5)
    dh, dshared = HL.head_loss_backward(res, plse, w, rs)
    pdh, pdshared = tvlt5._plain_backward(pres, plse, w, rs)
    assert dh.dtype == BF16 and dh.shape == (B, T, D)
    assert dshared.dtype == torch.float32 and dshared.shape == (V, D)
    torch.testing.assert_close(dh.float(), pdh.float(), rtol=8e-3,
                               atol=1e-6)
    torch.testing.assert_close(dshared, pdshared, rtol=1e-5, atol=1e-6)


# ---- the kernel route's arithmetic vs JAX and the plain version -------------

def _inputs(seed, B, T, D, V, strided=False):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T + 3 * strided, D)).astype(np.float32)
    shared = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)
    labels[0, T - 2:] = -100
    labels[1] = -100                                 # a row of all -100
    labels[2, 0] = V - 1                             # the ragged last chunk
    scores = rng.uniform(0.3, 1.0, B).astype(np.float32)
    return hidden, shared, labels, scores


def _torch_run(hidden, shared, labels, scores, rescale, strided):
    h = torch.from_numpy(hidden).to(BF16).requires_grad_()
    s = torch.from_numpy(shared).requires_grad_()
    sc = torch.from_numpy(scores).requires_grad_()
    T = labels.shape[1]
    x = h[:, -T:] if strided else h                 # rows of one stride
    assert x.is_contiguous() != strided
    loss = tvlt5.fused_head_loss(x, s, torch.from_numpy(labels).long(), sc,
                                 rescale)
    return (loss,) + torch.autograd.grad(loss, (h, s, sc))


def _as_kernel_route(monkeypatch):
    # bf16 takes the kernels' route as on the card; on CPU tensors its
    # wrappers (H1, H2, K5) take their plain versions
    monkeypatch.setattr(HL, "head_loss_route", lambda dev, dtype, *a: (
        "wgmma" if dtype == BF16 else "plain"))


@pytest.mark.parametrize("tied,strided", [(True, False), (False, False),
                                          (False, True), (True, True)])
def test_kernel_route_matches_plain_and_jax(monkeypatch, tied, strided):
    B, T, D, V = 4, 6, 64, 600
    rescale = D ** -0.5 if tied else 1.0
    args = _inputs(7 + tied + 2 * strided, B, T, D, V, strided)
    plain = _torch_run(*args, rescale, strided)
    _as_kernel_route(monkeypatch)
    P.take()
    P.enable()
    try:
        kern = _torch_run(*args, rescale, strided)
    finally:
        P.enable(False)
    taken = P.take()
    assert taken.counters == {"head_loss.kernel": 1}
    assert [sp[0] for sp in taken.spans] == ["head_loss", "head_loss"]
    for name, a, b in zip(("loss", "hidden", "shared", "scores"), kern,
                          plain):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # the same f32 products of the rounded operands
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-6, msg=name)

    # JAX's custom VJP: the same bf16 operands, bf16 products summed in f32
    hidden, shared, labels, scores = args
    Tl = labels.shape[1]

    def jloss(h, s, sc):
        return jvlt5.fused_head_loss(h[:, -Tl:], s, jnp.asarray(labels), sc,
                                     rescale)

    jh = jnp.asarray(hidden).astype(jnp.bfloat16)
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jh, jnp.asarray(shared), jnp.asarray(scores))
    np.testing.assert_allclose(float(kern[0].detach()), float(jl),
                               rtol=2e-5)
    np.testing.assert_allclose(
        kern[1].float().numpy(), np.asarray(jg[0].astype(jnp.float32)),
        rtol=2e-2, atol=1e-4, err_msg="hidden")  # bf16 dh: 2^-8 apart
    np.testing.assert_allclose(kern[2].numpy(), np.asarray(jg[1]),
                               rtol=2e-3, atol=2e-6, err_msg="shared")
    np.testing.assert_allclose(kern[3].numpy(), np.asarray(jg[2]),
                               rtol=2e-5, atol=1e-7, err_msg="scores")


def test_plain_route_counts_plain(monkeypatch):
    args = _inputs(3, 4, 6, 32, 50)
    P.take()
    P.enable()
    try:
        _torch_run(*args, 1.0, False)
    finally:
        P.enable(False)
    assert P.take().counters == {"head_loss.plain": 1}
