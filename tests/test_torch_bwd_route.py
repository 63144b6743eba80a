"""The attention backward's (K2's) routes and limits, checked on the CPU
without building anything, and the bf16 route's rounding emulated.

``fused_attention.bwd_route`` decides, in pure Python, which of the two
kernels of ``csrc/fused_attention_bwd.cu`` takes a call: the tensor-core
kernel for bf16 (head width a multiple of 16 up to 128, one head's bf16
stage within a block's shared memory) or the scalar kernel for f32 (its
f32 panels and tiles within the same limit), and raises ValueError for a
call neither takes. The tensor-core kernel feeds pd and ds to the tensor
cores as two bf16 terms each (hi + lo) with f32 sums; the emulation here
makes that rounding in PyTorch and holds the result to the plain f32
version within the tolerance that ``chip_smoke.py`` holds the kernel to
on the card.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.ops import _build  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the route check must not build a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("dk", [16, 32, 48, 64, 80, 96, 112, 128])
def test_bf16_takes_the_tensor_core_kernel(dk):
    assert fa.bwd_route(torch.bfloat16, dk, 56, 56, 0.1) == "mma"


@pytest.mark.parametrize("dk", [8, 72, 144])
def test_bf16_head_width_outside_the_kernel_raises(dk):
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fa.bwd_route(torch.bfloat16, dk, 56, 56, 0.1)


@pytest.mark.parametrize("dk", [8, 64, 72, 144])
def test_f32_takes_the_scalar_kernel(dk):
    assert fa.bwd_route(torch.float32, dk, 10, 10, 0.1) == "scalar"


def test_other_dtypes_raise():
    with pytest.raises(ValueError, match="not supported"):
        fa.bwd_route(torch.float16, 64, 56, 56, 0.0)


def _parent_bwd_smem(Tq, Sk, dk, dropout):
    """Shared memory of the block of K2 before its bf16 route (one kernel
    for both dtypes, f32 panels and tiles)."""
    return 4 * (2 * Tq * (dk + 1) + 2 * Sk * (dk + 1) + 2 * Tq * Sk
                + 8 * Sk) + (Tq * Sk if dropout else 0)


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_no_bf16_call_the_scalar_kernel_took_is_refused(dk, rate):
    # every (Tq, Sk) up to 320 that K2 took in bf16 before it had a bf16
    # route is still taken, now on the tensor cores
    taken = 0
    for Tq in range(1, 321):
        for Sk in range(1, 321):
            if _parent_bwd_smem(Tq, Sk, dk, rate > 0) > fa.SMEM_PER_BLOCK:
                continue
            taken += 1
            assert fa.bwd_route(torch.bfloat16, dk, Tq, Sk, rate) == "mma", \
                (Tq, Sk)
    assert taken > 1000


def test_the_scalar_route_keeps_its_limit():
    assert all(fa._bwd_smem(Tq, Sk, dk, d) == _parent_bwd_smem(Tq, Sk, dk, d)
               for Tq, Sk, dk, d in ((56, 56, 64, True), (40, 300, 8, False),
                                     (13, 29, 72, True)))


def test_bf16_stage_size_at_the_encoder_shape():
    # q, do, k, v [64][72] and the hi and lo tiles of ds and pd [64][72],
    # bf16
    assert fa._bwd_mma_smem(56, 56, 64) == 2 * (4 * 64 * 72 + 4 * 64 * 72) \
        == 73728


_STAGE_NOTE = re.compile(
    r"bwd_stage_bytes\((\d+), (\d+), (\d+), (\d+)\) = (\d+)")


def test_stage_bytes_match_the_source_note():
    # the C side's bwd_stage_bytes and the Python `_bwd_mma_smem` are two
    # copies of one formula: the values listed in the source note hold
    # the Python copy to the C one
    with open(os.path.join(_build.CSRC, "fused_attention_bwd.cu")) as f:
        listed = _STAGE_NOTE.findall(f.read())
    assert len(listed) >= 5
    for heads, Tq, Sk, dk, nbytes in listed:
        assert fa._bwd_mma_smem(int(Tq), int(Sk), int(dk), int(heads)) \
            == int(nbytes), (heads, Tq, Sk, dk)


def _split(x, terms):
    """x as the sum of ``terms`` bf16 values, each rounding what the ones
    before left (1: x rounded to bf16; 2: hi + lo, as ``split_bf16``)."""
    out = torch.zeros_like(x)
    for _ in range(terms):
        out = out + (x - out).to(torch.bfloat16).float()
    return out


def _bwd_bf16_operands(q, k, v, p, seed, do, H, L, rate, terms):
    """K2's bf16 route in PyTorch: the plain version with pd and ds fed to
    the products that take them as ``terms`` bf16 terms, f32 sums, and
    ds[:L, :L] in f32 for dbias → (dq, dk, dv in f32, before the output
    rounding; dbias)."""
    B, Tq, _ = q.shape
    Sk = k.shape[1]
    qh, kh, vh, doh = (fa._heads(x, H).float() for x in (q, k, v, do))
    p = p.reshape(B, H, Tq, Sk)
    pd, dp = p, doh @ vh.transpose(-1, -2)
    if rate > 0.0:
        keep = fa.philox_keep_mask(seed, B, H, Tq, Sk, rate)
        kd = fa._keep_div(rate, p.device)
        pd = torch.where(keep, p / kd, 0.0)
        dp = torch.where(keep, dp / kd, 0.0)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    pdt, dst = _split(pd, terms), _split(ds, terms)
    dv = pdt.transpose(-1, -2) @ doh
    dq = dst @ kh
    dk = dst.transpose(-1, -2) @ qh
    dbias = ds[:, :, :L, :L].sum(dim=0) if L else None
    return fa._merge(dq), fa._merge(dk), fa._merge(dv), dbias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Tq,Sk,H,dk,L,causal", [
    (3, 13, 29, 2, 16, 5, False),   # ragged, odd Sk, a bias block
    (2, 56, 56, 2, 64, 20, False),  # the encoder's train shape, 2 heads
    (4, 10, 10, 2, 64, 10, True),   # the decoder's causal self-attention
    (4, 10, 58, 2, 64, 0, False)])  # the decoder's cross-attention
def test_bf16_operands_stay_within_the_chip_tolerance(B, Tq, Sk, H, dk, L,
                                                      causal, rate):
    # hi + lo terms of ds and pd, as the kernel feeds them, round the
    # outputs within the tolerance chip_smoke.py holds the kernel to; and
    # they cut the error of one bf16 term (which missed that tolerance on
    # the card at the decoder's self-attention shape) by far more than the
    # output's own bf16 rounding
    sys.path.insert(0, REPO)
    import chip_smoke

    rng = np.random.default_rng(B + Tq + Sk)
    bf = torch.bfloat16
    t = lambda *shape, s=1.0: torch.from_numpy(
        (s * rng.standard_normal(shape)).astype(np.float32)).to(bf)
    q, k = t(B, Tq, H * dk, s=0.25), t(B, Sk, H * dk, s=0.25)
    v, do = t(B, Sk, H * dk), t(B, Tq, H * dk)
    bias = torch.from_numpy(rng.standard_normal((H, L, L)).astype(
        np.float32)) if L else None
    mask = torch.ones(B, Sk)
    if causal:
        bias = bias + torch.triu(torch.ones(L, L), diagonal=1) * -1e9
    else:
        mask[1, 3:min(Sk, 9)] = 0.0
    seed = torch.tensor([20260 + Tq], dtype=torch.int32)
    _, p = fa.fused_attention_fwd_train_reference(q, k, v, bias, mask, seed,
                                                  H, rate)
    ref = fa.fused_attention_bwd_reference(q, k, v, p, seed, do, H, L, rate)
    exact = _bwd_bf16_operands(q, k, v, p, seed, do, H, L, rate, terms=3)
    one = _bwd_bf16_operands(q, k, v, p, seed, do, H, L, rate, terms=1)
    two = _bwd_bf16_operands(q, k, v, p, seed, do, H, L, rate, terms=2)
    atol, rtol = chip_smoke.TOL["bfloat16"]
    for name, a, b, e1, e2, e3 in zip(("dq", "dk", "dv"), two, ref, one,
                                      two, exact):
        a = a.to(bf).float()
        diff = (a - b.float()).abs()
        assert bool((diff <= atol + rtol * b.float().abs()).all()), \
            (name, float(diff.max()))
        err1 = float((e1 - e3).abs().max())
        err2 = float((e2 - e3).abs().max())
        assert err2 * 64 <= err1, (name, err1, err2)
    if L:
        torch.testing.assert_close(two[3], ref[3], rtol=0, atol=0)
    else:
        assert two[3] is None and ref[3] is None
