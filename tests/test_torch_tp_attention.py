"""The Philox head offset of K1′/K2 under tensor parallelism.

A tensor-parallel rank runs K1′/K2 over its heads h0 … h0 + H − 1 of
rows of ``Hc`` heads; the Philox counter of (b, h) is then bh0 + b·Hc +
h0 + h (``csrc/philox.cuh::stream_row``, ``ops/fused_attention.py::
stream_rows``), so its heads draw the same heads' streams of a
one-process call. Here, on the CPU (the kernels' plain versions, which
the card's kernels equal bit for bit in ``chip_smoke.py``):

- ``philox_keep_mask`` at ``(Hc, h0)`` (with and without a data-parallel
  row offset) is heads h0 … of the one-process mask, bit for bit; at
  the defaults the streams are today's ``bh0 + b·H + h``;
- the plain K1′ and K2 over a head slice give that slice of the whole
  call's o, p, dq, dk, dv and dbias, bit for bit, and ``_FusedAttention``
  over each tp rank's heads gives the whole call's output and gradients;
- heads that do not lie in a row of ``Hc`` are refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402

RATE = 0.1
SEED = torch.tensor([987653], dtype=torch.int32)


@pytest.mark.parametrize("B,H,Tq,Sk,tp", [(4, 2, 7, 9, 2), (3, 6, 5, 12, 3),
                                          (2, 12, 10, 58, 2)])
@pytest.mark.parametrize("dp", [1, 2])
def test_keep_mask_heads_with_h0(B, H, Tq, Sk, tp, dp):
    whole = fa.philox_keep_mask(SEED, dp * B, H, Tq, Sk, RATE)
    n = H // tp
    for d in range(dp):
        for t in range(tp):
            part = fa.philox_keep_mask(SEED, B, n, Tq, Sk, RATE,
                                       bh0=d * B * H, Hc=H, h0=t * n)
            assert torch.equal(part,
                               whole[d * B:(d + 1) * B, t * n:(t + 1) * n])
    assert not torch.equal(whole[:, :n], whole[:, n:2 * n])


def test_defaults_are_the_row_offset_streams():
    B, H, bh0 = 5, 3, 21
    assert torch.equal(fa.stream_rows(B, H, bh0),
                       torch.arange(bh0, bh0 + B * H))
    assert torch.equal(fa.stream_rows(B, H, bh0, Hc=H, h0=0),
                       fa.stream_rows(B, H, bh0))
    assert torch.equal(
        fa.philox_keep_mask(SEED, B, H, 6, 11, RATE, bh0),
        fa.philox_keep_mask(SEED, B, H, 6, 11, RATE, bh0, Hc=H, h0=0))
    # heads 2 .. 3 of rows of 5: the counters skip the other heads
    assert fa.stream_rows(2, 2, 0, Hc=5, h0=2).tolist() == [2, 3, 7, 8]


def _inputs(B=4, S=11, H=4, dk=8, L=6, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, H * dk))
                                    .astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.normal(size=(H, L, L)).astype(np.float32))
    mask = np.ones((B, S), np.float32)
    mask[1, 8:] = 0.0
    mask[3, 5:] = 0.0
    return q, k, v, do, bias, torch.from_numpy(mask), H, dk, L


def _cols(t, h0, n, dk):
    return t[..., h0 * dk:(h0 + n) * dk].contiguous()


@pytest.mark.parametrize("tp", [2, 4])
def test_plain_k1p_k2_over_heads_equal_the_head_slice(tp):
    q, k, v, do, bias, mask, H, dk, L = _inputs()
    B, S = q.shape[:2]
    o, p = fa.fused_attention_fwd_train_reference(q, k, v, bias, mask, SEED,
                                                  H, RATE)
    g = fa.fused_attention_bwd_reference(q, k, v, p, SEED, do, H, L, RATE)
    n = H // tp
    for t in range(tp):
        h0 = t * n
        qs, ks, vs, dos = (_cols(x, h0, n, dk) for x in (q, k, v, do))
        os_, ps = fa.fused_attention_fwd_train_reference(
            qs, ks, vs, bias[h0:h0 + n], mask, SEED, n, RATE, Hc=H, h0=h0)
        gs = fa.fused_attention_bwd_reference(qs, ks, vs, ps, SEED, dos, n,
                                              L, RATE, Hc=H, h0=h0)
        assert torch.equal(os_, _cols(o, h0, n, dk))
        assert torch.equal(ps.reshape(B, n, S, S),
                           p.reshape(B, H, S, S)[:, h0:h0 + n])
        for got, want in zip(gs[:3], g[:3]):
            assert torch.equal(got, _cols(want, h0, n, dk))
        assert torch.equal(gs[3], g[3][h0:h0 + n])


@pytest.mark.parametrize("packed", [False, True])
def test_tp_ranks_autograd_equals_the_whole_call(packed):
    q, k, v, do, bias, mask, H, dk, L = _inputs(seed=1)
    tp, n = 2, H // 2

    def run(q_, k_, v_, b_, heads, cot, **kw):
        q_, k_, v_, b_ = (x.clone().requires_grad_()
                          for x in (q_, k_, v_, b_))
        if packed:
            out = fa.fused_attention_packed(torch.cat([q_, k_, v_], -1),
                                            None, b_, mask, heads, RATE,
                                            SEED, **kw)
        else:
            out = fa.fused_attention(q_, k_, v_, b_, mask, heads, RATE,
                                     SEED, **kw)
        return out.detach(), torch.autograd.grad(out, (q_, k_, v_, b_), cot)

    o, g = run(q, k, v, bias, H, do)
    for t in range(tp):
        h0 = t * n
        os_, gs = run(*(_cols(x, h0, n, dk) for x in (q, k, v)),
                      bias[h0:h0 + n], n, _cols(do, h0, n, dk), Hc=H, h0=h0)
        assert torch.equal(os_, _cols(o, h0, n, dk))
        for got, want in zip(gs[:3], g[:3]):
            assert torch.equal(got, _cols(want, h0, n, dk))
        assert torch.equal(gs[3], g[3][h0:h0 + n])


@pytest.mark.parametrize("Hc,h0", [(4, 3), (2, -1), (3, 2)])
def test_heads_outside_a_row_are_refused(Hc, h0):
    q, k, v, do, bias, mask, H, dk, L = _inputs()
    q2, k2, v2 = (x[..., :2 * dk].contiguous() for x in (q, k, v))
    with pytest.raises(ValueError, match="do not lie in a row"):
        fa.fused_attention_fwd_train(q2, k2, v2, bias[:2], mask, SEED, 2,
                                     RATE, Hc=Hc, h0=h0)
    with pytest.raises(ValueError, match="do not lie in a row"):
        fa.philox_keep_mask(SEED, 1, 2, 3, 4, RATE, Hc=Hc, h0=h0)
