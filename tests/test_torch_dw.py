"""The port's weight-gradient kernel (K5) against the probe's Pallas kernel.

``ops.dw.dw_splitk_reference`` (the plain version of the CUDA kernel
``csrc/dw_splitk.cu``) is held against ``pallas_dw`` from
``scripts/mm_bench.py``, restated here as it is there (the probe keeps
it inside ``main`` and reads D and F from the module; here they come
from the operands) and run with ``interpret=True`` on the CPU, at
K=96, D=40, F=72 on the probe's (nt, kt) = (3, 4) grid, in bf16 and
f32: |plain − Pallas| ≤ 1e-5·Σ_k|x_kd·g_kf| + 1e-6, the tolerance
``chip_smoke.py`` holds the CUDA kernel to. Also the wrapper's
validation, and ``mm_bench``'s case list at small shapes on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vqacl_tpu_torch import mm_bench  # noqa: E402
from vqacl_tpu_torch.ops import dw  # noqa: E402


def dw_kernel(x_ref, g_ref, o_ref):
    k = pl.program_id(1)
    acc = lax.dot_general(x_ref[:], g_ref[:], (((0,), (0,)), ((), ())),
                          preferred_element_type=jnp.float32)

    @pl.when(k == 0)
    def _():
        o_ref[:] = acc

    @pl.when(k != 0)
    def _():
        o_ref[:] = o_ref[:] + acc


def pallas_dw(xx, gg, nt=3, kt=4, interpret=True):
    KK, D = xx.shape
    F = gg.shape[1]
    kc, nc = KK // kt, F // nt
    return pl.pallas_call(
        dw_kernel,
        grid=(nt, kt),
        in_specs=[
            pl.BlockSpec((kc, D), lambda n, k: (k, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((kc, nc), lambda n, k: (k, n),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((D, nc), lambda n, k: (0, n),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((D, F), jnp.float32),
        interpret=interpret,
    )(xx, gg)


def _operands(K, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, D), dtype=np.float32),
            rng.standard_normal((K, F), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dw_matches_pallas_dw(dtype):
    K, D, F = 96, 40, 72
    xn, gn = _operands(K, D, F)
    tx = torch.from_numpy(xn).to(getattr(torch, dtype))
    tg = torch.from_numpy(gn).to(getattr(torch, dtype))
    ref = np.asarray(pallas_dw(jnp.asarray(xn, getattr(jnp, dtype)),
                               jnp.asarray(gn, getattr(jnp, dtype))))
    out = dw.dw_splitk_reference(tx, tg)
    assert out.dtype == torch.float32 and out.shape == (D, F)
    scale = (tx.float().abs().t() @ tg.float().abs()).numpy()
    err = np.abs(out.numpy() - ref)
    assert (err <= 1e-5 * scale + 1e-6).all(), float(err.max())
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(dw.dw_splitk(tx, tg), out)


@pytest.mark.parametrize("x_shape,g_shape,dtypes,match", [
    ((96,), (96, 72), ("float32", "float32"), "2-D"),
    ((96, 40), (95, 72), ("float32", "float32"), "differ in K"),
    ((96, 40), (96, 72), ("float16", "float16"), "dtype"),
    ((96, 40), (96, 72), ("bfloat16", "float32"), "dtype"),
    ((96, 0), (96, 72), ("float32", "float32"), "empty"),
])
def test_dw_splitk_validation(x_shape, g_shape, dtypes, match):
    x = torch.zeros(x_shape, dtype=getattr(torch, dtypes[0]))
    g = torch.zeros(g_shape, dtype=getattr(torch, dtypes[1]))
    with pytest.raises(ValueError, match=match):
        dw.dw_splitk(x, g)


def test_dw_splitk_rejects_non_contiguous():
    x = torch.zeros(40, 96).t()
    with pytest.raises(ValueError, match="contiguous"):
        dw.dw_splitk(x, torch.zeros(96, 72))


SMALL = dict(B=2, S=6, D=16, F=24, H=2, dk=8)


def test_mm_bench_cases_on_cpu():
    """The probe's case list, each case run once at small shapes; the
    K5 case gives the f32 xᵀ·g of its inputs."""
    cases = mm_bench.make_cases("cpu", SMALL, n_sets=2)
    assert len(cases) == 12 and mm_bench.DW_CASE in cases
    assert not any("pallas" in name for name in cases)
    for name, (fns, flops) in cases.items():
        assert len(fns) == 2 and flops > 0, name
        out = fns[0]()
        assert torch.isfinite(out.float()).all(), name
    B, S, D, F = (SMALL[k] for k in "BSDF")
    dw_out = cases[mm_bench.DW_CASE][0][0]()
    two_d = cases["mlp_wi dW 2d k=dim0"][0][0]()
    split = cases["mlp_wi dW split-K x4 (torch)"][0][0]()
    assert dw_out.shape == (D, F) and dw_out.dtype == torch.float32
    np.testing.assert_allclose(split.numpy(), dw_out.numpy(), rtol=1e-2,
                               atol=1e-1)
    np.testing.assert_allclose(two_d.float().numpy(), dw_out.numpy(),
                               rtol=2e-2, atol=2e-1)


def test_mm_bench_run_on_cpu_and_needs_a_card_by_default():
    rows = mm_bench.run("cpu", SMALL, reps=1, n_sets=2)
    assert [r["case"] for r in rows] == list(
        mm_bench.make_cases("cpu", SMALL, n_sets=1))
    assert all(r["us"] > 0 and r["tflops"] > 0 for r in rows)
    assert "dw_splitk" in mm_bench.table(rows)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mm_bench.run()
