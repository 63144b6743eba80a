"""The attention forward's route and limits, and the C signatures of every
kernel library, checked on the CPU without building anything.

``fused_attention.fwd_route`` decides, in pure Python, which of the two
forward kernels of ``csrc/fused_attention_fwd.cu`` takes a call: the
tensor-core kernel for bf16 (head width a multiple of 16 up to 128) or
the scalar kernel for f32, and raises ValueError for a call neither
takes, before anything is built or launched. ``ops/_build.SIGNATURES``
is what ctypes passes to each ``extern "C"`` entry: a missing or short
entry silently cuts 64-bit pointers to 32 bits, so it is held against
the sources themselves.
"""

import os
import re
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vqacl_tpu_torch.ops import _build  # noqa: E402
from vqacl_tpu_torch.ops import fused_attention as fa  # noqa: E402


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the route check must not build a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("dk,Tq,Sk", [(8, 13, 29), (64, 56, 56), (64, 10, 58),
                                      (144, 10, 10)])
def test_f32_takes_the_scalar_kernel(dk, Tq, Sk):
    assert fa.fwd_route(torch.float32, dk, Tq, Sk) == "scalar"


@pytest.mark.parametrize("dk,Tq,Sk", [
    (64, 56, 56),      # the encoder (eval and train)
    (64, 10, 10),      # the decoder's self-attention
    (64, 10, 58),      # the decoder's cross-attention
    (64, 33, 29),      # Tq not a multiple of 16, odd Sk
    (64, 56, 128),     # one full 128-key tile
    (64, 40, 300),     # three key tiles: the two-sweep softmax
    (16, 5, 5),
    (48, 19, 37),
    (128, 56, 56)])
def test_bf16_takes_the_tensor_core_kernel(dk, Tq, Sk):
    assert fa.fwd_route(torch.bfloat16, dk, Tq, Sk) == "mma"


@pytest.mark.parametrize("dk", [8, 72, 144])
def test_bf16_head_width_outside_the_kernel_raises(dk):
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fa.fwd_route(torch.bfloat16, dk, 56, 56)


@pytest.mark.parametrize("dtype,dk,Sk", [(torch.bfloat16, 128, 2000),
                                         (torch.float32, 64, 1000)])
def test_keys_past_shared_memory_raise(dtype, dk, Sk):
    with pytest.raises(ValueError, match="shared memory per block"):
        fa.fwd_route(dtype, dk, 16, Sk)


def test_other_dtypes_raise():
    with pytest.raises(ValueError, match="not supported"):
        fa.fwd_route(torch.float16, 64, 56, 56)


def test_route_names_cover_both_routes():
    assert fa.ROUTE_NAMES == {"mma": "mma.sync bf16", "scalar": "scalar f32"}


def test_bf16_stage_size_at_the_encoder_shape():
    # K, V [64][72] and Q [64][72] bf16 plus the mask [64] f32, the sizes
    # the source note of csrc/fused_attention_fwd.cu reckons with
    assert fa._mma_smem(56, 56, 64) == 2 * (2 * 64 + 64) * 72 + 4 * 64 \
        == 27904
    assert fa._mma_smem(10, 58, 64) == 2 * (2 * 64 + 16) * 72 + 4 * 64


_STAGE_NOTE = re.compile(
    r"mma_stage_bytes\((\d+), (\d+), (\d+), (\d+)\) = (\d+)")


def test_stage_bytes_match_the_source_note():
    # the C side's mma_stage_bytes and the Python `_mma_smem` are two
    # copies of one formula: the values listed in the source note hold
    # the Python copy to the C one
    with open(os.path.join(_build.CSRC, "fused_attention_fwd.cu")) as f:
        listed = _STAGE_NOTE.findall(f.read())
    assert len(listed) >= 5
    for heads, Tq, Sk, dk, nbytes in listed:
        assert fa._mma_smem(int(Tq), int(Sk), int(dk), int(heads)) \
            == int(nbytes), (heads, Tq, Sk, dk)


@pytest.mark.parametrize("dk,Tq,Sk", [
    (64, 56, 56), (64, 10, 10), (64, 10, 58), (64, 33, 29), (64, 56, 128),
    (128, 56, 56), (64, 56, 192), (64, 40, 300)])
def test_bwd_takes_the_checked_shapes(dk, Tq, Sk):
    assert fa.bwd_route(torch.bfloat16, dk, Tq, Sk, 0.1) == "mma"


@pytest.mark.parametrize("dtype,dk,Tq,Sk,rate", [
    (torch.float32, 64, 40, 300, 0.1),
    (torch.float32, 64, 40, 300, 0.0),
    (torch.float32, 64, 56, 193, 0.1),
    (torch.float32, 64, 112, 112, 0.1),
    (torch.float32, 64, 117, 117, 0.0),
    (torch.bfloat16, 64, 40, 512, 0.1),
    (torch.bfloat16, 64, 192, 192, 0.0),
    (torch.bfloat16, 128, 144, 144, 0.1)])
def test_bwd_refuses_keys_past_its_block(dtype, dk, Tq, Sk, rate):
    # K2 holds the panels and the whole [Tq, Sk] tile in one block: f32
    # panels and f32 tiles in the scalar route, bf16 in the tensor-core one
    with pytest.raises(ValueError, match="backward kernel needs"):
        fa.bwd_route(dtype, dk, Tq, Sk, rate)


def test_training_call_refused_before_k1p(monkeypatch):
    # a CUDA-shaped bf16 training call at 512 keys: K1′ could take it, K2
    # not, so _FusedAttention raises before K1′ runs
    def k1p(*a, **k):
        raise AssertionError("K1' ran before the backward's limit check")

    monkeypatch.setattr(fa, "fused_attention_fwd_train", k1p)
    cuda = SimpleNamespace(type="cuda")
    q = SimpleNamespace(device=cuda, shape=(4, 40, 12 * 64),
                        dtype=torch.bfloat16)
    k = SimpleNamespace(device=cuda, shape=(4, 512, 12 * 64),
                        dtype=torch.bfloat16)
    assert fa.fwd_route(torch.bfloat16, 64, 40, 512) == "mma"
    with pytest.raises(ValueError, match="backward kernel needs"):
        fa._FusedAttention.forward(None, q, k, k, None, None, None, 12, 0.1)


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even (x >= 0)."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(0)), c,
             np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - x),
                                     int(t.view(np.uint32)) & 1))


@pytest.mark.parametrize("rate", [0.1, 0.15, 0.3, 0.7])
def test_dropout_scale_reproduces_the_division(rate):
    # the bf16 K1′ divides kept p by keep_div = 1 - rate as q = p·r, then
    # q + (p - q·keep_div)·r in two fmas (csrc/fused_attention_fwd.cu
    # `div_keep`); in exact arithmetic with one rounding per operation it
    # gives the rounded quotient p / keep_div that K2 and the plain
    # version take, for every p from 2^-101 to 1 (below, the residual
    # underflows)
    d = np.float32(1.0 - rate)            # the wrapper's float argument
    r = _rn32(1 / Fraction(float(d)))     # 1.0f / keep_div on the host
    rng = np.random.default_rng(7)
    p = np.concatenate([
        rng.random(1500, dtype=np.float32),
        np.ldexp(rng.random(500).astype(np.float32) + 1,
                 rng.integers(-101, 0, 500)).astype(np.float32),
        np.float32([1.0, 0.5, 2.0 ** -101, np.nextafter(1, 0), 0.9, d])])
    fd, fr = Fraction(float(d)), Fraction(float(r))
    for x in p:
        fx = Fraction(float(x))
        q = _rn32(fx * fr)
        e = _rn32(-Fraction(float(q)) * fd + fx)
        got = _rn32(Fraction(float(e)) * fr + Fraction(float(q)))
        assert got == _rn32(fx / fd), (x, got)


def test_k1_wrapper_refuses_before_building(monkeypatch):
    # K1's launch path with the device check lifted, so that CPU tensors
    # reach it: a bf16 call at dk 8 raises ValueError before the library
    # is loaded (the fixture's `load` would fail the test) or counted
    monkeypatch.setattr(fa, "_validate_qkv",
                        lambda q, k, v, H, extra=(): (*q.shape[:2],
                                                      k.shape[1],
                                                      q.shape[2] // H))
    q = torch.zeros(2, 8, 4 * 8, dtype=torch.bfloat16)
    mask = torch.ones(2, 8)
    before = fa.fused_attention.launches
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fa._launch_k1(q, q, q, None, mask, 4)
    assert fa.fused_attention.launches == before


_EXTERN = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*(\**)\s*(\w+)\s*\(([^)]*)\)',
                     re.S)


def _c_entries():
    """{source stem: {entry: (return type, [argument types])}} parsed from
    every csrc/*.cu."""
    out = {}
    for fname in sorted(os.listdir(_build.CSRC)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, fname)) as f:
            text = f.read()
        entries = {}
        for ret, stars, name, args in _EXTERN.findall(text):
            params = [" ".join(a.split()) for a in args.split(",")
                      if a.strip()]
            entries[name] = (" ".join((ret + stars).split()), params)
        out[fname[:-3]] = entries
    return out


def _ctype(c_decl):
    if "*" in c_decl:
        return "c_char_p" if "char" in c_decl else "c_void_p"
    if "unsigned" in c_decl:
        return "c_uint"
    if "float" in c_decl:
        return "c_float"
    assert "int" in c_decl, c_decl
    return "c_int"


def test_every_library_has_a_signature_table():
    assert set(_c_entries()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("stem", sorted(_build.SIGNATURES))
def test_signatures_match_the_sources(stem):
    entries = _c_entries()[stem]
    table = _build.SIGNATURES[stem]
    assert set(entries) == set(table), stem
    for name, (ret, params) in entries.items():
        argtypes, restype = table[name]
        assert len(argtypes) == len(params), (name, params)
        for c_decl, t in zip(params, argtypes):
            assert t.__name__ == _ctype(c_decl), (name, c_decl, t)
        assert restype.__name__ == _ctype(ret), (name, ret)


# ---- strided q/k/v (merged projections) ---------------------------------

def _merged(B, S, H, dk, n=3, pad=0, dtype=torch.bfloat16):
    """n column slices [B,S,H·dk] of one [B,S,n·H·dk + pad] buffer."""
    W = H * dk
    buf = torch.zeros(B, S, n * W + pad, dtype=dtype)
    return [buf[..., i * W:(i + 1) * W] for i in range(n)]


@pytest.mark.parametrize("n,want", [(3, 2304), (2, 1536), (24, 18432)])
def test_merged_t5_base_strides_pass(n, want):
    """t5-base's merged self q/k/v, cross k/v and 12-layer folded cross
    k/v slices: rows of one stride each, 16-byte rows for bf16."""
    views = _merged(2, 5, 12, 64, n=n)
    q, k, v = views[0], views[n - 2], views[n - 1]
    lds = fa._qkv_strides(q, k, v)
    assert lds == (want,) * 3
    fa._check_rows16("fused_attention", zip("qkv", (q, k, v), lds))


def test_row_stride_refuses_other_layouts():
    W = 32
    good = torch.zeros(3, 5, 3 * W)[..., :W]
    assert fa._row_stride("q", good, torch.float32, (3, 5, W)) == 3 * W
    assert fa._row_stride("q", torch.zeros(3, 5, W), torch.float32,
                          (3, 5, W)) == W
    bad = {"last dim not contiguous": torch.zeros(3, 5, 2 * W)[..., ::2],
           "batch stride not S rows": torch.zeros(5, 3, W).transpose(0, 1),
           "heads interleaved": torch.zeros(3, 5, W, 2)[..., 0]}
    for why, t in bad.items():
        with pytest.raises(ValueError, match="rows of one stride"):
            fa._row_stride("q", t, torch.float32, (3, 5, W))
    with pytest.raises(ValueError, match="shape"):
        fa._row_stride("q", good, torch.float32, (3, 5, W + 1))
    with pytest.raises(ValueError, match="bfloat16"):
        fa._row_stride("q", good, torch.bfloat16, (3, 5, W))


@pytest.mark.parametrize("pad,offset", [(4, 0), (0, 4)])
def test_bf16_rows_off_16_bytes_are_refused(pad, offset):
    """A bf16 row stride, or a base offset, that is not a multiple of 8
    elements is refused: cp.async moves 16-byte chunks."""
    W = 4 * 64
    buf = torch.zeros(2, 5, 3 * W + pad + offset, dtype=torch.bfloat16)
    views = [buf[..., offset + i * W:offset + (i + 1) * W] for i in range(3)]
    lds = fa._qkv_strides(*views)
    with pytest.raises(ValueError, match="16 bytes"):
        fa._check_rows16("fused_attention", zip("qkv", views, lds))


def test_k1_wrapper_refuses_a_bad_stride_before_building(monkeypatch):
    # as test_k1_wrapper_refuses_before_building: a bf16 view of stride
    # 772 (not a multiple of 8) raises before the library is loaded
    monkeypatch.setattr(fa, "_validate_qkv",
                        lambda q, k, v, H, extra=(): (*q.shape[:2],
                                                      k.shape[1],
                                                      q.shape[2] // H))
    q, k, v = _merged(2, 8, 4, 64, pad=4)
    mask = torch.ones(2, 8)
    before = (fa.fused_attention.launches,
              fa.fused_attention.strided_launches)
    with pytest.raises(ValueError, match="16 bytes"):
        fa._launch_k1(q, k, v, None, mask, 4)
    assert (fa.fused_attention.launches,
            fa.fused_attention.strided_launches) == before


@pytest.mark.parametrize("stem,name,ints", [
    ("fused_attention_fwd", "fused_attention_fwd", 10),
    ("fused_attention_fwd", "fused_attention_fwd_train", 14),
    ("fused_attention_bwd", "fused_attention_bwd", 14)])
def test_attention_kernels_have_only_strided_entries(stem, name, ints):
    """K1, K1′ and K2 each have one C entry, the strided one (a dense
    operand passes the stride H·dk): no dense entry is declared, and the
    entry takes ldq, ldk and ldv after B, Tq, Sk, H, dk and L."""
    table = _build.SIGNATURES[stem]
    assert name not in table and name + "_strided" in table
    argtypes = [t.__name__ for t in table[name + "_strided"][0]]
    assert argtypes.count("c_int") == ints
    first = argtypes.index("c_int")
    assert argtypes[first:first + 9] == ["c_int"] * 9
