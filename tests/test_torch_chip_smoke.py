"""Rehearse chip_smoke.py's control flow on the CPU.

chip_smoke.py needs a CUDA device and nvcc, so the tests here cannot
run it as it is. This rehearsal runs its ``main()`` in a subprocess with
CUDA devices mapped to the CPU (a ``TorchFunctionMode`` that rewrites
``device="cuda"``), CUDA events timed on the host clock, the build step
skipped, each kernel wrapper (K1, K1′, K2, K5) replaced by its plain
version plus the launch counter (K1 and K1′ keep the wrapper's route and
limit check), and tiny widths (t5-base's data shapes, d_model 32 as 2
heads of 16, 2 layers; small K5 and mm_bench shapes). It checks every
phase's bookkeeping — launch counts per eval step, per train step with
the plain and with the fused decoder, per loss-eval step, per remat
mode, per served batch and in the probe, the kernels JSON line with all
its keys, the card line and the final verdict line — and that without
CUDA the real script prints no result and exits non-zero.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REHEARSAL = r"""
import sys, time
import torch
from torch.overrides import TorchFunctionMode

def to_cpu(x):
    if isinstance(x, str) and x.startswith("cuda"):
        return "cpu"
    if isinstance(x, torch.device) and x.type == "cuda":
        return torch.device("cpu")
    return x

class CudaOnCpu(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.cuda:
            return args[0]
        kwargs = {k: to_cpu(v) for k, v in (kwargs or {}).items()}
        return func(*(to_cpu(a) for a in args), **kwargs)

class HostEvent:
    def __init__(self, **kw):
        self.t = None
    def record(self):
        self.t = time.perf_counter()
    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

torch.cuda.is_available = lambda: True
torch.cuda.synchronize = lambda *a: None
torch.cuda._sleep = lambda cycles: None
torch.cuda.Event = HostEvent
torch.cuda.get_device_name = lambda i=0: "rehearsal"
torch.cuda.device_count = lambda: 1
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.memory_allocated = lambda *a: 0
torch.cuda.max_memory_allocated = lambda *a: 0
_Generator = torch.Generator
class CpuGenerator(_Generator):   # a type, as annotations in torch need
    def __new__(cls, device=None):
        return _Generator()
torch.Generator = CpuGenerator

from vqacl_tpu_torch.utils import device as D
cpu = lambda d: torch.device("cpu")
import vqacl_tpu_torch.models.vlt5 as V, vqacl_tpu_torch.serve as SV
import vqacl_tpu_torch.train.step as ST
import vqacl_tpu_torch.mm_bench as MB
D.resolve_device = V.resolve_device = SV.resolve_device = ST.resolve_device = cpu
MB.resolve_device = cpu
from vqacl_tpu_torch.ops import _build, fused_attention as fa
_build.build = lambda names=(), csrc=None: []
dispatch = fa.fused_attention
def route(q, k, H):      # the wrappers' validation, before any launch
    fa.fwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1])
def counted(q, k, v, bias, mask, H, dropout_rate=0.0, seed=None):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        fa.bwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1],
                     dropout_rate)
        return dispatch(q, k, v, bias, mask, H, dropout_rate, seed)
    route(q, k, H)
    counted.launches += 1
    return fa.fused_attention_reference(q, k, v, bias, mask, H)
def counted_fwd_train(*a):
    route(a[0], a[1], a[6])
    counted_fwd_train.launches += 1
    return fa.fused_attention_fwd_train_reference(*a)
def counted_bwd(*a):
    counted_bwd.launches += 1
    return fa.fused_attention_bwd_reference(*a)
for f in (counted, counted_fwd_train, counted_bwd):
    f.launches = 0
fa.fused_attention = counted
fa.fused_attention_fwd_train = counted_fwd_train
fa.fused_attention_bwd = counted_bwd
fa.fused_attention_keep_mask = fa.philox_keep_mask
from vqacl_tpu_torch.ops import dw
def counted_dw(x, g):
    counted_dw.launches += 1
    return dw.dw_splitk_reference(x, g)
counted_dw.launches = 0
dw.dw_splitk = counted_dw
from vqacl_tpu_torch.utils import config as C
_Config = C.Config
def tiny():
    c = _Config()
    c.model = C.tiny_model_config(vocab_size=32200, feat_dim=2048, n_boxes=36,
                                  max_text_length=20, gen_max_length=8,
                                  num_heads=2, d_kv=16)
    c.train.lr = 1e-2
    return c
C.Config = tiny
import chip_smoke
chip_smoke.card_line = lambda: "rehearsal card, 0 W"
chip_smoke.EVAL_BATCH = 4
chip_smoke.TRAIN_BATCH = 8
chip_smoke.TRAIN_STEPS = 4
chip_smoke.DW_PROBE = (64, 16, 24)
chip_smoke.MM_BENCH_SHAPES = dict(B=2, S=6, D=16, F=24, H=2, dk=8)
chip_smoke.MM_BENCH_REPS = 2
with CudaOnCpu():
    sys.exit(chip_smoke.main())
"""


def test_chip_smoke_base_rehearsal_on_cpu():
    # --base: phases 1-2, every timed attention kernel also timed on the
    # base checkout's libraries (here the same checkout), then an "ab"
    # line and no verdict
    r = subprocess.run([sys.executable, "-c", REHEARSAL, "--base", REPO],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    ab = json.loads(lines[-1][len("ab "):])
    assert ab["base"] == os.path.join(REPO, "vqacl_tpu_torch", "csrc")
    rows = [k for k in ab if k not in ("base", "card")]
    assert len(rows) == 9
    for k in rows:
        assert {"ms", "base_ms", "bound_ms"} <= set(ab[k]), k
        assert ("call_ms" in ab[k]) == ("base_call_ms" in ab[k]) \
            == k.startswith("K1"), k
    assert sum(l.startswith("  ab device: base ") for l in lines) == 9
    assert '"ok"' not in r.stdout and "eval_step:" not in r.stdout


def test_chip_smoke_rehearsal_on_cpu():
    r = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "rehearsal", "count": 1}}
    assert lines[-2] == "rehearsal card, 0 W"
    kernels = json.loads(lines[-3])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [set(k) for k in kernels] == [keys] * 4
    assert [k["name"] for k in kernels] == [
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd", "dw_splitk"]
    for k in kernels:
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes",
                                                          "operations")
        assert os.path.exists(os.path.join(REPO, k["source"]))
    for k in kernels[:3]:
        assert k["replaces"].startswith("vqacl_tpu/ops/fused_attention.py:")
    k1, k1p, k2, k5 = kernels
    assert k5["replaces"] == "scripts/mm_bench.py:121"
    assert k5["source"] == "vqacl_tpu_torch/csrc/dw_splitk.cu"
    # K1: 2 layers x 3 timed eval steps, plus one fused-decoder loss-eval
    # step (2 encoder + 2 x 2 decoder attentions)
    assert k1["launches"] == 2 * 3 + 6
    assert "fused_attention launches=6 (2/step)" in r.stdout
    # K1'/K2: 4 train steps x 2 encoder layers, and 4 fused-decoder
    # steps x (2 encoder + 2 x 2 decoder) attentions
    assert k1p["launches"] == k2["launches"] == 2 * 4 + 6 * 4
    assert "train_step: bs 8 bf16" in r.stdout
    assert "launches over 4 steps: K1=0 K1'=8 K2=8" in r.stdout
    assert "launches over 4 steps: K1=0 K1'=24 K2=24" in r.stdout
    assert "rate=0.1 kept=0.9" in r.stdout
    # K1/K1′/K2 name their route; every check launches twice with equal
    # bits
    checks = [l for l in lines if l.startswith("kernel_check ")
              and not l.startswith("kernel_check dw_")
              and not l.startswith("kernel_check refused")]
    assert all("second launch equal: True" in l for l in checks
               if "rate=" not in l)
    assert all(("route=mma.sync bf16" in l) == ("bfloat16" in l)
               and ("route=scalar f32" in l) == ("float32" in l)
               for l in checks)
    assert all("K2 route=mma.sync bf16" in l or "K2 route=scalar f32" in l
               for l in checks if "rate=" in l)
    assert all("second launch equal: K1' True, K2 True" in l
               for l in checks if "rate=" in l)
    # the bf16 routes' edges: K1 once, K1′ and K2 at rates 0 and 0.1
    for name in ("ragged_bf16", "keys128_bf16", "keys300_bf16",
                 "dk128_bf16"):
        assert sum(l.startswith(f"kernel_check {name}:") for l in checks) \
            == 3, name
        assert sum(l.startswith(f"kernel_check {name}:") and "dv=" in l
                   for l in checks) == 2, name
    assert "kernel_check refused_bf16_dk8: K1 and K1' raise ValueError" \
        in r.stdout
    assert "kernel_check refused_bwd_keys512_bf16: a training call raises " \
        "ValueError before K1' launches" in r.stdout
    for dname in ("bfloat16", "float32"):
        assert f"loss_eval fused decoder {dname}" in r.stdout
    assert r.stdout.count("launches K1=6 K1'=0 K2=0") == 2
    # remat: every fused block's forward replays once
    assert "remat=False: " in r.stdout
    for mode in ("full", "dots"):
        assert f"remat={mode}: " in r.stdout
        assert f"remat={mode} vs none: loss equal True" in r.stdout
    assert r.stdout.count("launches K1=0 K1'=12 K2=6") == 2
    # K5: checked at the probe and odd shapes, launched by mm_bench
    # (3 input sets warmed up + 2 timed calls)
    assert r.stdout.count("kernel_check dw_") == 6
    assert "mlp_wi dW dw_splitk (CUDA, K5)" in r.stdout
    assert k5["launches"] == 5
    summary = json.loads(next(l for l in lines if l.startswith("summary "))
                         [len("summary "):])
    assert set(summary["remat"]) == {"False", "full", "dots"}
    assert len(summary["mm_bench"]) == 12


def test_chip_smoke_without_cuda_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
