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
its keys, the card line and the final verdict line; in phase 7 the CL
runs it makes (ER, EWC, DER++ and the tiny card-vs-CPU run) and each
one's K1/K1′/K2 launches against its steps and batches, all strided
(merged projections); in phase 8 the beam, device-cache, cached-CL, HTTP
and pack checks and their launches, at a cache of a few hundred images;
in phase 9 the strided kernel checks, the merged and folded paths, the
classifier head, weight import/export, the directory checkpoint and
VL-BART (tiny BART widths); in phase 10 the VQA CLI's ten-task run from
a tsv-converted pack (the files it leaves, launches against its steps,
``Test()`` equal to the training matrix), the backbone start bit-equal to
the file, NExT-QA's launches against its steps at the 39-position
encoder, the tiny card-vs-CPU CLI pair and the phase's launches in the
kernels line (``torch.device("cuda")`` is left naming the card there, so
the trainers that ``--platform auto`` makes time their calls as on the
card); N1's wrapper replaced by its plain loop plus the launch counter
(its argument checks kept), checked at a 600-box RPN shape and the
sweep's; in phase 11 the detector and the 3D ResNeXt at reduced depth
(the port's stage tables monkeypatched: one narrow block per stage, C4
1024, res5 and the motion features 2048 wide), a 64-px resize, 40
proposals and 32-px videos: the per-image stage times, two N1 launches
per image, the CLI's record generator into a pack read back bit for bit
and answered through K1, the f32 stage checks and both motion halves; in
phase 12 the one-rank mesh (over gloo here, as NCCL needs a card) against
the meshless steps, and its two ranks started by the script (each the
rehearsal itself in rank mode, over gloo on the CPU): the replicated and
FSDP steps, the kernels at the second rank's row offset (the plain
versions here), the tiny CL run with the sharded cache on the "card" and
on the CPU, and their launches and offset launches in the kernels line —
2 steps per run and 16/8/8 items per task in the tiny run —; in phase
13 the tp, pp and tp x pp groups (two, two and four ranks of the
rehearsal in rank mode) against their one-process steps, the tiny tp
and pp ER runs (8/8/8 items) against the CPU's and one process's, the
head-offset check of phase 2, and their launches in the kernels line;
in phase 14 the Table-1 surrogate's three rows at a few items per
task, each a process of the rehearsal in rank mode (each row's launches
against its counts, all on the scalar f32 route; the orderings' margins
lowered, as only the real size can show them: ``test_phase14_orderings``
holds the real ones), the cut row on the "card" against the CPU at both
learning rates and a ten-task soak at tiny widths (its 55-cell matrix
and launches); and that without CUDA the real script prints no
result and exits non-zero.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REHEARSAL = r"""
import os, sys, time
import torch
from torch.overrides import TorchFunctionMode
if "--rank" in sys.argv:   # the script's ranks share the host's cores
    torch.set_num_threads(1)

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
        if func is torch.device:   # a device object may name the card
            return func(*args, **(kwargs or {}))
        kwargs = {k: to_cpu(v) for k, v in (kwargs or {}).items()}
        return func(*(to_cpu(a) for a in args), **kwargs)

class HostEvent:
    def __init__(self, **kw):
        self.t = None
    def record(self):
        self.t = time.perf_counter()
    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3
    def synchronize(self):
        pass

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

# DCP's file writer stages through CUDA streams when it sees a card (the
# rehearsal claims one): its serial loader here
import torch.distributed.checkpoint.filesystem as FS
FS._OverlappingCpuLoader = lambda fn, **kw: FS._SerialCpuLoader(fn)

from vqacl_tpu_torch.utils import device as D
cpu = lambda d: torch.device("cpu")
import vqacl_tpu_torch.models.vlt5 as V, vqacl_tpu_torch.serve as SV
import vqacl_tpu_torch.train.step as ST
import vqacl_tpu_torch.mm_bench as MB
import vqacl_tpu_torch.cl.trainer as CT, vqacl_tpu_torch.cl.regularizers as RG
import vqacl_tpu_torch.data.device_cache as DC
import vqacl_tpu_torch.cli.args  # noqa: F401 (--platform auto: the "card")
D.resolve_device = V.resolve_device = SV.resolve_device = ST.resolve_device = cpu
MB.resolve_device = RG.resolve_device = cpu
DC.resolve_device = cpu
from vqacl_tpu_torch.ops import _build, fused_attention as fa
_build.build = lambda names=(), csrc=None: []
dispatch = fa.fused_attention
fwd_train, bwd = fa.fused_attention_fwd_train, fa.fused_attention_bwd
def rows(what, route, q, k, v, more=()):
    # the wrappers' layout checks: rows of one stride each, 16-byte rows
    # on the bf16 route → whether the call is strided
    lds = fa._qkv_strides(q, k, v)
    if route == "mma":
        fa._check_rows16(what, list(zip("qkv", (q, k, v), lds)) + list(more))
    return lds != (q.shape[-1],) * 3
def route(f, q, k, v, H):   # the wrappers' validation, before any launch
    r = fa.fwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1])
    f.route_launches[r] += 1
    return rows("fused_attention", r, q, k, v)
def counted(q, k, v, bias, mask, H, dropout_rate=0.0, seed=None, bh0=0,
            Hc=None, h0=0):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        fa.bwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1],
                     dropout_rate)
        return dispatch(q, k, v, bias, mask, H, dropout_rate, seed, bh0, Hc,
                        h0)
    counted.strided_launches += route(counted, q, k, v, H)
    counted.launches += 1
    return fa.fused_attention_reference(q, k, v, bias, mask, H)
def counted_fwd_train(*a, **kw):
    counted_fwd_train.strided_launches += route(counted_fwd_train, a[0], a[1],
                                                a[2], a[6])
    counted_fwd_train.launches += 1
    bh0 = a[8] if len(a) > 8 else kw.get("bh0", 0)
    h0 = a[10] if len(a) > 10 else kw.get("h0", 0)
    counted_fwd_train.offset_launches += bh0 != 0
    counted_fwd_train.head_offset_launches += h0 != 0
    return fwd_train(*a, **kw)       # the plain version on CPU tensors
def counted_bwd(*a, **kw):
    q, k, v, do, H = a[0], a[1], a[2], a[5], a[6]
    r = fa.bwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1], a[8])
    strided = rows("fused_attention_bwd", r, q, k, v,
                   [("do", do, do.shape[-1])])
    res = bwd(*a, **kw)              # the plain version on CPU tensors
    counted_bwd.route_launches[r] += 1
    counted_bwd.launches += 1
    counted_bwd.strided_launches += strided
    counted_bwd.offset_launches += kw.get("bh0", 0) != 0
    counted_bwd.head_offset_launches += kw.get("h0", 0) != 0
    return res
for f in (counted, counted_fwd_train, counted_bwd):
    f.launches = f.strided_launches = f.offset_launches = 0
    f.head_offset_launches = 0
    f.route_launches = dict.fromkeys(fa.ROUTE_NAMES, 0)
fa.fused_attention = counted
fa.fused_attention_fwd_train = counted_fwd_train
fa.fused_attention_bwd = counted_bwd
fa.fused_attention_keep_mask = fa.philox_keep_mask
from vqacl_tpu_torch.ops import dw
def counted_dw(x, g):
    dw._validate(x, g)               # the wrapper's checks and its route
    route = dw.dw_route(x.shape[0], x.shape[1], g.shape[1], x.dtype, x, g)
    counted_dw.launches += 1
    counted_dw.route_launches[route] += 1
    return dw.dw_splitk_reference(x, g)
counted_dw.launches = 0
counted_dw.route_launches = dict.fromkeys(dw.ROUTES, 0)
dw.dw_splitk = counted_dw
from vqacl_tpu_torch.ops import nms as NM
def counted_nms(b, v, t):
    NM._validate(b, v, t)            # the wrapper's checks, before a launch
    counted_nms.launches += 1
    return NM.greedy_nms_reference(b, v, t)
counted_nms.launches = 0
NM.greedy_nms = counted_nms
# phase 11 at reduced depth (C4 1024 and res5 2048, the 3D ResNeXt's last
# stage 2048 wide) and a 64-px resize
from vqacl_tpu_torch.vision import frcnn as FR, resnet as RN, resnext3d as RX
RN.R101_STAGES = [("res2", 1, 32, 8, 1), ("res3", 1, 64, 8, 2),
                  ("res4", 1, 1024, 16, 2)]
RN.RES5 = ("res5", 1, 2048, 16, 2)
RX.R3D101_STAGES = [(1, 32, 1), (1, 1024, 2)]
_resize = FR.resize_shortest_edge
FR.resize_shortest_edge = lambda img, short=64, max_size=128: _resize(
    img, short, max_size)
FR.PAD_BUCKETS = (64, 96, 128)
_er, _erb = FR.extract_regions, FR.extract_regions_batch
FR.extract_regions = lambda *a, n_proposals=40, **k: _er(
    *a, n_proposals=n_proposals, **k)
FR.extract_regions_batch = lambda *a, n_proposals=40, **k: _erb(
    *a, n_proposals=n_proposals, **k)
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
vqacl_tpu_torch.cli.args.Config = tiny
import chip_smoke
chip_smoke.card_line = lambda: "rehearsal card, 0 W"
chip_smoke.EVAL_BATCH = 4
chip_smoke.TRAIN_BATCH = 8
chip_smoke.TRAIN_STEPS = 4
chip_smoke.DW_PROBE = (64, 16, 24)
chip_smoke.DW_LADDER = ((16, 64, 128), (24, 16, 40))
chip_smoke.dw_sms = lambda: 132
# the CPU build of torch has no kernel for mm with out_dtype
chip_smoke.mm_f32_out = lambda a, b: a.float() @ b.float()
chip_smoke.MM_BENCH_SHAPES = dict(B=2, S=6, D=16, F=24, H=2, dk=8)
chip_smoke.MM_BENCH_REPS = 2
chip_smoke.CL_ITEMS = (24, 8, 8)
chip_smoke.CL_REG_TRAIN = 16
chip_smoke.CL_IMAGES = 16
chip_smoke.CL_M_SIZE = 10
chip_smoke.CL_TINY = (24, 8, 8)
chip_smoke.CL_TINY_BATCH = 8
chip_smoke.CACHE_IMAGES = 300
chip_smoke.PACK_IMAGES = 24
chip_smoke.MERGED_ROUNDS = 2
chip_smoke.CLS_ANSWERS = 16
chip_smoke.CLS_LR = 1e-2
chip_smoke.BART_CFG = dict(chip_smoke.BART_TINY, dropout_rate=0.1)
chip_smoke.P10_ITEMS = (12, 4, 4)
chip_smoke.P10_IMAGES = 16
chip_smoke.NQ_ITEMS = (24, 8, 8)
chip_smoke.NQ_VIDEOS = 16
chip_smoke.P10_TINY = (16, 8, 8)
chip_smoke.P10_TINY_BATCH = 8
chip_smoke.NMS_RPN = (600, (0.7,), 60)
chip_smoke.P11_F32_IMAGE = ((64, 96), (56, 90))
chip_smoke.P11_VIDEO_FRAMES = 20
chip_smoke.P11_VIDEO_SIDE = 32
chip_smoke.P11_MOTION_SIDE = 16
# phase 12: the one-rank group over gloo (NCCL needs a card); each rank
# this rehearsal again, in the script's rank mode
chip_smoke.P12_ONE_RANK_BACKEND = "gloo"
chip_smoke.P12_STEPS = 2
chip_smoke.P12_TINY = (16, 8, 8)
chip_smoke.RANK_CMD = [sys.executable, "-c",
                       os.environ["CHIP_SMOKE_REHEARSAL"]]
# phase 13: the same ranks; a smaller tiny run. The tiny bf16 model here
# (d_model 32, lr 1e-2) turns the tp partial sums' bf16 roundings into
# up to ~0.14 of an update through Adam (2.4-2.6e-2 at t5-base on the
# card): the bound of this control-flow rehearsal is 0.25
chip_smoke.P13_TINY = (8, 8, 8)
chip_smoke.P13_PARAM_RTOL = 0.25
# phase 14 at a few items per task: the surrogate's rows (their orderings
# need its real size, so the margins here only exercise the checks), the
# cut row and a ten-task soak over the tiny widths
chip_smoke.P14_ARGV = ("--tasks", "2", "--n_train", "16", "--n_eval", "8",
                       "--epochs", "1", "--m_size", "8")
chip_smoke.P14_ORDERINGS = (("ours", "vanilla", "Avg_acc", -200.0),
                            ("vanilla", "ours", "Avg_forget", -200.0),
                            ("er", "vanilla", "Avg_acc", -200.0))
chip_smoke.P14_CUT_ARGV = ("--tasks", "2", "--n_train", "24", "--n_eval",
                           "8", "--epochs", "1")
import vqacl_tpu_torch.soak as SK
SK.SCALES["small"] = dict(epochs=1, m_size=8, n_train=8, n_images=None)
SK.N_VAL = SK.N_TEST = 4
with CudaOnCpu():
    sys.exit(chip_smoke.main())
"""
ENV = dict(os.environ, CHIP_SMOKE_REHEARSAL=REHEARSAL)


def test_chip_smoke_base_rehearsal_on_cpu():
    # --base: phases 1-2, every timed attention kernel, N1 and K5 also
    # timed on the base checkout's libraries (here the same checkout),
    # then an "ab" line and no verdict
    r = subprocess.run([sys.executable, "-c", REHEARSAL, "--base", REPO],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=ENV)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    ab = json.loads(lines[-1][len("ab "):])
    assert ab["base"] == os.path.join(REPO, "vqacl_tpu_torch", "csrc")
    rows = [k for k in ab if k not in ("base", "card")]
    assert len(rows) == 15
    for k in rows:
        assert {"ms", "base_ms", "bound_ms"} <= set(ab[k]), k
        assert ("call_ms" in ab[k]) == ("base_call_ms" in ab[k]) \
            == k.startswith("K1"), k
    assert {"N1 rpn", "N1 sweep", "K5 probe"} <= set(rows)
    assert sum(l.startswith("  ab device: base ") for l in lines) == 15
    assert '"ok"' not in r.stdout and "eval_step:" not in r.stdout


def test_chip_smoke_rehearsal_on_cpu():
    r = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=REPO,
                       capture_output=True, text=True, timeout=400, env=ENV)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "rehearsal", "count": 1}}
    assert lines[-2] == "rehearsal card, 0 W"
    kernels = json.loads(lines[-3])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    # K1′ and K2 also note phase 12's and 13's launches at a row offset
    # and phase 13's over a tp rank's heads
    offs = {"offset_launches", "head_offset_launches"}
    assert [set(k) for k in kernels] == [
        keys, keys | offs, keys | offs, keys, keys]
    assert [k["name"] for k in kernels] == [
        "fused_attention_fwd", "fused_attention_fwd_train",
        "fused_attention_bwd", "dw_splitk", "greedy_nms"]
    for k in kernels:
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes",
                                                          "operations")
        assert os.path.exists(os.path.join(REPO, k["source"]))
    for k in kernels[:3]:
        assert k["replaces"].startswith("vqacl_tpu/ops/fused_attention.py:")
    k1, k1p, k2, k5, n1 = kernels
    assert k5["replaces"] == "scripts/mm_bench.py:121"
    assert k5["source"] == "vqacl_tpu_torch/csrc/dw_splitk.cu"
    assert n1["replaces"] == \
        "vqacl_tpu/vision/rpn.py:154, vqacl_tpu/ops/nms.py:83"
    assert n1["source"] == "vqacl_tpu_torch/csrc/nms.cu"
    assert n1["library_ms"] is None
    summary = json.loads(next(l for l in lines if l.startswith("summary "))
                         [len("summary "):])
    # phase 7: the ER, EWC and DER++ runs and the tiny run on the card,
    # each with its launches checked against its steps and batches
    cl = summary["cl"]
    assert set(cl) == {"er", "ewc", "derpp"}
    cl_k = [sum(r["launches"][i] for r in cl.values())
            + summary["cl_tiny"]["launches"][i] for i in range(3)]
    for name, run in cl.items():
        c = run["counts"]
        steps = c["train_steps"] + c.get("replay_steps", 0)
        assert run["launches"] == run["expected_launches"] == [
            2 * (c["predict_batches"] + c.get("capture_batches", 0)),
            2 * (steps + c.get("importance_batches", 0)),
            2 * (steps + c.get("importance_batches", 0))], name
        assert c.get("replay_steps", 0) > 0 and min(run["launches"]) > 0
        line = next(l for l in lines
                    if l.startswith(f"cl_{name}: wall shares"))
        k1_, k1p_, _ = run["launches"]
        assert f"launches K1={k1_} K1'={k1p_} K2={k1p_} (expected " \
            f"{k1_}/{k1p_}/{k1p_})" in line
        assert set(run["wall_share"]) == {"train", "predict", "loader",
                                          "checkpoint"}
        assert len(run["task_wall_s"]) == 2
        assert run["train_step_ms_median"] > 0
        assert len(run["checkpoint_save_ms"]) == 2
        assert len(run["losses"]) == steps
    assert cl["ewc"]["counts"]["importance_batches"] == 2 * 2
    assert len(cl["ewc"]["importance_batch_ms"]) == 2 * 2
    assert cl["derpp"]["counts"]["capture_batches"] > 0
    assert len(cl["derpp"]["capture_batch_ms"]) == \
        cl["derpp"]["counts"]["capture_batches"]
    tiny = next(l for l in lines if l.startswith("cl tiny f32 "))
    assert '"result_matrix": true, "comp": true, "noncomp": true, ' \
        '"answers": true' in tiny
    assert summary["cl_tiny"]["loss_rel_err"] <= 1e-5
    assert min(summary["cl_tiny"]["launches"]) > 0
    # phase 8: the beam, cached, HTTP and pack runs and the cached CL runs
    p8 = summary["serving_extras"]
    p8_k = summary["serving_extras_launches"]
    ext_cl = [p8["cl_er_cached"]["launches"][i]
              + p8["cl_er_host"]["launches"][i]
              + p8["cl_tiny_int8_cache"]["launches"][i] for i in range(3)]
    # K1: 3 beam steps, one cached eval step, the HTTP batches and the
    # pack predictor's two batches, 2 layers each
    assert p8_k[0] == 2 * (3 + 1 + p8["http"]["batches"] + 2) + ext_cl[0]
    # K1'/K2: one cached train step of 2 layers
    assert p8_k[1] == p8_k[2] == 2 + ext_cl[1]
    # phase 9: K1 in 6 eval steps (greedy and beam, separate, merged and
    # folded) and 3 classifier evals; K1'/K2 in 3 rounds of 4 train steps
    # with the plain (2 layers) and the fused decoder (6 attentions), and
    # in 5 classifier steps
    p9 = summary["model_extensions"]
    p9_k = summary["model_extensions_launches"]
    assert p9_k[0] == 2 * (6 + 3)
    assert p9_k[1] == p9_k[2] == 3 * 4 * (2 + 6) + 5 * 2
    # phase 10: the VQA CLI's training run and Test(), NExT-QA and the
    # tiny card runs, each against its steps and batches
    p10 = summary["training_cli"]
    p10_k = summary["training_cli_launches"]
    runs10 = [p10["vqa"], p10["nextqa"]]
    for run in runs10:
        c = run["counts"]
        steps = c["train_steps"] + c["replay_steps"]
        assert run["launches"] == run["expected_launches"] == [
            2 * c["predict_batches"], 2 * steps, 2 * steps]
        assert run["strided_launches"] == run["launches"]
        assert c["replay_steps"] > 0
    assert len(p10["vqa"]["task_wall_s"]) == 10
    assert len(p10["vqa"]["checkpoint_save_ms"]) == 10
    test10 = p10["vqa_test"]
    assert test10["equal_to_training"]
    assert test10["result_matrix"] == p10["vqa"]["result_matrix"]
    assert test10["launches"] == test10["strided_launches"] == [
        2 * test10["predict_batches"], 0, 0]
    assert test10["predict_batches"] == 55
    assert p10["backbone"] == {"bit_equal": True, "scratch_differs": True,
                               "start_s": p10["backbone"]["start_s"]}
    nq = p10["nextqa"]
    assert nq["encoder_len"] == 39 and len(nq["task_wall_s"]) == 2
    assert nq["wups_backend"] == ["vendored-taxonomy"]
    assert 0.0 <= nq["wups_vocab_coverage"][0] <= 1.0
    for name, cls in (("vqa", "CompVQACLTrainer"),
                      ("nextqa", "VQACLTrainer")):
        t = p10["tiny"][name]
        assert t["cls"] == cls and all(t["equal"].values())
        assert t["loss_rel_err"] <= 1e-5 and min(t["launches"]) > 0
        assert f"cli tiny f32 {name} ({cls}), --platform auto on cuda vs " \
            f"cpu on cpu" in r.stdout
    assert p10_k == [sum(x["launches"][i] for x in runs10
                         + [test10] + list(p10["tiny"].values()))
                     for i in range(3)]
    assert "feature store PackedFeatureStore" in r.stdout
    assert "cli_vqa: Test() matrix == the training run's: True" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase10"))
    # NExT-QA's 39 x 39 shape in phase 2: K1 at the eval batch, K1' and K2
    # at rates 0 and 0.1, dense and strided, each timed once
    for name, n in (("nextqa_eval_shape", 1), ("nextqa_train_shape", 2)):
        assert sum(l.startswith(f"kernel_check {name}:") and "Tq=39 Sk=39"
                   in l and "L=23" in l for l in lines) == n, name
        assert sum(l.startswith(f"strided_check {name}:") for l in lines) \
            == n, name
    assert set(summary["nextqa_kernel_times"]) == {"K1", "K1p", "K2"}
    # K1: 2 layers x 3 timed eval steps, plus one fused-decoder loss-eval
    # step (2 encoder + 2 x 2 decoder attentions), plus the CL loops
    p11 = summary["extraction"]
    p11_k = summary["extraction_launches"]
    p12 = summary["data_parallel"]
    p12_k = summary["data_parallel_launches"]
    p13_k = summary["tensor_pipeline_launches"]
    p14_k = summary["protocol_runs_launches"]
    assert k1["launches"] == 2 * 3 + 6 + cl_k[0] + p8_k[0] + p9_k[0] \
        + p10_k[0] + p11_k[0] + p12_k[0] + p13_k[0] + p14_k[0]
    assert "fused_attention launches=6 (2/step)" in r.stdout
    # K1'/K2: 4 train steps x 2 encoder layers, and 4 fused-decoder
    # steps x (2 encoder + 2 x 2 decoder) attentions, plus the CL loops
    assert k1p["launches"] == k2["launches"] == 2 * 4 + 6 * 4 + cl_k[1] \
        + p8_k[1] + p9_k[1] + p10_k[1] + p12_k[1] + p13_k[1] + p14_k[1]
    assert cl_k[1] == cl_k[2]
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
    # K1 at the DER capture's shape (the train batch), bf16
    assert sum(l.startswith("kernel_check capture_shape:") and "bfloat16" in l
               for l in checks) == 1
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
    # K5: the ladder, the probe, the odd shapes (bf16 and f32) and the f32
    # probe, each on its route; launched by mm_bench on the wgmma route
    # (3 input sets warmed up + 2 timed calls)
    dw_lines = [l for l in lines if l.startswith("kernel_check dw_")]
    assert len(dw_lines) == 2 + 1 + 4 + 1
    assert all(l.endswith("-> ok") for l in dw_lines)
    assert sum("route=wgmma N=256 (plan: " in l
               for l in dw_lines) == 2 + 1 + 1
    assert [l.split()[1] for l in dw_lines if "route=mma" in l] == \
        ["dw_odd:"]
    assert sum("route=f32" in l for l in dw_lines) == 3
    assert "kernel_time dw_probe (wgmma): " in r.stdout
    assert "mlp_wi dW dw_splitk (CUDA, K5)" in r.stdout
    assert k5["launches"] == 5
    assert summary["mm_bench_dw_route_launches"] == {"wgmma": 5, "mma": 0,
                                                     "f32": 0}
    assert {"ms", "library_ms", "library_bf16_ms", "bound_ms"} <= \
        set(summary["k5_probe"])
    assert set(summary["remat"]) == {"False", "full", "dots"}
    assert len(summary["mm_bench"]) == 12
    # phase 8
    assert "beam: bs 4 x 5 beams bf16 eval_step_ms=" in r.stdout
    assert "launches over 3 steps: K1=6 K1'=0 K2=0" in r.stdout
    assert len(p8["beam"]["eval_step_ms"]) == 3
    assert p8["beam"]["min_logp_gap"] >= -1e-3
    assert all(p8["tiny_card_equals_cpu"].values())
    assert len(p8["tiny_card_equals_cpu"]) == 5
    assert "bf16 table == features rounded to bf16, bit for bit: True" \
        in r.stdout
    assert "slot -1 and out of range give zeros: True" in r.stdout
    assert p8["cache"]["eval_tokens_equal"]
    assert p8["cache"]["train_loss_rel"] <= 1e-6
    assert p8["cache"]["int8_worst_err_over_scale"] <= 0.5 + 2e-5
    h2d = p8["cache"]["h2d_bytes"]
    assert h2d["eval_cached"] == 4 * 20 * 4 + 4 * 4
    assert h2d["eval_host"] - h2d["eval_cached"] == 4 * 36 * (2048 + 4) * 4 \
        - 4 * 4
    assert h2d["train_host"] - h2d["train_cached"] == \
        8 * 36 * (2048 + 4) * 4 - 8 * 4
    er = p8["cl_er_cached"]
    assert er["launches"] == er["expected_launches"] and min(
        er["launches"]) > 0 and er["counts"]["replay_steps"] > 0
    assert p8["cl_er_host"]["launches"] == er["launches"]
    assert "cl_er_cached: phase 7's ER run, data.device_cache=True" \
        in r.stdout
    assert "cl_er cached vs host: " in r.stdout
    assert "objects tracked by gc" in r.stdout
    tiny8 = p8["cl_tiny_int8_cache"]
    assert all(tiny8["equal"].values()) and tiny8["loss_rel_err"] <= 1e-5
    assert min(tiny8["launches"]) > 0
    http = p8["http"]
    assert http["stats"]["errors"] == 0
    assert http["stats"]["requests"] == 16 * 3 + 8 + 1
    assert "answers == predictor.answer: True" in r.stdout
    assert "predictor over the pack answers as over the memory store: " \
        "True" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase8.vfpack"))
    # phase 7 runs merged (the trainer resolves "auto"): every launch of
    # its loops strided
    for name, run in cl.items():
        assert run["merged_qkv"] and run["strided_launches"] == \
            run["launches"], name
        assert f"cl_{name}: t5-base bf16 compute" in r.stdout
    assert "merged_qkv True (the trainer's resolve of 'auto')" in r.stdout
    # phase 9: strided K1/K1'/K2 bit-equal to dense at every shape and
    # layout, the bad stride refused, merged/folded steps, tokens, the
    # classifier head, weights through .pth/.safetensors/export/DCP,
    # VL-BART
    checks = [l for l in lines if l.startswith("strided_check ")
              and "refused" not in l]
    assert len(checks) == 2 * 6 + 3 + 3     # + NExT-QA's, phase 2
    assert all('"K1\'": true, "K2": true, "K2 merged buffer": true' in l
               and "strided launches K1/K1'/K2 [" in l for l in checks)
    assert sum("layout=folded" in l for l in checks) == 2
    assert sum(l.startswith("strided_time ") for l in lines) == \
        3 * 2 + 1 + 2
    assert "K1, K1' and K2 raise ValueError before any launch" in r.stdout
    for label, per_step in (("encoder", 2), ("fused_decoder", 6)):
        t = p9["train"][label]
        assert t["launches_per_merged_step"] == [[0, per_step, per_step]] * 2
        assert t["grad_rel"] <= 3e-2 and t["loss_rel"] <= 3e-2
        assert len(t["train_step_ms_all"]["merged"]) == 2 * 2
    assert p9["decode_tokens_equal"] == {
        "greedy": {"merged": True, "folded": True},
        "beam5": {"merged": True, "folded": True}}
    assert all(t["tokens_equal"] and t["loss_rel_err"] <= 1e-5
               for t in p9["tiny_merged_folded"].values())
    cls = p9["classifier"]
    assert len(cls["losses"]) == 5 and cls["losses"][-1] < cls["losses"][0]
    assert cls["eval_launches"] == [[6, 0, 0], [6, 0, 0]]
    assert all(p9["io_equal"].values()) and set(p9["io"]) == {
        "pth", "safetensors", "export_pth", "dcp"}
    assert all(r_["bytes"] > 0 for r_ in p9["io"].values())
    assert p9["bart"]["finite"] and p9["bart"]["shape_ok"]
    assert p9["bart"]["tiny_f32_err_over_tol"] <= 1.0
    for d in ("phase7", "phase9"):
        assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                               d))
    # N1 in phase 2: the RPN, sweep, all-invalid and scarce cases, bit-equal
    # to its plain version twice; the RPN and sweep shapes timed
    n1_checks = [l for l in lines if l.startswith("kernel_check nms_")]
    assert len(n1_checks) == 4
    assert all("differing from plain=0" in l and "second launch equal: True"
               in l for l in n1_checks)
    assert sum(l.startswith("kernel_time nms_") for l in lines) == 2
    assert set(summary["nms_kernel_times"]) == {"rpn", "sweep"}
    # phase 11 at reduced depth: per-image stage times, two N1 launches per
    # image, the CLI's pack read back and answered through K1, the f32
    # stage checks, both video motion halves
    assert len(p11["images"]) == 4 and p11["n1_per_image"] == 2
    assert len({tuple(i["bucket"]) for i in p11["images"]}) >= 2
    for im in p11["images"]:
        assert list(im["stage_ms"]) == ["backbone", "rpn", "roi_align",
                                        "res5_heads", "nms36", "attr"]
    assert p11["cli"] == {"records": 4, "write_s": p11["cli"]["write_s"],
                          "answers": 16, "k1": 2}
    assert p11_k == [2, 0, 0]
    assert "bit for bit: True" in r.stdout
    assert all(p11["f32"]["bit_equal"].values())
    assert max(p11["f32"]["rel_err"].values()) <= 1e-4
    assert p11["batch"]["c4_rel_err"] <= 1e-4
    assert set(p11["video"]) == {"rgb_diff", "resnext3d"}
    assert set(p11["video"]["resnext3d"]["parts"]) == {
        "load_clips_ms", "resize_ms", "resnext3d_ms"}
    assert all(i["resize_ms"] > 0 for i in p11["images"])
    assert all(len(v["ms"]) == 2 for v in p11["video"].values())
    # N1 on the main path: four warm-up and four timed images, the CLI's
    # four records, two launches each
    assert summary["extraction_n1_launches"] == n1["launches"] == 2 * 12
    assert "phase 11: TF32 flags restored" in r.stdout
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase11"))
    # phase 12: (a) 2 steps of 2 layers on a one-rank mesh, bit-equal to
    # the meshless steps; (b)-(c) 2 steps per rank of each of the three
    # runs (dropout 0, 0.1, FSDP), the second rank's at its row offset;
    # (d) the tiny runs' launches on the card
    assert p12["one_rank"]["bit_equal"]
    assert p12["one_rank"]["launches"] == [0, 4, 4]
    tiny12 = p12["tiny"]["launches"]
    assert p12_k == [sum(t[0] for t in tiny12),
                     4 + 2 * 3 * 4 + sum(t[1] for t in tiny12),
                     4 + 2 * 3 * 4 + sum(t[2] for t in tiny12)]
    assert min(min(t) for t in tiny12) > 0
    # rank 1 runs every step at its offset: 3 runs x 2 steps x 2 layers
    # and its tiny run's train and replay steps
    assert summary["data_parallel_offset_launches"] == [
        3 * 4 + tiny12[1][1], 3 * 4 + tiny12[1][2]]
    p13_off = summary["tensor_pipeline_offset_launches"]
    assert k1p["offset_launches"] == \
        summary["data_parallel_offset_launches"][0] + p13_off[0]
    assert k2["offset_launches"] == \
        summary["data_parallel_offset_launches"][1] + p13_off[1]
    assert all(p12["offset_check"]["same"].values())
    assert p12["rel_to_one_process"] <= 3e-2
    assert p12["fsdp_rel_to_replicated"] <= 3e-2
    assert p12["tiny"]["equal"] == {"result_matrix": True, "answers": True,
                                    "ranks": True}
    assert p12["tiny"]["loss_rel_err"] <= 1e-5
    assert p12["tiny"]["lookups"] > 0
    assert p12["all_reduce_bytes_per_step"] > 0
    # the tiny model shards its embedding alone: 0.518 of the state here,
    # ~0.500 at t5-base
    assert p12["state_bytes"]["fsdp"] / p12["state_bytes"]["replicated"] \
        <= 0.52
    assert "bit-equal to the meshless step: True" in r.stdout
    assert "dp all_reduce: one flat f32 bucket of" in r.stdout
    assert sum(l.startswith("rank 1: offset_check:") for l in lines) == 1
    # phase 13 (2 layers of 2 heads here): (a) tp = 2, 3 steps at dropout
    # 0 and 0.1, 2 K1′ + 2 K2 per step per rank, rank 1's over its head;
    # (b) pp = 2, 2 steps, one layer per stage x 4 microbatches; (c) tp x
    # pp on four ranks; (d) the tiny runs equal the CPU's and one
    # process's, rank 0's checkpoint loaded; (e) phase 2's head offset
    p13 = summary["tensor_pipeline"]
    assert all(p13["head_offset_check"]["same"].values())
    assert p13["head_offset_check"]["heads"] == [1, 2]
    for part, keys_ in (("tp", ("d0", "d0.1")), ("pp", ("d0",)),
                        ("tppp", ("d0",))):
        for key in keys_:
            run = p13[part][key]
            assert run["rel_to_one"] <= 0.25 and run["loss_rel_err"] <= 1e-2
            assert len(run["step_ms"]) == (4 if part == "tppp" else 2)
    assert p13["tp"]["d0"]["all_reduce_per_step"]["all_reduce_tp_bytes"] > 0
    assert "all_reduce_dpp_bytes" not in p13["tp"]["d0"][
        "all_reduce_per_step"]
    assert p13["tp"]["d0"]["state_ratio"] < 1
    assert p13["pp"]["ticks"] == 5 and p13["pp"]["bucket_bytes"] > 0
    assert p13["pp"]["d0"]["all_reduce_per_step"][
        "all_reduce_dpp_bytes"] == p13["pp"]["bucket_bytes"]
    for part in ("tp", "pp"):
        assert all(p13[part]["tiny"]["equal"].values()), part
    tiny13 = p13["tp"]["tiny"]["launches"] + p13["pp"]["tiny"]["launches"]
    # per rank: tp 2 x 3 steps x 2 layers; pp 2 steps x 4 microbatches;
    # tp x pp 2 steps x 4 microbatches on four ranks
    assert p13_k == [sum(t[0] for t in tiny13),
                     2 * 12 + 2 * 8 + 4 * 8 + sum(t[1] for t in tiny13),
                     2 * 12 + 2 * 8 + 4 * 8 + sum(t[2] for t in tiny13)]
    head13 = summary["tensor_pipeline_head_offset_launches"]
    assert head13[0] == head13[1] == k1p["head_offset_launches"] == \
        k2["head_offset_launches"] == 12 + 2 * 8 + p13["tp"]["tiny"][
            "launches"][1][1]
    for part in ("tp", "pp"):
        for where in ("cuda", "cpu"):
            assert any(l.startswith(f"rank 0: p13_tiny_{part}_{where}_rank0:"
                                    f" wall ") for l in lines), (part, where)
    assert any(l.startswith("p13_tiny_one: wall ") for l in lines)
    assert any(l.startswith("head_offset_check: heads 1..1 of 2")
               for l in lines)
    # phase 2: the surrogate's encoder (4 heads of 8 over 10 positions) in
    # f32, K1 once and K1'/K2 at rates 0 and 0.1
    assert sum(l.startswith("kernel_check surrogate_f32:") and "Tq=10 Sk=10"
               in l and "float32" in l for l in lines) == 3
    # phase 14: (a) the surrogate's rows, each row's launches what its
    # counts imply, all on the scalar f32 route, the orderings checked; (b)
    # the cut row on the card == on the CPU; (c) the ten-task soak's
    # 55-cell matrix and its launches, all on the bf16 route
    p14 = summary["protocol_runs"]
    rows14 = p14["surrogate"]["rows"]
    assert list(rows14) == ["vanilla", "er", "ours"]
    for name, row in rows14.items():
        c = row["counts"]
        steps = c["train_steps"] + c.get("replay_steps", 0) \
            + c.get("importance_batches", 0)
        assert row["launches"] == row["expected_launches"] == [
            2 * c["predict_batches"], 2 * steps, 2 * steps], name
        assert [r["scalar"] for r in row["route_launches"]] == \
            row["launches"], name
        assert [r["mma"] for r in row["route_launches"]] == [0, 0, 0]
        assert (c.get("replay_steps", 0) > 0) == (name != "vanilla")
        assert row["seed"] == 0 and row["wall_s"] > 0
        assert {"Avg_acc", "Avg_forget", "diag_acc"} <= set(row)
        assert f"p14_{name}: Avg_acc {row['Avg_acc']} Avg_forget " in r.stdout
        assert row["route_launches"][0]["scalar"] == row["launches"][0]
    assert [t[1] for t in p14["surrogate"]["orderings"]] == [True] * 3
    assert sum(l.startswith("p14 ordering: ") for l in lines) == 3
    cut = p14["cut"]
    assert list(cut) == ["surrogate_lr", "lr_0.001"]
    for tag, run in cut.items():
        assert all(run["equal"].values()), tag
        assert run["launches"] == run["expected_launches"], tag
        assert min(run["launches"]) > 0 and run["counts"]["replay_steps"] > 0
    # the losses are held to CL_LOSS_RTOL at lr 1e-3, recorded at 1e-2
    assert cut["lr_0.001"]["equal"]["losses"]
    assert cut["lr_0.001"]["loss_rel_err"] <= 1e-5
    assert "losses" not in cut["surrogate_lr"]["equal"]
    soak = p14["soak"]
    assert soak["matrix_complete"] and len(soak["task_wall_s"]) == 10
    assert soak["launches"] == soak["expected_launches"]
    assert min(soak["launches"]) > 0
    assert [r["mma"] for r in soak["route_launches"]] == soak["launches"]
    assert "p14 soak: 10 tasks, 55-cell matrix complete True" in r.stdout
    assert any(l.startswith("SOAK small: ") for l in lines)
    assert p14_k == [sum(x["launches"][i] for x in [*rows14.values(),
                                                     *cut.values(), soak])
                     for i in range(3)]
    # the rows ran as processes of the script in rank mode, side by side
    for name in rows14:
        assert any(l.startswith(f"rank {list(rows14).index(name)}: p14_"
                                f"{name}: Avg_acc ") for l in lines), name
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke",
                                           "phase14"))


def test_chip_smoke_without_cuda_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_phase14_orderings():
    """Phase 14's orderings at their real margins, about half the smallest
    single-seed gaps of ABLATION.md's per-seed lines: ABLATION.md's seed-0
    cells pass them, and a gap one point short of each fails it."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.P14_ORDERINGS == (
        ("ours", "vanilla", "Avg_acc", 20.0),
        ("vanilla", "ours", "Avg_forget", 25.0),
        ("er", "vanilla", "Avg_acc", 10.0))
    seed0 = {"vanilla": {"Avg_acc": 39.96, "Avg_forget": 75.0},
             "er": {"Avg_acc": 66.24, "Avg_forget": 35.05},
             "ours": {"Avg_acc": 89.8, "Avg_forget": 12.05}}
    got = chip_smoke.p14_orderings(seed0)
    assert [h for _, h in got] == [True] * 3
    assert got[0][0] == "ours Avg_acc 89.800 >= vanilla 39.960 + 20 " \
        "(gap +49.840)"
    for i, (hi, lo, metric, margin) in enumerate(chip_smoke.P14_ORDERINGS):
        rows = {k: dict(v) for k, v in seed0.items()}
        rows[hi][metric] = rows[lo][metric] + margin - 1.0
        held = [h for _, h in chip_smoke.p14_orderings(rows)]
        assert held[i] is False, (hi, lo, metric)
        rows[lo][metric] = 10.0                           # the edge holds
        rows[hi][metric] = 10.0 + margin
        assert chip_smoke.p14_orderings(rows)[i][1] is True


def test_phase14_launch_accounting():
    """The launches a run's counted calls imply (encoder layers times
    train + replay + importance steps for K1'/K2, predict + capture
    batches for K1) and the soak's matrix check."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from vqacl_tpu_torch.soak import expected_launches

    counts = {"train_steps": 7, "replay_steps": 5, "predict_batches": 11,
              "importance_batches": 3, "capture_batches": 2}
    assert expected_launches(counts, 2) == [2 * 13, 2 * 15, 2 * 15]
    assert expected_launches({"train_steps": 4}, 12) == [0, 48, 48]
    full = [[50.0 if j <= i else -1.0 for j in range(10)] for i in range(10)]
    assert chip_smoke.p14_matrix_complete(full, 10)
    hole = [row[:] for row in full]
    hole[9][3] = -1.0                   # a cell never evaluated
    assert not chip_smoke.p14_matrix_complete(hole, 10)
    above = [row[:] for row in full]
    above[2][5] = 0.0                   # a task tested before its training
    assert not chip_smoke.p14_matrix_complete(above, 10)
    nan = [row[:] for row in full]
    nan[4][4] = float("nan")
    assert not chip_smoke.p14_matrix_complete(nan, 10)
    assert not chip_smoke.p14_matrix_complete(full[:9], 10)
