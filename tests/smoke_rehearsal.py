"""CPU stand-ins under which the tests rehearse chip_smoke.py's phases.

chip_smoke.py needs a CUDA device and nvcc, so the tests cannot run it
as it is. ``install()`` maps CUDA devices to the CPU (``CudaOnCpu``, a
``TorchFunctionMode`` that rewrites ``device="cuda"``), times CUDA
events on the host clock, skips the build, replaces each counted kernel
wrapper (K1, K1′, K2, K5, N1, the fused AdamW, the grouped expert GEMMs,
the head loss's H1 and H2) by its checks and plain version plus the
wrapper's launch counters, and
cuts every phase to tiny widths (t5-base's data shapes, d_model 32 as 2
heads of 16, 2 layers; a few calls per timing loop, since host-clock
times of the plain versions check nothing). It pins one intra-op thread
first: the rehearsals run beside other test workers.

``rehearse(code)`` runs ``code`` in a subprocess after ``install()``;
``run_phases(numbers)`` there runs those phases of ``chip_smoke.phases()``
through the harness and returns the summary entries, the launches they
counted by kernel and the kernels line's timed rows. A rank process the
script starts is this set-up again, in the script's rank mode
(``RANK_CMD``). This is not a test file.
"""

import json
import os
import subprocess
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PRELUDE = (f"import sys\nsys.path[:0] = [{TESTS!r}, {REPO!r}]\n"
           "import smoke_rehearsal as R\nR.install()\n")
# a rank of phases 12-14: the script in rank mode under the same set-up
RANK_CMD = [sys.executable, "-c", PRELUDE + (
    "import chip_smoke\nwith R.CudaOnCpu():\n    sys.exit(chip_smoke.main())")]
CARD = "rehearsal card, 0 W"


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


def _cuda_on_cpu():
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a: None
    torch.cuda._sleep = lambda cycles: None
    torch.cuda.Event = HostEvent
    torch.cuda.get_device_name = lambda i=0: "rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.set_sync_debug_mode = lambda mode: None
    generator = torch.Generator

    class CpuGenerator(generator):   # a type, as annotations in torch need
        def __new__(cls, device=None):
            return generator()

    torch.Generator = CpuGenerator
    import vqacl_tpu_torch.cl.regularizers as RG
    import vqacl_tpu_torch.cl.trainer  # noqa: F401 (its devices the card's)
    import vqacl_tpu_torch.cli.args  # noqa: F401 (--platform auto: the "card")
    import vqacl_tpu_torch.data.device_cache as DC
    import vqacl_tpu_torch.mm_bench as MB
    import vqacl_tpu_torch.models.vlt5 as V
    import vqacl_tpu_torch.serve as SV
    import vqacl_tpu_torch.train.step as ST
    from vqacl_tpu_torch.utils import device as D
    cpu = lambda d: torch.device("cpu")  # noqa: E731
    for mod in (D, V, SV, ST, MB, RG, DC):
        mod.resolve_device = cpu
    from vqacl_tpu_torch.ops import _build
    _build.build = lambda names=(), csrc=None: []


def _counted_wrappers():
    """Each counted wrapper replaced by its checks and plain version,
    counting as the wrapper on the card does."""
    from vqacl_tpu_torch.ops import adamw as AW
    from vqacl_tpu_torch.ops import dw
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.ops import moe as MO
    from vqacl_tpu_torch.ops import nms as NM
    from vqacl_tpu_torch.train import step as ST
    from vqacl_tpu_torch.utils.profiling import count

    dispatch = fa.fused_attention
    fwd_train, bwd = fa.fused_attention_fwd_train, fa.fused_attention_bwd

    def rows(what, route, q, k, v, more=()):
        # the wrappers' layout checks: rows of one stride each, 16-byte rows
        # on the bf16 route → whether the call is strided
        lds = fa._qkv_strides(q, k, v)
        if route == "mma":
            fa._check_rows16(what, list(zip("qkv", (q, k, v), lds))
                             + list(more))
        return lds != (q.shape[-1],) * 3

    def route(f, q, k, v, H):   # the wrappers' validation, before a launch
        r = fa.fwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1])
        f.route_launches[r] += 1
        return rows("fused_attention", r, q, k, v)

    def counted(q, k, v, bias, mask, H, dropout_rate=0.0, seed=None, bh0=0,
                Hc=None, h0=0):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            fa.bwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1],
                         dropout_rate)
            return dispatch(q, k, v, bias, mask, H, dropout_rate, seed, bh0,
                            Hc, h0)
        counted.strided_launches += route(counted, q, k, v, H)
        counted.launches += 1
        return fa.fused_attention_reference(q, k, v, bias, mask, H)

    def counted_fwd_train(*a, **kw):
        counted_fwd_train.strided_launches += route(
            counted_fwd_train, a[0], a[1], a[2], a[6])
        counted_fwd_train.launches += 1
        bh0 = a[8] if len(a) > 8 else kw.get("bh0", 0)
        h0 = a[10] if len(a) > 10 else kw.get("h0", 0)
        counted_fwd_train.offset_launches += bh0 != 0
        counted_fwd_train.head_offset_launches += h0 != 0
        return fwd_train(*a, **kw)       # the plain version on CPU tensors

    def counted_bwd(*a, **kw):
        q, k, v, do, H = a[0], a[1], a[2], a[5], a[6]
        r = fa.bwd_route(q.dtype, q.shape[-1] // H, q.shape[1], k.shape[1],
                         a[8])
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

    def counted_dw(x, g):
        dw._validate(x, g)               # the wrapper's checks and its route
        r = dw.dw_route(x.shape[0], x.shape[1], g.shape[1], x.dtype, x, g)
        counted_dw.launches += 1
        counted_dw.route_launches[r] += 1
        return dw.dw_splitk_reference(x, g)

    counted_dw.launches = 0
    counted_dw.route_launches = dict.fromkeys(dw.ROUTES, 0)
    dw.dw_splitk = counted_dw

    def counted_nms(b, v, t):
        NM._validate(b, v, t)            # the wrapper's checks, before a launch
        counted_nms.launches += 1
        return NM.greedy_nms_reference(b, v, t)

    counted_nms.launches = 0
    NM.greedy_nms = counted_nms

    # the fused optimizer: the wrapper's checks and plan, then the plain
    # version; every update takes that route, as every update on the card
    # takes the kernels
    def counted_adamw(tcfg, grads, opt_state, params, step, sched,
                      g_norm=None, out=None):
        leaves = AW._inputs(tcfg, grads, opt_state, params, step, sched,
                            g_norm)
        AW.adamw_plan(tuple(p.numel() for p in leaves[1]),
                      AW.leaf_flags(params, tcfg.freeze))
        count("optim.fused_leaves", len(leaves[1]))
        counted_adamw.launches += 1 + (g_norm is None)
        return AW.adamw_reference(tcfg, grads, opt_state, params, step,
                                  sched, g_norm, out)

    counted_adamw.launches = 0
    AW.fused_adamw = ST.adamw_step = AW.adamw_step = counted_adamw

    # the grouped expert GEMMs: the wrapper's checks, then the plain
    # version, counting the kernels' launches (2 a forward, 4 a backward,
    # as on the card)
    class Backward4(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            counted_moe.launches += 4
            return g

    def counted_moe(x, plan, wg, wu, wd):
        MO.check_shapes(x, wg, wd)
        counted_moe.launches += 2
        out = MO.grouped_swiglu_reference(x, plan, wg, wu, wd)
        return Backward4.apply(out) if out.requires_grad else out

    counted_moe.launches = 0
    MO.grouped_swiglu = counted_moe

    # the head loss's H1 and H2: bf16 takes their route, as it does on the
    # card at the widths the rehearsal's tiny ones stand for (d_model 32 is
    # below their 64-wide steps); the wrappers' checks and plan, then the
    # plain versions, counting as on the card (2 launches for H1, 1 for H2)
    from vqacl_tpu_torch.ops import head_loss as HL

    HL.head_loss_route = lambda device, dtype, *a: (
        "wgmma" if dtype == torch.bfloat16 else "plain")

    def counted_head(fn, reference):
        def counted(hs, wb, labels, *rowwise):
            HL._validate(hs, wb, labels, *rowwise)
            HL.head_plan(hs.shape[0], hs.shape[1], wb.shape[0])
            counted.launches += fn.per_call
            counted.route_launches["wgmma"] += fn.per_call
            return reference(hs, wb, labels, *rowwise)

        counted.__name__, counted.per_call = fn.__name__, fn.per_call
        counted.launches = 0
        counted.route_launches = dict.fromkeys(HL.ROUTES, 0)
        return counted

    HL.head_lse = counted_head(HL.head_lse, HL.lse_reference)
    HL.head_dlogits = counted_head(HL.head_dlogits, HL.dlogits_reference)


def _tiny_models():
    """Phase 11's detector and 3D ResNeXt at reduced depth (C4 1024 and
    res5 2048, the 3D ResNeXt's last stage 2048 wide), a 64-px resize and
    40 proposals; every ``Config()`` a tiny model of t5-base's data
    shapes; the small soak at a few items."""
    from vqacl_tpu_torch.utils import config as C
    from vqacl_tpu_torch.vision import frcnn as FR
    from vqacl_tpu_torch.vision import resnet as RN
    from vqacl_tpu_torch.vision import resnext3d as RX
    import vqacl_tpu_torch.cli.args as A

    RN.R101_STAGES = [("res2", 1, 32, 8, 1), ("res3", 1, 64, 8, 2),
                      ("res4", 1, 1024, 16, 2)]
    RN.RES5 = ("res5", 1, 2048, 16, 2)
    RX.R3D101_STAGES = [(1, 32, 1), (1, 1024, 2)]
    resize = FR.resize_shortest_edge
    FR.resize_shortest_edge = lambda img, short=64, max_size=128: resize(
        img, short, max_size)
    FR.PAD_BUCKETS = (64, 96, 128)
    er, erb = FR.extract_regions, FR.extract_regions_batch
    FR.extract_regions = lambda *a, n_proposals=40, **k: er(
        *a, n_proposals=n_proposals, **k)
    FR.extract_regions_batch = lambda *a, n_proposals=40, **k: erb(
        *a, n_proposals=n_proposals, **k)
    config = C.Config

    def tiny():
        c = config()
        c.model = C.tiny_model_config(
            vocab_size=32200, feat_dim=2048, n_boxes=36, max_text_length=20,
            gen_max_length=8, num_heads=2, d_kv=16)
        c.train.lr = 1e-2
        return c

    C.Config = A.Config = tiny
    from vqacl_tpu_torch import soak as SK    # its Config the tiny one
    SK.SCALES["small"] = dict(epochs=1, m_size=8, n_train=8, n_images=None)
    SK.N_VAL = SK.N_TEST = 4


# the phases' sizes and bounds here, by name, in every smoke module that
# has the name (the phases import the shared ones from smoke.harness)
TINY = dict(
    EVAL_BATCH=4, TRAIN_BATCH=8, TRAIN_STEPS=4,
    DW_PROBE=(64, 16, 24), DW_LADDER=((16, 64, 128), (24, 16, 40)),
    HEAD_SHAPES=(("head_vlt5", 4, 5, 64, 600, True),
                 ("head_moonlight", 4, 5, 128, 520, False)),
    MM_BENCH_SHAPES=dict(B=2, S=6, D=16, F=24, H=2, dk=8), MM_BENCH_REPS=2,
    CL_ITEMS=(24, 8, 8), CL_REG_TRAIN=16, CL_IMAGES=16, CL_M_SIZE=10,
    CL_TINY=(24, 8, 8), CL_TINY_BATCH=8,
    CACHE_IMAGES=300, PACK_IMAGES=24,
    MERGED_ROUNDS=2, CLS_ANSWERS=16, CLS_LR=1e-2,
    P10_ITEMS=(12, 4, 4), P10_IMAGES=16, NQ_ITEMS=(24, 8, 8), NQ_VIDEOS=16,
    P10_TINY=(16, 8, 8), P10_TINY_BATCH=8,
    NMS_RPN=(600, (0.7,), 60),
    P11_F32_IMAGE=((64, 96), (56, 90)), P11_VIDEO_FRAMES=20,
    P11_VIDEO_SIDE=32, P11_MOTION_SIDE=16,
    # phase 12: the one-rank group over gloo (NCCL needs a card)
    P12_ONE_RANK_BACKEND="gloo", P12_STEPS=2, P12_TINY=(16, 8, 8),
    RANK_CMD=RANK_CMD,
    # phase 13: a smaller tiny run. The tiny bf16 model here (d_model 32,
    # lr 1e-2) turns the tp partial sums' bf16 roundings into up to ~0.14
    # of an update through Adam (2.4-2.6e-2 at t5-base on the card): the
    # bound of this control-flow rehearsal is 0.25
    P13_TINY=(8, 8, 8), P13_PARAM_RTOL=0.25,
    # phase 14 at a few items per task: the surrogate's rows (their
    # orderings need its real size, so the margins here only exercise the
    # checks: test_phase14_orderings holds the real ones), the cut row
    P14_ARGV=("--tasks", "2", "--n_train", "16", "--n_eval", "8",
              "--epochs", "1", "--m_size", "8"),
    P14_ORDERINGS=(("ours", "vanilla", "Avg_acc", -200.0),
                   ("vanilla", "ours", "Avg_forget", -200.0),
                   ("er", "vanilla", "Avg_acc", -200.0)),
    P14_CUT_ARGV=("--tasks", "2", "--n_train", "24", "--n_eval", "8",
                  "--epochs", "1"),
    # phase 16 at tiny widths (multiples of the kernels' 128-wide tiles)
    MOE_T=96, MOE_D=128, MOE_F=128,
    P16_MODEL=dict(d_model=128, num_heads=2, vocab_size=32200,
                   intermediate_size=256, moe_intermediate_size=128,
                   kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16, feat_dim=64),
    P16_ITEMS=(8, 4, 4), P16_BATCH=(4, 4))
SMOKE = ("harness", "kernels", "steps", "cl", "serving", "extensions",
         "clis", "extraction", "dp", "tppp", "protocol", "optimizer", "moe",
         "graphs")


def install():
    """Everything above, in this process: one intra-op thread, CUDA on
    the CPU, the counted wrappers' stand-ins, the tiny sizes."""
    torch.set_num_threads(1)
    _cuda_on_cpu()
    _counted_wrappers()
    _tiny_models()
    import importlib
    mods = [importlib.import_module(f"smoke.{m}") for m in SMOKE]
    h = mods[0]
    time_ms = h.time_ms
    # phase 7's checkpoint for phase 9, of this process alone: the phases'
    # rehearsals may run side by side
    p7 = os.path.join(h.HERE, "build", "chip_smoke", f"phase7_{os.getpid()}")
    stand_ins = dict(
        TINY, P7_DIR=p7, P7_CKPT=os.path.join(p7, "er_LAST.npz"),
        card_line=lambda: CARD, dw_sms=lambda: 132,
        # the CPU build of torch has no kernel for mm with out_dtype
        mm_f32_out=lambda a, b: a.float() @ b.float(),
        # host-clock times of the plain versions check nothing: a few calls
        time_ms=lambda fns, iters=50, warmup=5, spin=True: time_ms(
            fns, min(iters, 3), min(warmup, 1), spin))
    for name, value in stand_ins.items():
        for mod in mods:
            if hasattr(mod, name):
                setattr(mod, name, value)


def serial_dcp_writer(ctx=None):
    """DCP's file writer stages through CUDA streams when it sees a card
    (the rehearsal claims one): its serial loader (phase 9's directory
    checkpoint; imported here alone, as it takes a second and a half)."""
    import torch.distributed.checkpoint.filesystem as FS

    FS._OverlappingCpuLoader = lambda fn, **kw: FS._SerialCpuLoader(fn)


def rehearse(code, timeout):
    """``code`` in a subprocess of the repository after ``install()``, one
    thread for every thread pool (the subprocess's ranks too) → the
    finished process (its output captured)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", PRELUDE + code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def run_phases(numbers, init=True, **attrs):
    """Phases ``numbers`` of ``chip_smoke.phases()`` through the harness
    (after phase 3's model when ``init``; ``attrs`` set on the context
    first) → {"summary": the summary entries, "launches": the counted
    launches by kernel name and attribute, "rows": the kernels line's
    timed rows by kernel name, "head_off": phase 2's head-offset check
    when it ran}."""
    import chip_smoke
    from smoke import harness as h
    from smoke import steps
    from vqacl_tpu_torch.ops import launches

    ctx = h.Context(CARD)
    with CudaOnCpu():
        if init:
            steps.init_slice(ctx)
        for k, v in attrs.items():
            setattr(ctx, k, v(ctx) if callable(v) else v)
        h.run([p for p in chip_smoke.phases() if p[0] in numbers], ctx)
    counted = {name: {a: ctx.tally.of(launches.wrappers()[i], a)
                      for a in ("launches", "offset_launches",
                                "head_offset_launches")}
               for name, i, _, _ in h.KERNELS}
    return {"summary": ctx.summary, "launches": counted, "rows": ctx.rows,
            "head_off": getattr(ctx, "head_off", None)}


def phases_json(numbers, timeout, init=True, attrs="", after=""):
    """``run_phases`` in a subprocess (``attrs``: its keyword arguments as
    code; ``after``: code run next, which may add to ``out``) → (the
    finished process, its JSON result, its output lines)."""
    r = rehearse(f"import json\nout = R.run_phases({numbers!r}, {init!r}"
                 f"{attrs})\n{after}\nprint(json.dumps(out))", timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    return r, json.loads(lines[-1]), lines


def p7_checkpoint(ctx):
    """Phase 7's ER checkpoint for phase 9, from phase 3's model."""
    from smoke.harness import P7_CKPT, P7_DIR
    from vqacl_tpu_torch.train.checkpoint import save_checkpoint

    os.makedirs(P7_DIR, exist_ok=True)
    save_checkpoint(P7_CKPT, ctx.params, ctx.proto)
    return P7_CKPT


def graph_fake(ctx):
    """The train step's CUDA graphs through ``torch_graph_fake``."""
    import torch_graph_fake

    torch_graph_fake.install()
