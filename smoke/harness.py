"""What the phases of ``chip_smoke.py`` share: output and failure, the
card's line, CUDA-event timing, bounds, the rank processes, the launch
accounting and the phase loop with its kernels line.

Launch accounting. Each kernel wrapper counts its launches on the host
(``vqacl_tpu_torch/ops/launches.py``). A phase reads what a run launched
as the difference of two snapshots (``since``: a ``Launches``), checks
it against the run's steps and batches, and counts the runs of the main
paths into the ``Context`` (``Context.count``, ``Context.counted``;
``Context.reported`` for the counts a rank process returns). Kernel
checks, warm-ups and reference runs are read, if at all, and not
counted. The kernels line sums the counted launches over the phases.
"""

import json
import os
import subprocess
import sys
import time

import torch

from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import _build, adamw, launches
from vqacl_tpu_torch.train.optim import make_transform
from vqacl_tpu_torch.utils.config import Config

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# cycles per second a spin kernel is sized with: above the H100's boost
# clock (1.98 GHz), so a spin lasts at least as long as asked
SPIN_HZ = 2.0e9
EVAL_BATCH = 100
TRAIN_BATCH = 80
DROPOUT = 0.1
# parameter gradients through the kernels vs the unfused encoder, as
# ‖g_kernel − g_plain‖ / ‖g_plain‖ over all parameters: in bf16 the two
# backward passes round at different points (autograd of the plain path
# takes the bf16-rounded probabilities, K2 works in f32), in f32 only the
# summation order differs
GRAD_REL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
SMALL_PARAM_TOL = 3e-5
# set by --base: another checkout's kernel sources, timed beside these
BASE_CSRC = None
# phase 7, the continual-learning loop: two tasks of SyntheticDataModule
# data over a pool of CL_IMAGES images (t5-base: feat_dim 2048, 36 boxes),
# items per task (train, val, test); the tiny f32 run card vs CPU on
# CL_TINY; phases 8, 12 and 13 run the same loop
CL_TASKS = ("q_recognition", "q_location")
CL_ITEMS = (400, 100, 100)
CL_IMAGES = 256
CL_M_SIZE = 200
CL_TINY = (48, 16, 16)
CL_TINY_BATCH = 16
# per-step losses of the tiny f32 CL run, card vs CPU, relative
CL_LOSS_RTOL = 1e-5
# beams of phases 8 and 9
BEAM = 5
# phase 7's ER checkpoint, kept under the gitignored build/ for phase 9
P7_DIR = os.path.join(HERE, "build", "chip_smoke", "phase7")
P7_CKPT = os.path.join(P7_DIR, "er_LAST.npz")
# the rank processes of phases 12-14: how long they may take, and the
# command that starts one (None: chip_smoke.py in rank mode)
P12_TIMEOUT = 900
RANK_CMD = None


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fns, iters=50, warmup=5, spin=True) -> float:
    """Mean CUDA-event time of one call, cycling through ``fns`` (one per
    input set, so each call finds its inputs out of L2 as the encoder's
    layer-to-layer traffic would). With ``spin`` the timed calls are
    queued behind a spin kernel that outlasts their enqueue on the host,
    so the events time the card's work back to back (the device time);
    without it, calls issued back to back from the host, whichever of
    host and card is slower (the time a caller sees per call)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(min(2.0 * host_s, 1.0) * SPIN_HZ))
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ab(fns, spin=True):
    """``time_ms(fns)`` → (ms, base_ms). With ``--base`` the same calls
    also run on the base checkout's libraries (the wrappers load them by
    name at each call), in the order base, this, this, base; each side's
    time is the mean of its two. Without it base_ms is None."""
    if BASE_CSRC is None:
        return time_ms(fns, spin=spin), None
    load = _build.load

    def on_base():
        _build.load = lambda name: load(name, BASE_CSRC)
        try:
            return time_ms(fns, spin=spin)
        finally:
            _build.load = load

    b1 = on_base()
    t1, t2 = time_ms(fns, spin=spin), time_ms(fns, spin=spin)
    b2 = on_base()
    log(f"  ab {'device' if spin else 'call'}: base {b1:.5f} this {t1:.5f} "
        f"this {t2:.5f} base {b2:.5f} ms")
    return (t1 + t2) / 2, (b1 + b2) / 2


def put_ab(row, key, times):
    """row[key] = this checkout's time; row["base_" + key] = the base's."""
    row[key], base = times
    if base is not None:
        row["base_" + key] = base


def _bound(nbytes, ops_s):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations' seconds at their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _grads(vlt5, tree_leaves, tree_map, params, mcfg, batch, proto, dtype,
           generator=None, remat=False, peak=None):
    """(loss, flat f32 gradient) of the training forward (deterministic
    without a ``generator``). With a ``peak`` dict, its "bytes" get the
    device memory peak of the forward and backward above their start
    (the gradients included, their flat copy not)."""
    if peak is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = vlt5.forward_train(live, mcfg, batch, proto, 0.5, 0.3,
                             generator=generator, dtype=dtype, remat=remat)
    leaves = tree_leaves(live)
    gs = torch.autograd.grad(out.loss, leaves, allow_unused=True)
    if peak is not None:
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated() - start
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).float()
                      .reshape(-1) for p, g in zip(leaves, gs)])
    return float(out.loss.detach()), flat


def train_setup(device="cuda"):
    """A seeded random-init t5-base state's makings: (config, parameters,
    prototype banks, optimizer transform, one synthetic train batch)."""
    cfg = Config()
    m = cfg.model
    return (cfg, vlt5.init_vlt5_params(0, m, device=device),
            ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device=device), make_transform(cfg.train),
            next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
                TRAIN_BATCH, seed=0))["tensors"])


def _events_ms(fn, n):
    """``fn()`` n times between CUDA events, one sync at the end →
    (last output, [ms])."""
    spans = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in spans]


def _launches_per_step(fn, marker):
    """Device kernels (and copies) of one ``fn()`` under torch.profiler,
    and how often the CPU op ``marker`` ran (once per decode step). A
    PyTorch built without CUDA traces the host only."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.backends.cuda.is_built():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    steps = n = 0
    for avg in prof.key_averages():
        if avg.key == marker:
            steps += avg.count
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            n += avg.count
    return n, steps


# ---- launch accounting ----------------------------------------------------

def attention() -> tuple:
    """The wrappers of K1, K1′ and K2."""
    return launches.wrappers()[:3]


class Launches(dict):
    """Launch counts over a window: (wrapper, attribute, route or None) →
    count, a difference of two ``launches.read()`` snapshots."""

    def of(self, fn, attr="launches", route=None) -> int:
        return self.get((fn, attr, route), 0)

    def attention(self, attr="launches") -> tuple:
        """(K1, K1′, K2)'s counts of ``attr``."""
        return tuple(self.of(fn, attr) for fn in attention())

    @property
    def k(self) -> tuple:
        """(K1, K1′, K2) launches."""
        return self.attention()

    @property
    def strided(self) -> tuple:
        """(K1, K1′, K2) launches on strided q/k/v (merged projections)."""
        return self.attention("strided_launches")

    @property
    def offsets(self) -> list:
        """[K1′, K2] launches at a Philox row offset (a data-parallel rank
        past the first, a pipeline's microbatches past the first)."""
        return list(self.attention("offset_launches")[1:])

    @property
    def heads(self) -> list:
        """[K1′, K2] launches over a tensor-parallel rank's heads past the
        first."""
        return list(self.attention("head_offset_launches")[1:])

    def routes(self, fn) -> dict:
        """``fn``'s launches by route, every route of the wrapper."""
        return {r: self.of(fn, "route_launches", r)
                for r in fn.route_launches}

    def add(self, other, fns) -> None:
        """``other``'s counts of the wrappers ``fns`` added."""
        for key, n in other.items():
            if key[0] in fns:
                self[key] = self.get(key, 0) + n


def since(before) -> Launches:
    """The launches since the snapshot ``before`` (``launches.read()``)."""
    return Launches(launches.since(before))


class Context:
    """What the phases share: the card's line, phase 3's model
    (``params``, ``proto``) and tokenizer (``tok``), what later phases
    read of earlier ones (``eval_step_ms``, ``dec_times``, ``head_off``),
    the timed rows of the kernels line (``rows``, by kernel name), the
    launches the phases counted (``tally``), and the summary line's
    entries (``summary``)."""

    def __init__(self, card=None):
        self.card = card
        self.rows, self.summary = {}, {}
        self.tally, self.mark = Launches(), Launches()

    def count(self, w: Launches, fns=None) -> None:
        """Count the window ``w``'s launches of ``fns`` (K1, K1′ and K2 by
        default) into the kernels line."""
        self.tally.add(w, attention() if fns is None else fns)

    def counted(self, fn):
        """``fn()`` between synchronisations, its K1/K1′/K2 launches
        counted → (its output, its launches)."""
        torch.cuda.synchronize()
        before = launches.read()
        res = fn()
        torch.cuda.synchronize()
        w = since(before)
        self.count(w)
        return res, w

    def reported(self, attr, counts) -> None:
        """Count launches a rank process reported: ``counts`` of ``attr``
        for (K1, K1′, K2), or for (K1′, K2) when two."""
        fns = attention()[-len(counts):]
        self.count(Launches({(fn, attr, None): n
                             for fn, n in zip(fns, counts)}), fns)

    def launched(self) -> Launches:
        """What the current phase has counted so far."""
        return Launches({k: n - self.mark.get(k, 0)
                         for k, n in self.tally.items()})


def check_adamw(label, w, updates, per_update, ctx=None):
    """The fused optimizer's launches in the window ``w``: ``per_update``
    (2: the norm and apply passes; 1 where an FSDP or tp layout gives
    ‖g‖) for each of ``updates`` optimizer updates, else the run fails →
    the count, which ``ctx`` counts into the kernels line's
    ``fused_adamw`` row (this process's checked launches)."""
    got = w.of(adamw.fused_adamw)
    if got != per_update * updates:
        fail(f"{label}: {got} fused_adamw launches, expected {per_update} "
             f"per optimizer update x {updates}")
    if ctx is not None:
        ctx.count(w, (adamw.fused_adamw,))
    return got


# ---- rank processes --------------------------------------------------------

def run_ranks(work, tag, n, spec, echo=(), meanwhile=None):
    """Start ``n`` ranks of chip_smoke.py in rank mode (``RANK_CMD``) over
    one file store under ``work``, each with ``spec``; run
    ``meanwhile()`` in this process, if given (the ranks are killed if it
    fails); wait for them within ``P12_TIMEOUT`` (killing any still
    running), echo their log lines that start with ``echo`` (every log's
    tail when one failed) → (the ranks' records in rank order, seconds),
    and what ``meanwhile`` returned as a third item when given."""
    spec_path = os.path.join(work, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = RANK_CMD or [sys.executable, os.path.join(HERE, "chip_smoke.py")]
    procs, logs = [], []
    t0 = time.time()
    for r in range(n):
        logs.append(open(os.path.join(work, f"{tag}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            cmd + ["--rank", str(r), "--world", str(n), "--store",
                   os.path.join(work, f"{tag}_store"), "--spec", spec_path,
                   "--out", os.path.join(work, f"{tag}_rank{r}.json")],
            cwd=HERE, stdout=logs[-1], stderr=subprocess.STDOUT))
    if meanwhile is not None:
        try:
            extra = meanwhile()
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
    deadline = time.time() + P12_TIMEOUT
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    secs = time.time() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r, f in enumerate(logs):
        f.seek(0)
        text = f.read()
        f.close()
        if bad or hung:
            log(f"--- {tag} rank {r} (exit {procs[r].returncode}) ---\n"
                + text[-4000:])
        else:
            for line in text.splitlines():
                if line.startswith(tuple(echo)):
                    log(f"rank {r}: {line}")
    if hung:
        fail(f"{tag}: ranks {hung} still running after {P12_TIMEOUT} s")
    if bad:
        fail(f"{tag}: ranks {bad} failed")
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"{tag}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return (ranks, secs) if meanwhile is None else (ranks, secs, extra)


# ---- the phase loop and the kernels line -----------------------------------

def run(phases, ctx) -> None:
    """Each ``(number, phase)`` of ``phases`` in order. ``phase(ctx)``
    returns its entries of the summary line; from phase 8 on its record
    (the first entry) also gets the phase's seconds, ``phase_s``."""
    for n, phase in phases:
        ctx.mark = Launches(ctx.tally)
        t0 = time.time()
        out = phase(ctx) or {}
        if n >= 8:
            next(iter(out.values()))["phase_s"] = secs = time.time() - t0
            log(f"phase {n} in {secs:.1f} s")
        ctx.summary.update(out)


FWD_SRC = "vqacl_tpu_torch/csrc/fused_attention_fwd.cu"
# the kernels line: (name, index in launches.wrappers(), source, the code
# of vqacl_tpu it replaces). Launches: what the phases counted of the main
# paths' runs, the ranks' included: K1 in eval, loss-eval, predict,
# served and DER capture batches; K1′/K2 in train, replay and importance
# steps, at a row offset (``offset_launches``: phase 12's second rank,
# phase 13's microbatches past the first) or over a tp rank's heads
# (``head_offset_launches``: phase 13); K5 in the head loss's backward
# (phase 17's train steps, 2 a step) and the probe (phase 6); N1 in
# phase 11's extraction runs; the fused optimizer's pair as each run
# checked it per update (the ranks check their own); the grouped expert
# GEMMs in phase 16's main-path runs; H1 and H2 in phase 17's train steps.
# K5's timed row is its two head-loss products at VL-Moonlight's shape
KERNELS = (
    ("fused_attention_fwd", 0, FWD_SRC,
     "vqacl_tpu/ops/fused_attention.py:159"),
    ("fused_attention_fwd_train", 1, FWD_SRC,
     "vqacl_tpu/ops/fused_attention.py:199"),
    ("fused_attention_bwd", 2, "vqacl_tpu_torch/csrc/fused_attention_bwd.cu",
     "vqacl_tpu/ops/fused_attention.py:272"),
    # on the main path the head loss's d(logits) products, which XLA runs
    # as einsums in JAX's jitted step; in the probe the Pallas dw kernel
    ("dw_splitk", 4, "vqacl_tpu_torch/csrc/dw_splitk.cu",
     "vqacl_tpu/models/vlt5.py:313-350, scripts/mm_bench.py:121"),
    # not a Pallas kernel: the two greedy suppressions JAX runs as a
    # lax.scan; its time is the RPN shape's
    ("greedy_nms", 6, "vqacl_tpu_torch/csrc/nms.cu",
     "vqacl_tpu/vision/rpn.py:154, vqacl_tpu/ops/nms.py:83"),
    # not a Pallas kernel: the optimizer XLA fuses into JAX's jitted step
    ("fused_adamw", 3, "vqacl_tpu_torch/csrc/fused_adamw.cu",
     "vqacl_tpu/train/optim.py:191"),
    # not a Pallas kernel: vqacl_tpu has no mixture of experts
    ("moe_grouped_gemm", 5, "vqacl_tpu_torch/csrc/moe_grouped_gemm.cu",
     "none (no mixture of experts in vqacl_tpu)"),
    # not Pallas kernels: the head loss's products and log-sum-exp that
    # XLA fuses in JAX's jitted step
    ("head_lse", 7, "vqacl_tpu_torch/csrc/head_loss.cu",
     "vqacl_tpu/models/vlt5.py:313-350"),
    ("head_dlogits", 8, "vqacl_tpu_torch/csrc/head_loss.cu",
     "vqacl_tpu/models/vlt5.py:313-350"))


def kernels_line(ctx) -> list:
    """One row per kernel: its counted launches and its timed row."""
    out = []
    for name, i, source, replaces in KERNELS:
        fn, r = launches.wrappers()[i], ctx.rows[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": ctx.tally.of(fn),
               **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
        if i in (1, 2):
            for attr in ("offset_launches", "head_offset_launches"):
                row[attr] = ctx.tally.of(fn, attr)
        out.append(row)
    return out
