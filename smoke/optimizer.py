"""Phase 15 of ``chip_smoke.py``: the fused optimizer."""

import dataclasses
import time

import torch

from smoke.harness import (_bound, _launches_per_step, check_adamw, fail, log,
                           since, time_ms)
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.ops import adamw, launches
from vqacl_tpu_torch.profile_train import _by_span
from vqacl_tpu_torch.train import optim, step as ST
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.utils import profiling
from vqacl_tpu_torch.utils.config import Config

# phase 15, the fused optimizer: steps per combination, the Adam counts
# held bit for bit (β^t = powf(β, t) at t = count + 1, and the saturation
# at INT32_MAX), the elements of their leaf, timed calls of the kernel
# pair, and the kernel's ‖g‖ against global_norm's (f64 against f32 sums)
P15_STEPS = 5
P15_COUNTS = tuple(range(64)) + (99, 999, 12345, 2 ** 24 - 1, 2 ** 24,
                                 2 ** 31 - 2, 2 ** 31 - 1)
P15_LEAF = 4099
P15_TIMED = 20
P15_NORM_RTOL = 2e-6
def _launches_in_span(fn, pad, name):
    """Kernels that ``fn()`` launches inside the recorder's span ``name``
    (``utils/profiling.py``), attributed by ``profiling.attribute`` over
    one torch.profiler session of ``pad(); fn(); pad()``: a session late
    in a long process can miss kernels at its ends, and those fall in
    the padding. A PyTorch built without CUDA records no kernels: 0."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.backends.cuda.is_built():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    profiling.take()
    profiling.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            pad()
            fn()
            pad()
            torch.cuda.synchronize()
    finally:
        profiling.enable(False)
    return _by_span(prof, profiling.take())["launches"].get(name, 0)


def _bits(x):
    """A tensor's bits as integers (float → int of its width)."""
    if x.is_floating_point():
        return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])
    return x


def _mismatch(a, b, tree_leaves):
    """Elements whose bits differ between two trees (or tensors), one
    read at the end."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or any(x.dtype != y.dtype or x.shape != y.shape
                                 for x, y in zip(la, lb)):
        return -1
    return int(sum((_bits(x) != _bits(y)).sum() for x, y in zip(la, lb)))


def fused_optimizer(ctx):
    """The fused optimizer on the seeded t5-base tree. (a) ``P15_STEPS`` steps
    of ``ops/adamw.py::fused_adamw`` beside the eager chain
    (``adamw_reference``) given the eager ``global_norm``, in every
    combination of ``adam_impl``, moment dtype, ``freeze`` and a clip that
    triggers or not (the linear schedule where it triggers): parameters,
    moments, count and lr equal bit for bit; the Adam counts ``P15_COUNTS``
    (β^t through powf, the saturation at INT32_MAX) on a small leaf, equal
    bit for bit too; gradients given as column slices of wider matrices
    (aligned, as a merged q/k/v projection's, or not) read in place: bit for
    bit, by the pair's 2 kernels alone. (b) The kernel's own norm within
    ``P15_NORM_RTOL`` of ``global_norm``, the same bits over three launches.
    (c) ``train/step.py::_apply_update`` under
    ``torch.cuda.set_sync_debug_mode("error")``: no synchronisation (the
    eager chain's result in that mode is recorded); one call launches the
    pair (its counter: 2), torch.profiler sees 2 to 4 kernels in its span
    ``step.optimizer`` and some in the eager chain; the recorder's
    ``optim.fused_leaves`` counts every leaf. Every train, replay and remat
    step of phases 4, 7, 9, 10, 12, 13, 14 and 16 launches the pair once
    (``check_adamw``: 2 kernels, 1 where an FSDP or tp layout gives ‖g‖),
    and the kernels line's row sums those launches. (d) CUDA-event time of
    the kernel pair against its bytes bound, the host time per call, the
    eager chain's and ``torch.optim.AdamW(fused=True)``'s (f32 moments, a
    yardstick only).

    Runs on phase 3's t5-base; no attention kernel may launch here. The
    record is the kernels line's ``fused_adamw`` row."""
    params = ctx.params
    start = launches.read()
    leaves = optim.tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    base = Config().train
    gen = torch.Generator(device="cuda").manual_seed(15)

    def grads(scale, tree=params):
        return optim.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device="cuda") * scale, tree)

    sched = torch.tensor([2.0, 10.0], device="cuda")
    # gradients of ‖g‖ ≈ 3x or 0.3x the clip's limit
    on, off = (k * base.clip_grad_norm / n_params ** 0.5 for k in (3, 0.3))
    rec = {"n_params": n_params, "n_leaves": len(leaves), "combos": {}}
    # (a) the apply pass given the eager norm, every combination
    for impl in ("hf", "torch"):
        for dt in ("bfloat16", "float32"):
            for freeze in (False, True):
                for clip in (True, False):
                    tcfg = dataclasses.replace(
                        base, adam_impl=impl, adam_dtype=dt, freeze=freeze,
                        schedule="linear_warmup" if clip
                        else "constant_warmup")
                    st_e = st_f = optim.make_transform(tcfg).init(params)
                    p_e = p_f = params
                    step = torch.zeros((), dtype=torch.int32,
                                       device="cuda")
                    bad, norms = 0, []
                    for _ in range(P15_STEPS):
                        g = grads(on if clip else off)
                        gn = optim.global_norm(g)
                        norms.append(gn)
                        p_e, st_e, lr_e, _ = adamw.adamw_reference(
                            tcfg, g, st_e, p_e, step, sched, gn)
                        p_f, st_f, lr_f, _ = adamw.fused_adamw(
                            tcfg, g, st_f, p_f, step, sched, gn)
                        step = step + 1
                        bad += sum(_mismatch(a, b, optim.tree_leaves)
                                   for a, b in ((p_e, p_f),
                                                (st_e.mu, st_f.mu),
                                                (st_e.nu, st_f.nu),
                                                (st_e.count, st_f.count),
                                                (lr_e, lr_f)))
                    name = (f"{impl}/{dt}/freeze={int(freeze)}/"
                            f"clip={'on' if clip else 'off'}")
                    gns = [float(x) for x in norms]
                    triggered = [x >= tcfg.clip_grad_norm for x in gns]
                    rec["combos"][name] = {"mismatched": bad,
                                           "grad_norms": gns}
                    log(f"fused_adamw {name}: {P15_STEPS} steps, "
                        f"‖g‖ {min(gns):.4g}-{max(gns):.4g}, elements "
                        f"differing from the eager chain: {bad}")
                    if bad or not all(t == clip for t in triggered):
                        fail(f"fused_adamw {name}: {bad} elements differ "
                             f"from the eager chain (clip triggered "
                             f"{triggered}, wanted {clip})")
                    del st_e, st_f, p_e, p_f
    # the Adam counts: β^t through powf at t = count + 1, and saturation
    leaf = {"w": torch.randn(P15_LEAF, generator=gen, device="cuda")}
    count_bad = {}
    for impl in ("hf", "torch"):
        tcfg = dataclasses.replace(base, adam_impl=impl)
        for c in P15_COUNTS:
            st = optim.AdamState(
                torch.tensor(c, dtype=torch.int32, device="cuda"),
                grads(1e-2, leaf), optim.tree_map(torch.abs,
                                                  grads(1e-4, leaf)))
            st = st._replace(mu=optim.tree_map(
                lambda x: x.to(torch.bfloat16), st.mu), nu=optim.tree_map(
                lambda x: x.to(torch.bfloat16), st.nu))
            g = grads(1e-2, leaf)
            step = torch.tensor(5, dtype=torch.int32, device="cuda")
            gn = optim.global_norm(g)
            e = adamw.adamw_reference(tcfg, g, st, leaf, step, sched, gn)
            f = adamw.fused_adamw(tcfg, g, st, leaf, step, sched, gn)
            bad = sum(_mismatch(a, b, optim.tree_leaves)
                      for a, b in ((e[0], f[0]), (e[1].mu, f[1].mu),
                                   (e[1].nu, f[1].nu),
                                   (e[1].count, f[1].count)))
            if bad:
                count_bad[f"{impl}/{c}"] = bad
    rec["powf_counts"] = len(P15_COUNTS)
    rec["powf_mismatched"] = count_bad
    log(f"fused_adamw Adam counts {P15_COUNTS[0]}..{P15_COUNTS[-1]} "
        f"({len(P15_COUNTS)} x 2 impls, leaf of {P15_LEAF}): powf "
        f"{'equals torch.pow' if not count_bad else 'differs'}; mismatches "
        f"{count_bad}")
    if count_bad:
        fail(f"fused_adamw: Adam counts {sorted(count_bad)} differ from "
             f"the eager chain")

    # strided gradients, read in place: each 2-D leaf's a column slice of
    # a wider matrix, 16-byte aligned (as the merged q/k/v projections'
    # are) or not (the scalar loop)
    def sliced(x, i):
        if x.dim() != 2:
            return x
        r, c = x.shape
        lo, width = (c, 3 * c) if i % 2 == 0 else (1, c + 3)
        wide = torch.zeros(r, width, device="cuda")
        wide[:, lo:lo + c] = x
        return wide[:, lo:lo + c]

    tcfg = base
    g = grads(on)
    gs = optim.tree_unflatten(g, [sliced(x, i) for i, x in
                                  enumerate(optim.tree_leaves(g))])
    n_strided = sum(not x.is_contiguous() for x in optim.tree_leaves(gs))
    st = optim.make_transform(tcfg).init(params)
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    gn = optim.global_norm(g)
    e = adamw.adamw_reference(tcfg, g, st, params, step, sched, gn)
    f = adamw.fused_adamw(tcfg, gs, st, params, step, sched, gn)
    bad = sum(_mismatch(a, b, optim.tree_leaves)
              for a, b in ((e[0], f[0]), (e[1].mu, f[1].mu),
                           (e[1].nu, f[1].nu), (e[2], f[2])))
    own = adamw.fused_adamw(tcfg, gs, st, params, step, sched)
    rel = abs(float(own[3]) - float(gn)) / float(gn)

    def strided_call():
        with profiling.span("p15.strided"):
            adamw.fused_adamw(tcfg, gs, st, params, step, sched)

    n_k = _launches_in_span(strided_call, lambda: adamw.adamw_reference(
        tcfg, g, st, params, step, sched), "p15.strided")
    rec["strided"] = {"leaves": n_strided, "mismatched": bad,
                      "norm_rel": rel, "kernels": n_k}
    log(f"fused_adamw strided grads: {n_strided} of {len(leaves)} leaves "
        f"column slices; elements differing from the eager chain {bad}; "
        f"norm rel {rel:.3e}; kernels {n_k} (torch.profiler)")
    if not n_strided or bad or not rel <= P15_NORM_RTOL or (
            torch.backends.cuda.is_built() and n_k != 2):
        fail("fused_adamw: strided gradients not read in place bit for "
             "bit by the kernel pair alone")
    del e, f, own, gs, st

    # (b) the kernel's own norm: against global_norm, and over 3 launches
    state = TrainState.create(params, optim.make_transform(tcfg),
                              ProtoState.create(2, 2, 8, device="cuda"),
                              seed=0, warmup_iters=2.0, t_total=10.0)
    g = grads(on)
    ref = float(optim.global_norm(g))
    outs = [adamw.fused_adamw(tcfg, g, state.opt_state, state.params,
                              state.step, state.sched) for _ in range(3)]
    gns = [o[3] for o in outs]
    norm_rel = abs(float(gns[0]) - ref) / ref
    same_bits = all(_mismatch(outs[0][i], o[i], optim.tree_leaves) == 0
                    for o in outs[1:] for i in (0, 3)) and all(
        _mismatch(outs[0][1].mu, o[1].mu, optim.tree_leaves) == 0
        for o in outs[1:])
    rec["norm"] = {"fused": float(gns[0]), "global_norm": ref,
                   "rel": norm_rel, "same_bits_3_launches": same_bits}
    log(f"fused_adamw norm: {float(gns[0])!r} vs global_norm {ref!r}, "
        f"rel {norm_rel:.3e} (tol {P15_NORM_RTOL}); 3 launches "
        f"bit-equal {same_bits}")
    if not norm_rel <= P15_NORM_RTOL or not same_bits:
        fail("fused_adamw: the kernel's norm is off global_norm or not "
             "the same bits on every launch")
    del outs, gns

    # (c) _apply_update under the sync check, and its launches
    place = ST._Placement(None)
    apply = lambda: ST._apply_update(tcfg, state, g, state.proto, None,
                                     place)
    apply()                        # the plan's table, copied once
    torch.cuda.synchronize()
    sync_err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        apply()
    except RuntimeError as e:
        sync_err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = lambda: adamw.adamw_reference(tcfg, g, state.opt_state,
                                          state.params, state.step,
                                          state.sched)
    eager_err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager()
    except RuntimeError as e:
        eager_err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # one call, the pair's counter around it; then the kernels torch.profiler
    # sees inside its span step.optimizer (the step counter's add follows
    # the span), the eager chain padding the session, and the chain alone
    before = launches.read()
    apply()
    pair_launches = check_adamw("_apply_update", since(before), 1, 2, ctx)
    apply_launches = _launches_in_span(apply, eager, "step.optimizer")
    eager_launches, _ = _launches_per_step(eager, "")
    # the recorder's counters name the route every leaf took
    profiling.take()
    profiling.enable()
    try:
        apply()
    finally:
        profiling.enable(False)
    counters_seen = profiling.take().counters
    rec["apply_update"] = {
        "sync_error": sync_err, "eager_chain_sync_error": eager_err,
        "kernels": apply_launches, "kernel_pair_launches": pair_launches,
        "eager_chain_kernels": eager_launches, "counters": counters_seen}
    log(f"fused_adamw _apply_update: sync error {sync_err!r} (the eager "
        f"chain: {eager_err!r}); kernels in step.optimizer "
        f"{apply_launches} (torch.profiler; the pair's counter "
        f"{pair_launches}), eager chain {eager_launches}; counters "
        f"{counters_seen}")
    if counters_seen.get("optim.fused_leaves") != len(leaves):
        fail(f"_apply_update's counters {counters_seen}: not "
             f"{len(leaves)} leaves on the kernel route")
    if sync_err is not None:
        fail(f"_apply_update synchronised with the host: {sync_err}")
    # torch.profiler records kernels only where PyTorch has CUDA
    if torch.backends.cuda.is_built() and not (
            2 <= apply_launches <= 4 and eager_launches > 0):
        fail(f"_apply_update: torch.profiler read {apply_launches} kernels "
             f"in step.optimizer (wanted 2 to 4) and {eager_launches} in "
             f"the eager chain (wanted some)")

    # (d) times: the kernel pair (device, back to back), host per call,
    # the eager chain, torch.optim.AdamW(fused=True) as a yardstick
    fused = lambda: adamw.fused_adamw(tcfg, g, state.opt_state,
                                      state.params, state.step, state.sched)
    ms = time_ms([fused], iters=P15_TIMED, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P15_TIMED):
        fused()
    host_ms = (time.perf_counter() - t0) * 1e3 / P15_TIMED
    torch.cuda.synchronize()
    plain_ms = time_ms([eager], iters=3, warmup=1, spin=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager()
    plain_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    library_ms = None
    if torch.backends.cuda.is_built():
        lp = [p.detach().clone() for p in leaves]
        for p, x in zip(lp, optim.tree_leaves(g)):
            p.grad = x
        opt = torch.optim.AdamW(lp, lr=tcfg.lr, eps=tcfg.adam_eps,
                                weight_decay=tcfg.weight_decay, fused=True)
        library_ms = time_ms([opt.step], iters=P15_TIMED, warmup=2)
        del lp, opt
    m_size = 2 if tcfg.adam_dtype in ("bfloat16", "bf16") else 4
    nbytes = n_params * (4 + 4 + 4 + 2 * m_size + 4 + 2 * m_size)
    bound_ms, bound_by = _bound(nbytes, 0.0)
    rec.update(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               plain_host_ms=plain_host_ms, library_ms=library_ms,
               bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
               max_abs_err=0.0)
    log(f"kernel_time fused_adamw: t5-base {n_params} parameters, "
        f"{tcfg.adam_impl}/{tcfg.adam_dtype}: {ms:.5f} ms (bound "
        f"{bound_ms:.5f} ms, {nbytes / 1e9:.3f} GB: "
        f"{ms / bound_ms:.3f}x), host {host_ms:.3f} ms per call; eager "
        f"chain {plain_ms:.3f} ms on the card, {plain_host_ms:.3f} ms on "
        f"the host; torch AdamW(fused=True, f32 moments) "
        f"{'-' if library_ms is None else f'{library_ms:.5f}'} ms")
    if any(since(start).k):
        fail(f"phase 15 launched attention kernels {since(start).k}")
    del state, g
    torch.cuda.empty_cache()
    ctx.rows["fused_adamw"] = rec
    return {"fused_optimizer": rec}
