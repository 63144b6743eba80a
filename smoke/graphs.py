"""Phase 17 of ``chip_smoke.py``: the train step's CUDA graphs."""

import itertools
import time

import torch

from smoke.harness import TRAIN_BATCH, check_adamw, fail, log, since
from smoke.optimizer import _mismatch
from vqacl_tpu_torch.data.synthetic import SyntheticVQA
from vqacl_tpu_torch.ops import dw
from vqacl_tpu_torch.ops import head_loss as HL
from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.train.optim import make_transform, tree_leaves
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import make_train_step
from vqacl_tpu_torch.utils.config import Config

# phase 17, the train step's CUDA graphs: steps compared bit for bit, then
# steps timed of each
P17_STEPS = 8
P17_TIMED = 20


def graph_replay(ctx):
    """The train step's CUDA graphs (``train/graph.py``) at t5-base, batch 80,
    merged q/k/v, dropout 0.1: ``P17_STEPS`` train and replay batches in
    turns through the step run eagerly and through the graphed step (one
    capture, then replays, each under
    ``torch.cuda.set_sync_debug_mode("error")``), from the same state: after
    each step the metrics, every parameter, both moments, the step and Adam
    counts, the prototype banks and the generator's state bit for bit equal;
    K1′ and K2 12 each a step, the head loss's H1 (2 launches), H2 and
    its two K5 products on the wgmma route a step in each run, and the
    fused optimizer's pair, counted on replays as on eager steps;
    then the host ms to issue a step and the wall ms a step over
    ``P17_TIMED`` more steps of each.

    From phase 3's t5-base; the launches of all its steps are counted."""
    params, proto = ctx.params, ctx.proto
    cfg = Config()
    cfg.model.merged_qkv = True           # as VQACLTrainer runs the model
    tx = make_transform(cfg.train)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b["tensors"].items()}
               for b in itertools.islice(SyntheticVQA(
                   2 * TRAIN_BATCH, seed=17).batches(TRAIN_BATCH, seed=17), 2)]
    steps, states, met = {}, {}, {}
    for name in ("eager", "graphed"):
        steps[name] = make_train_step(cfg, dtype=torch.bfloat16,
                                      device="cuda")
        steps[name].eligible = name == "graphed"
        states[name] = TrainState.create(params, tx, proto, seed=17,
                                         warmup_iters=1.0, t_total=1000.0)

    def pairs(a, b):
        oa, ob = a.opt_state, b.opt_state
        return ((a.params, b.params), (oa.mu, ob.mu), (oa.nu, ob.nu),
                (oa.count, ob.count), (a.step, b.step),
                (a.proto._asdict(), b.proto._asdict()))

    def head(w):
        """H1, H2 and K5's wgmma route: the head loss's launches."""
        return [w.of(HL.head_lse), w.of(HL.head_dlogits),
                w.of(dw.dw_splitk, "route_launches", "wgmma")]

    before = launches.read()
    bad = []
    hk = {"eager": [0, 0, 0], "graphed": [0, 0, 0]}
    for i in range(P17_STEPS):
        b = batches[i % 2]
        for name in ("eager", "graphed"):
            replay = name == "graphed" and i > 0
            at = launches.read()
            if replay:
                torch.cuda.set_sync_debug_mode("error")
            try:
                states[name], met[name] = steps[name](states[name], b)
            except RuntimeError as e:     # a sync under the debug mode
                fail(f"phase 17: {name} step {i} raised {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            hk[name] = [a + n for a, n in zip(hk[name], head(since(at)))]
        e, g = states["eager"], states["graphed"]
        n = sum(_mismatch(x, y, tree_leaves) for x, y in pairs(e, g))
        n += sum(_mismatch(met["eager"][k], met["graphed"][k], tree_leaves)
                 for k in met["eager"])
        same_rng = torch.equal(e.generator.get_state(),
                               g.generator.get_state())
        bad.append(n + (not same_rng))
    losses = {k: [float(v["loss"])] for k, v in met.items()}
    cmp_w = since(before)
    k = cmp_w.k
    g = steps["graphed"]
    per_step = cfg.model.num_layers * 2 * P17_STEPS     # both runs
    want_hk = [2 * P17_STEPS, P17_STEPS, 2 * P17_STEPS]
    log(f"graph_replay: bs {TRAIN_BATCH} bf16, {P17_STEPS} train/replay "
        f"steps eager vs graphed: elements differing after each step {bad}; "
        f"captures {g.captures} replays {g.replays} eager steps "
        f"{g.eager_steps}; launches K1={k[0]} K1'={k[1]} K2={k[2]} "
        f"(expected 0/{per_step}/{per_step}), head loss H1/H2/K5 eager "
        f"{hk['eager']} graphed {hk['graphed']} (expected {want_hk} each); "
        f"last loss {losses}")
    if any(bad):
        fail(f"phase 17: the graphed steps differ from the eager ones {bad}")
    if g.captures != 1 or g.replays < P17_STEPS - 1 or g.eager_steps != 1:
        fail(f"phase 17: captures {g.captures}, replays {g.replays}, eager "
             f"steps {g.eager_steps}")
    if k != (0, per_step, per_step):
        fail(f"phase 17: launches {k}, expected (0, {per_step}, "
             f"{per_step})")
    if hk != {"eager": want_hk, "graphed": want_hk}:
        fail(f"phase 17: head loss launches H1/H2/K5 {hk}, expected "
             f"{want_hk} in each run")
    check_adamw("phase 17", cmp_w, 2 * P17_STEPS, 2, ctx)
    mid = launches.read()

    # the host's ms to issue a step, and the wall ms a step, of each
    timed = {}
    for name in ("eager", "graphed"):
        issue = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(P17_TIMED):
            t1 = time.perf_counter()
            states[name], met[name] = steps[name](states[name],
                                                  batches[i % 2])
            issue.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / P17_TIMED
        timed[name] = {"issue_ms_median": sorted(issue)[len(issue) // 2],
                       "wall_ms_per_step": wall}
        log(f"graph_replay timed {name}: {P17_TIMED} steps, host ms to "
            f"issue a step (median) {timed[name]['issue_ms_median']:.3f}, "
            f"wall ms a step {wall:.3f}")
    check_adamw("phase 17 timed", since(mid), 2 * P17_TIMED, 2, ctx)
    rec = {"steps": P17_STEPS, "mismatched": bad, "captures": g.captures,
           "replays": g.replays, "eager_steps": g.eager_steps,
           "launches": list(k), "head_launches": hk, "timed": timed}
    all_w = since(before)
    ctx.count(all_w)
    ctx.count(all_w, (HL.head_lse, HL.head_dlogits, dw.dw_splitk))
    del steps, states, met
    torch.cuda.empty_cache()
    return {"graph_replay": rec, "graph_replay_launches": list(all_w.k)}
