"""Train and eval steps (counterpart of ``vqacl_tpu/train/step.py``).

``make_train_step``: forward (encode with dropout through the fused
attention kernels K1′/K2 → prototype EMA update + retrieval → teacher-
forced decoder → fused head loss [+ the EWC/MAS anchor penalty]) →
backward → clip → AdamW direction → decoupled decay → warmup schedule
(``ops/adamw.py::adamw_step``: two kernels on the card, the plain
functions of ``train/optim.py`` on the CPU), the rest run eagerly.
Metrics stay on the device, so a step never waits for the card unless
its caller reads one. With the recorder of
``utils/profiling.py`` on, a step is the span ``step.train`` (or
``step.der_replay``) around ``step.inputs`` (the batch's copy to the
device), ``step.forward``, ``step.backward`` and ``step.optimizer`` (the
gradient reduce and layout, norm, clip, AdamW, decay, lr, ``p − lr·u``).
On the card the VL-T5 train step is captured as CUDA graphs and
replayed (``train/graph.py``): a replayed step is the span
``step.train`` around ``step.graph_replay``.

With ``cfg.model.arch == "moonlight"`` the train, eval and loss-eval
steps run VL-Moonlight (``models/moonlight.py``) through the same
``_grads_of`` and ``_apply_update``, then move the state's selection
bias (``TrainState.router_bias``); it takes one device, no prototypes,
no regularizer, remat or accumulation (``refuse_moonlight``).

``make_der_replay_step``: the same update on the DER/DER++ replay loss.
``make_logits_step``: teacher-forced logits (the DER capture pass).
``make_eval_step``: encode once (K1) → prototype retrieval without
update → greedy decode or beam search. ``make_loss_eval_step``: the
teacher-forced validation loss with retrieval-only prototypes (with
``cfg.model.fused_decoder`` its decoder attention runs in K1 too).

Data parallelism (``mesh_ctx`` with a process group; parallel/mesh.py):
each rank runs its rows of the global batch (``shard_batch``) and
differentiates its share of the global batch's loss (row means divide by
the global batch, masked means by the all-reduced count, a global term
such as the EWC/MAS penalty by dp), so the SUM of the ranks' gradients,
one ``all_reduce`` of one flat buffer per step, is the global batch's
gradient. That sum lands between the backward and the optimizer, so the
clip sees the global norm; the returned loss and metrics are global.
The forward runs under ``data_parallel`` (global-shape dropout draws,
the kernels' Philox row offset, summed prototype statistics). With an
``fsdp`` layout (parallel/sharding.py::FsdpLayout) the parameters and
moments in the state are this rank's slices: the step gathers them
before the forward, keeps its slice of the summed gradient, and the
optimizer runs on the slices with the global norm.

Tensor and pipeline parallelism (a mesh with tp or pp above 1): a rank
differentiates ``1/(dp·pp)`` of the global loss (every pp stage runs the
same downstream code, and the pipeline's collect sums its cotangent over
pp), and the bucket is all-reduced over the dp × pp group ("dpp": the
ranks that share the tp index). Under tp nothing goes over the tp group
in the bucket: the Megatron pair has already made the replicated
leaves' gradients equal there. With a ``tp`` layout
(parallel/sharding.py::TpLayout) the state holds the rank's tp slices,
which the blocks run on; a replicated state at tp > 1 is cut into them
for the forward and its sliced gradients gathered back over tp. The
clip's norm then comes from the layout. The metrics are summed over dp
only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.cl.regularizers import penalty
from vqacl_tpu_torch.models import moonlight, vlt5
from vqacl_tpu_torch.models.generate import beam_search, greedy_decode
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.parallel.mesh import data_parallel
from vqacl_tpu_torch.ops.adamw import adamw_step
from vqacl_tpu_torch.train.graph import GraphedStep
from vqacl_tpu_torch.train.optim import (tree_leaves, tree_map,
                                         tree_unflatten)
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.utils.device import resolve_device
from vqacl_tpu_torch.utils.profiling import count, span

_BATCH_KEYS = ("input_ids", "vis_feats", "boxes")
_TRAIN_KEYS = _BATCH_KEYS + ("target_ids", "scores", "ques_labels",
                             "cate_labels")


def _to_device(batch: Dict, keys, dev: torch.device) -> Dict:
    """The named entries of ``batch`` (numpy arrays or tensors) on ``dev``
    (the span ``step.inputs``; the counter ``h2d_bytes`` adds what
    comes from host memory to another device)."""
    out = {}
    with span("step.inputs"):
        for k in keys:
            x = batch[k]
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if x.device.type == "cpu" and dev.type != "cpu":
                count("h2d_bytes", x.numel() * x.element_size())
            out[k] = x.to(dev, non_blocking=True)
    return out


def _grads_of(loss_fn: Callable, params) -> Tuple[torch.Tensor, object, Dict]:
    """``loss_fn(live params) -> (loss, aux)`` differentiated in every
    parameter (zeros where it does not reach) → (loss, aux, grads); the
    spans ``step.forward`` and ``step.backward``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with span("step.forward"):
        loss, aux = loss_fn(live)
    leaves = tree_leaves(live)
    with span("step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
    return loss.detach(), aux, grads


def _dp(mesh_ctx):
    """The mesh whose collectives a step runs (one with a process group),
    or None."""
    return mesh_ctx if mesh_ctx is not None and mesh_ctx.distributed \
        else None


def reduce_grads(ctx, grads, group: str = "dpp"):
    """The sum over the ranks of ``group`` (dp × pp) of a gradient tree:
    its leaves flattened into one buffer, one ``all_reduce`` (one bucket),
    split back as views of that buffer."""
    leaves = tree_leaves(grads)
    if len({g.dtype for g in leaves}) != 1:
        raise ValueError("reduce_grads: the gradient leaves must share a "
                         "dtype")
    flat = ctx.all_reduce(torch.cat([g.reshape(-1) for g in leaves]), group)
    out, off = [], 0
    for g in leaves:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return tree_unflatten(grads, out)


def _global(ctx, *vals: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Scalars summed over the dp group (one ``all_reduce``); unchanged
    without a mesh."""
    if ctx is None:
        return vals
    return tuple(ctx.all_reduce(torch.stack([v.float() for v in vals]),
                                "dp"))


def _share(ctx) -> int:
    """The number of ranks whose loss shares sum to the global loss's
    gradient: dp × pp (1 without a mesh)."""
    return 1 if ctx is None else ctx.dp * ctx.pp


class _Placement:
    """What a step's forward runs on, from the state's parameters: the
    FSDP slices gathered over dp (``fsdp``), then, for a replicated
    state on a mesh with tp > 1, this rank's tp slices (copies: the
    gradient is the slices', gathered back over tp by ``grads``)."""

    def __init__(self, ctx, fsdp=None, tp=None):
        self.ctx, self.fsdp, self.tp = ctx, fsdp, tp
        self.cut = None

    def forward(self, params):
        if self.fsdp is not None:
            params = self.fsdp.gather(params)
        if self.ctx is not None and self.ctx.tp > 1 and self.tp is None:
            if self.cut is None:
                from vqacl_tpu_torch.parallel.sharding import TpLayout

                self.cut = TpLayout(self.ctx, params)
            params = self.cut.shard(params)
        return params

    def grads(self, grads):
        """The forward's summed gradients in the state's layout."""
        if self.cut is not None:
            grads = self.cut.gather(grads)
        return grads if self.fsdp is None else self.fsdp.slice(grads)

    def norm(self, grads) -> Optional[torch.Tensor]:
        """The whole tree's gradient norm from the state's layout, or
        None when the state holds whole leaves (the optimizer takes it
        from ``grads``)."""
        for layout in (self.fsdp, self.tp):
            if layout is not None:
                return torch.sqrt(layout.global_sq_norm(grads))
        return None

    def reg(self, reg):
        """A regularizer state (full trees) in the forward's layout →
        (state, the tp dimension of each leaf or None)."""
        if reg is None or self.ctx is None or self.ctx.tp == 1:
            return reg, None
        tpl = self.tp if self.tp is not None else self.cut
        return type(reg)(*(tpl.shard(x) for x in reg)), tpl.dims


def _apply_update(tcfg, state: TrainState, grads, proto: ProtoState,
                  ctx, place: _Placement, out=None
                  ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """The optimizer half of a step: the ranks' gradients summed (with
    a mesh ``ctx``, ``_dp``'s, over dp × pp), put in the state's layout
    (``place``), then ``ops/adamw.py::adamw_step`` (clip, AdamW
    direction, decay, lr from the schedule, ``p − lr·u``: two kernels on
    the card; ``out``: the flat buffers it writes the new parameters and
    moments to) → (new state, lr, grad norm); the span
    ``step.optimizer``."""
    with torch.no_grad(), span("step.optimizer"):
        if ctx is not None:
            grads = reduce_grads(ctx, grads)
        grads = place.grads(grads)
        params, opt_state, lr, gnorm = adamw_step(
            tcfg, grads, state.opt_state, state.params, state.step,
            state.sched, place.norm(grads), out=out)
    return state._replace(step=state.step + 1, params=params,
                          opt_state=opt_state, proto=proto), lr, gnorm


def make_train_step(cfg, dtype=torch.bfloat16, device="cuda",
                    use_prototype: Optional[bool] = None,
                    use_memory_loss: bool = False,
                    remat=False, reg_lambda: float = 0.0,
                    mesh_ctx=None, fsdp=None, tp=None,
                    prepare: Optional[Callable[[Dict], Dict]] = None
                    ) -> Callable:
    """Returns ``(state, batch, reg=None) -> (state, metrics)``.

    ``state`` is a ``TrainState`` on ``device`` (made with the transform
    ``make_transform(cfg.train)``); batch: input_ids [B,L] int32,
    vis_feats [B,N,feat_dim], boxes [B,N,4], target_ids [B,T] (-100
    pad), scores [B], ques_labels [B,NQ], cate_labels [B,NV], as numpy
    arrays or tensors. Metrics (0-dim tensors on the device): loss,
    grad_norm (before clipping), lr, loss_memory_Q/V, retrieval_acc_Q/V.
    With ``cfg.train.grad_accum`` > 1 the batch runs as that many equal
    microbatches in order, the prototype state threaded through them,
    and the grads are averaged. ``remat`` (False, True/"full", "dots")
    recomputes the encoder and decoder blocks in the backward pass
    (``t5.maybe_checkpoint``): the same loss, gradients and generator
    state, less activation memory. A ``reg``
    (``cl.regularizers.RegState``) adds the EWC/MAS anchor penalty
    ``reg_lambda/2 · Σ ω (θ−θ*)²`` to every microbatch's loss (and so to
    the ``loss`` metric), differentiated with it (given as full trees;
    under tp the step cuts them to the rank's slices). ``mesh_ctx``,
    ``fsdp`` and ``tp``: data, tensor and pipeline parallelism, FSDP and
    the tp layout (the module's note; ``tp`` a ``TpLayout`` when the
    state holds tp slices); ``batch`` is then this rank's rows
    (``parallel.mesh.shard_batch``). ``prepare`` maps the batch first,
    inside the step (``data/device_cache.py``: ``slots`` to features).

    On the card the VL-T5 step is a ``train/graph.py::GraphedStep``:
    captured once per batch signature as CUDA graphs and replayed, its
    metrics bit for bit the eager step's, and eager off the card, with a
    mesh, FSDP or tp layouts, ``grad_accum`` > 1, ``remat`` or a ``reg``.
    Aliasing: a replayed step returns one of two fixed state slots and
    writes the other, so the state one call returns is overwritten by
    the call after next; a state that is not a slot is copied in and
    left as it was. Keep a copy of a state that must outlive the next
    steps."""
    dev = resolve_device(device)
    mcfg, tcfg = cfg.model, cfg.train
    if use_prototype is None:
        use_prototype = mcfg.use_prototype
    if mcfg.arch != "vlt5":
        refuse_moonlight(cfg, use_prototype, use_memory_loss, remat,
                         reg_lambda, mesh_ctx, fsdp, tp)
        return _moonlight_train_step(cfg, dtype, dev, prepare)
    accum = int(tcfg.grad_accum)
    ctx = _dp(mesh_ctx)
    dp = ctx.dp if ctx is not None else 1
    share = _share(ctx)
    place = _Placement(ctx, fsdp, tp)

    def loss_and_grads(params, proto, batch, generator, reg):
        def loss_fn(live):
            out = vlt5.forward_train(
                live, mcfg, batch, proto,
                proto_alpha=tcfg.proto_alpha, proto_beta=tcfg.proto_beta,
                use_prototype=use_prototype, use_memory_loss=use_memory_loss,
                lambda_q=tcfg.lambda_Q, lambda_v=tcfg.lambda_V,
                generator=generator, dtype=dtype, remat=remat)
            loss = out.loss
            if reg is not None:
                loss = loss + 0.5 * reg_lambda * penalty(live, *reg)
            if share > 1:   # this rank's share of the global loss
                loss = loss / share
            return loss, out

        loss, out, grads = _grads_of(loss_fn, params)
        aux = tuple(a.detach() for a in out.aux)
        return loss, out.proto_state, aux, grads

    def accum_grads(state, batch, reg):
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"batch size {B} not divisible by "
                             f"grad_accum={accum}")
        mb = B // accum
        proto = state.proto
        gsum = tree_map(torch.zeros_like, state.params)
        losses, auxes = [], []
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, proto, aux, g = loss_and_grads(state.params, proto, part,
                                                 state.generator, reg)
            gsum = tree_map(torch.add, gsum, g)
            losses.append(loss)
            auxes.append(aux)
        grads = tree_map(lambda g: g / accum, gsum)
        aux = tuple(torch.stack(a).mean() for a in zip(*auxes))
        return torch.stack(losses).mean(), proto, aux, grads

    def train_step(state, batch, reg=None, out=None):
        if prepare is not None:
            batch = prepare(batch)
        batch = _to_device(batch, _TRAIN_KEYS, dev)
        full = state._replace(params=place.forward(state.params))
        reg = None if reg is None else place.reg(reg)
        with data_parallel(ctx):
            if accum > 1:
                loss, proto, aux, grads = accum_grads(full, batch, reg)
            else:
                loss, proto, aux, grads = loss_and_grads(
                    full.params, state.proto, batch, state.generator, reg)
        new_state, lr, gnorm = _apply_update(tcfg, state, grads, proto,
                                             ctx, place, out)
        if ctx is not None:
            loss, *aux = _global(ctx, loss * ctx.pp, *aux)
            aux = [a / dp for a in aux]
        metrics = {
            "loss": loss, "grad_norm": gnorm, "lr": lr,
            "loss_memory_Q": aux[0], "loss_memory_V": aux[1],
            "retrieval_acc_Q": aux[2], "retrieval_acc_V": aux[3],
        }
        return new_state, metrics

    eligible = ctx is None and fsdp is None and tp is None and accum == 1 \
        and not remat
    return GraphedStep(train_step, _TRAIN_KEYS + ("slots",), eligible)


ARCHS = ("vlt5", "moonlight")


def refuse_moonlight(cfg, use_prototype=False, use_memory_loss=False,
                     remat=False, reg_lambda=0.0, mesh_ctx=None, fsdp=None,
                     tp=None) -> None:
    """ValueError for what the VL-Moonlight step does not take: VQACL's
    prototypes (defined on an encoder's output, which a decoder-only
    model lacks) and the memory loss, EWC/MAS penalties, block
    recompute, gradient accumulation and a mesh."""
    if cfg.model.arch not in ARCHS:
        raise ValueError(f"model.arch={cfg.model.arch!r}; pick from {ARCHS}")
    if use_prototype or use_memory_loss:
        raise ValueError("arch='moonlight' has no prototypes: VQACL's Q/V "
                         "prototypes are pooled from an encoder's output, "
                         "which the decoder-only model lacks (set "
                         "model.use_prototype=False)")
    if remat or reg_lambda or int(cfg.train.grad_accum) != 1 \
            or fsdp is not None or tp is not None \
            or (mesh_ctx is not None and mesh_ctx.world_size > 1):
        raise ValueError("arch='moonlight' trains on one device without "
                         "remat, EWC/MAS, grad_accum or a mesh")


def _moonlight_train_step(cfg, dtype, dev, prepare=None) -> Callable:
    """``make_train_step`` for VL-Moonlight: forward, backward and the
    optimizer of the VL-T5 step (``_grads_of``, ``_apply_update``), then
    the selection bias moved by the step's loads; metrics also carry
    ``balance`` (the balance loss), ``expert_load`` (f32 [MoE layers,
    router experts]: the tokens that chose each expert) and ``choices``
    (each MoE layer's chosen experts, int64 [rows·positions, k]).
    ``prepare`` as ``make_train_step`` takes it."""
    mcfg, tcfg = cfg.model, cfg.train
    place = _Placement(None)
    gamma = float(mcfg.router_bias_gamma)

    def train_step(state: TrainState, batch: Dict, reg=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("step.train"):
            b = _to_device(batch if prepare is None else prepare(batch),
                           _TRAIN_KEYS, dev)

            def loss_fn(live):
                out = moonlight.forward_train(live, mcfg, b, state.proto,
                                              state.router_bias, dtype)
                return out.loss, out

            loss, out, grads = _grads_of(loss_fn, state.params)
            new, lr, gnorm = _apply_update(tcfg, state, grads, state.proto,
                                           None, place)
            new = new._replace(router_bias=moonlight.update_bias(
                state.router_bias, out.load, gamma))
            aux = out.aux
            return new, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                         "loss_memory_Q": aux[0], "loss_memory_V": aux[1],
                         "retrieval_acc_Q": aux[2],
                         "retrieval_acc_V": aux[3],
                         "balance": out.balance, "expert_load": out.load,
                         "choices": out.choices}

    return train_step


def make_der_replay_step(cfg, dtype=torch.bfloat16, device="cuda",
                         use_prototype: Optional[bool] = None,
                         remat=False, mesh_ctx=None, fsdp=None,
                         tp=None) -> Callable:
    """Dark-Experience-Replay step (Buzzega et al. 2020) for memory
    batches, ``(state, batch) -> (state, metrics)``; a Table-1 comparison
    method the reference repo does not implement (its replay is plain
    ER, a second CE step, vqacl.py:371-373).

    The batch carries ``der_logits`` [B,T,V] f16: the model's
    teacher-forced logits captured when each exemplar entered the
    buffer, with the teacher-forcing targets pinned at capture time
    (data/partition.py). Loss = α·MSE(current logits, stored logits)
    over valid target positions (α = ``train.reg_lambda``); DER++
    (``cl_reg='derpp'``) adds β·CE on the replay ground truth
    (β = ``train.der_beta``). The optimizer, clip and schedule are
    ``make_train_step``'s, and the prototype banks update as in a normal
    replay step. Metrics: loss, der_mse, grad_norm, lr. ``mesh_ctx``,
    ``fsdp`` and ``tp`` as in ``make_train_step``: the MSE's masked mean
    divides by the count of valid positions all-reduced over dp, the CE's
    row mean by the global batch, and both by pp."""
    dev = resolve_device(device)
    mcfg, tcfg = cfg.model, cfg.train
    alpha = float(tcfg.reg_lambda)
    beta = float(tcfg.der_beta) if tcfg.cl_reg == "derpp" else 0.0
    if use_prototype is None:
        use_prototype = mcfg.use_prototype
    ctx = _dp(mesh_ctx)
    dp = ctx.dp if ctx is not None else 1
    pp = ctx.pp if ctx is not None else 1
    place = _Placement(ctx, fsdp, tp)

    def der_step(state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("step.der_replay"):
            return _der_step(state, batch)

    def _der_step(state, batch):
        b = _to_device(batch, _TRAIN_KEYS + ("der_logits",), dev)
        gen = state.generator
        params = place.forward(state.params)

        def loss_fn(live):
            hidden, enc_mask = vlt5.encode(
                live, mcfg, b["input_ids"], b["vis_feats"], b["boxes"],
                dtype=dtype, generator=gen, remat=remat)
            proto = state.proto
            if use_prototype:
                hidden, enc_mask, proto, _ = vlt5.augment(
                    mcfg, hidden, enc_mask, proto,
                    ques_labels=b["ques_labels"],
                    cate_labels=b["cate_labels"], proto_update_flag=True,
                    proto_alpha=tcfg.proto_alpha, proto_beta=tcfg.proto_beta)
            logits = vlt5.decode_train(live, mcfg, hidden, enc_mask,
                                       b["target_ids"], generator=gen,
                                       dtype=dtype, remat=remat)
            mask = (b["target_ids"] != -100).float()                # [B,T]
            se = torch.mean((logits.float() - b["der_logits"].float()) ** 2,
                            dim=-1)
            count = mask.sum()
            if ctx is not None:
                count = ctx.all_reduce(count.clone(), "dp")
            mse = torch.sum(se * mask) / count.clamp_min(1.0)
            loss = alpha * mse
            if beta > 0.0:
                loss = loss + beta * vlt5.weighted_lm_loss(
                    logits, b["target_ids"], b["scores"]) / dp
            return loss / pp, (proto, mse.detach())

        with data_parallel(ctx):
            loss, (proto, mse), grads = _grads_of(loss_fn, params)
        new_state, lr, gnorm = _apply_update(tcfg, state, grads, proto,
                                             ctx, place)
        loss, mse = _global(ctx, loss * pp, mse)
        return new_state, {"loss": loss, "der_mse": mse, "grad_norm": gnorm,
                           "lr": lr}

    return der_step


def make_logits_step(cfg, dtype=torch.bfloat16, device="cuda",
                     use_prototype: Optional[bool] = None) -> Callable:
    """Teacher-forced logits ``(params, proto, batch) -> [B,T,V] f32`` on
    ``device``, with retrieval-only prototypes, deterministic and without
    grad (the encoder attention runs K1): the DER capture pass
    (cl/trainer.py::_der_capture) that snapshots each exemplar's logits
    as it enters the replay buffer."""
    dev = resolve_device(device)
    mcfg = cfg.model
    if use_prototype is None:
        use_prototype = mcfg.use_prototype

    @torch.no_grad()
    def logits_step(params: Dict, proto: ProtoState, batch: Dict
                    ) -> torch.Tensor:
        b = _to_device(batch, _BATCH_KEYS + ("target_ids",), dev)
        hidden, enc_mask = vlt5.encode(params, mcfg, b["input_ids"],
                                       b["vis_feats"], b["boxes"],
                                       dtype=dtype)
        if use_prototype:
            hidden, enc_mask, _, _ = vlt5.augment(mcfg, hidden, enc_mask,
                                                  proto)
        return vlt5.decode_train(params, mcfg, hidden, enc_mask,
                                 b["target_ids"], dtype=dtype)

    return logits_step


def make_eval_step(cfg, dtype=torch.bfloat16, device="cuda",
                   use_prototype: Optional[bool] = None,
                   max_length: Optional[int] = None,
                   num_beams: int = 1) -> Callable:
    """Returns ``(params, proto, batch) -> token ids [B, max_length-1]``
    (int32, on ``device``; ``max_length`` defaults to
    ``cfg.model.gen_max_length``). ``params``/``proto`` must already be
    on ``device``; ``batch`` holds ``input_ids``, ``vis_feats`` and
    ``boxes`` as numpy arrays or tensors (moved to ``device`` here).
    Encoder once, prototype retrieval without update (unless
    ``use_prototype`` is False), then greedy decoding, or beam search
    with ``num_beams`` > 1."""
    dev = resolve_device(device)
    mcfg = cfg.model
    if use_prototype is None:
        use_prototype = mcfg.use_prototype
    if mcfg.arch != "vlt5":
        refuse_moonlight(cfg, use_prototype)
        if num_beams > 1:
            raise ValueError("arch='moonlight' decodes greedily")

        @torch.inference_mode()
        def moon_eval_step(params: Dict, proto: ProtoState, batch: Dict,
                           router_bias=None) -> torch.Tensor:
            b = _to_device(batch, _BATCH_KEYS, dev)
            bias = router_bias if router_bias is not None else \
                moonlight.init_router_bias(mcfg, dev)
            return moonlight.greedy(params, mcfg, b["input_ids"],
                                    b["vis_feats"], b["boxes"], bias,
                                    max_length=max_length, dtype=dtype)

        return moon_eval_step

    @torch.inference_mode()
    def eval_step(params: Dict, proto: ProtoState, batch: Dict
                  ) -> torch.Tensor:
        b = _to_device(batch, _BATCH_KEYS, dev)
        hidden, enc_mask = vlt5.encode(params, mcfg, b["input_ids"],
                                       b["vis_feats"], b["boxes"],
                                       dtype=dtype)
        if use_prototype:
            hidden, enc_mask, _, _ = vlt5.augment(mcfg, hidden, enc_mask,
                                                  proto)
        if num_beams > 1:
            return beam_search(params, mcfg, hidden, enc_mask,
                               num_beams=num_beams, max_length=max_length,
                               dtype=dtype)
        return greedy_decode(params, mcfg, hidden, enc_mask,
                             max_length=max_length, dtype=dtype)

    return eval_step


def make_loss_eval_step(cfg, dtype=torch.bfloat16, device="cuda",
                        use_prototype: Optional[bool] = None) -> Callable:
    """Returns ``(params, proto, batch) -> loss`` (0-dim f32 on
    ``device``): the teacher-forced weighted loss with retrieval-only
    prototypes, no dropout, no grad and no bank update."""
    dev = resolve_device(device)
    mcfg = cfg.model
    if use_prototype is None:
        use_prototype = mcfg.use_prototype
    if mcfg.arch != "vlt5":
        refuse_moonlight(cfg, use_prototype)

        def moon_eval_loss(params: Dict, proto: ProtoState, batch: Dict,
                           router_bias=None) -> torch.Tensor:
            b = _to_device(batch, _TRAIN_KEYS, dev)
            bias = router_bias if router_bias is not None else \
                moonlight.init_router_bias(mcfg, dev)
            return moonlight.eval_loss(params, mcfg, b, bias, dtype)

        return moon_eval_loss

    @torch.no_grad()
    def eval_loss(params: Dict, proto: ProtoState, batch: Dict
                  ) -> torch.Tensor:
        b = _to_device(batch, _TRAIN_KEYS, dev)
        hidden, enc_mask = vlt5.encode(params, mcfg, b["input_ids"],
                                       b["vis_feats"], b["boxes"],
                                       dtype=dtype)
        if use_prototype:
            hidden, enc_mask, _, _ = vlt5.augment(mcfg, hidden, enc_mask,
                                                  proto)
        logits = vlt5.decode_train(params, mcfg, hidden, enc_mask,
                                   b["target_ids"], dtype=dtype)
        return vlt5.weighted_lm_loss(logits, b["target_ids"], b["scores"])

    return eval_loss
