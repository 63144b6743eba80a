"""GPipe pipeline parallelism for the T5 stacks over ``torch.distributed``
(counterpart of ``vqacl_tpu/parallel/pipeline.py``).

Each rank of a pp group (parallel/mesh.py: the ranks that share the dp
and tp indices) is one stage: stage s runs the blocks ``s·k … s·k + k −
1`` (``k = n_layers / pp``) of a stack, for ``M`` microbatches of the
rank's rows, in JAX's fill-drain schedule of ``M + pp − 1`` ticks: at
tick t stage 0 ingests microbatch t, stage s works on microbatch ``t −
s``, and the last stage finishes microbatch ``t − (pp − 1)``. Every rank
runs every tick; a stage with no microbatch at a tick computes nothing,
but joins that tick's hand-off. With tp > 1 (an active mesh, the rank's
Megatron slices) each stage runs the tp blocks of models/t5.py; with the
fused attention, K1′/K2 (K1 without grad) over its microbatches.

Two ``torch.autograd.Function``s carry the activations:

  ``_Handoff``  stage s → s + 1 for one tick: an ``all_reduce`` over the
                pp group of a zeroed [pp, …] slot buffer in which stage s
                writes slot s + 1 and reads slot s, summed as int32 words
                (bit for bit, ``MeshContext.combine``). Its backward is
                the same with the roles swapped (``ppermute``'s
                transpose).
  ``_Collect``  the last stage's finished microbatches on every stage
                (one ``combine`` over pp, JAX's closing ``psum``); its
                backward sums the cotangent over pp (the ``psum``'s
                transpose) and hands it to the last stage.

Only all_reduce is used, so one code path runs on NCCL, on gloo on the
CPU and on gloo with several ranks on one card. Every rank of a group
must run the same collectives in one order, forward and backward: the
hand-offs and the collect form ONE chain (each takes the previous one's
token output as an input, the first takes the stack's input, and the
decoder's first takes the encoder states), so autograd runs their
backwards in reverse order on every rank, and the encoder's collect after
the decoder's chain.

What differs from JAX, on purpose: the per-microbatch side inputs (the
encoder's key mask, the decoder's encoder states and cross mask) are not
handed off: every pp rank holds all of its rows' side inputs and indexes
microbatch ``t − s`` itself; the encoder states' gradient then gathers on
each stage from its own layers and the encoder's collect sums it over
pp. A microbatch is ``B / M`` consecutive rows of the rank's rows (JAX
microbatches the global batch and shards each over dp; rows are
independent, so the result is the same). The attention dropout of the
fused kernels draws the sequential run's streams (each microbatch at its
rows' Philox offset, ``mesh.microbatch_rows``); the other dropout masks
come from a generator per (layer, microbatch), seeded from the layer's
seed, so they differ from the sequential run's, as JAX's do
(``pipeline.py:170-172``). Every rank draws all ``n`` layer seeds from
the step's generator in one order, so the generators stay in step.
``remat`` does not apply to the pipelined stacks (nor in JAX's).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from vqacl_tpu_torch.parallel.mesh import (MeshContext, microbatch_rows,
                                           row_offset)

Params = Dict[str, Any]


def stack_blocks(stack_params: Params, n_layers: int) -> Params:
    """[p["block_0"], …, p["block_{n-1}"]] as one tree whose leaves have
    a leading layer axis (the layout JAX shards over pp)."""
    blocks = [stack_params[f"block_{i}"] for i in range(n_layers)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs, dim=0)

    return stack(*blocks)


def stacked_block_specs(stacked: Params, pp_axis: str = "pp",
                        tp_axis: Optional[str] = None) -> Any:
    """JAX's ``stacked_block_specs`` as data: every leaf of a
    ``stack_blocks`` tree has its layer axis over ``pp_axis``; with
    ``tp_axis``, q/k/v and wi by output and the two wo by input over it
    (tuples of axis names, one per dimension)."""
    def leaf(parent, name, x):
        if tp_axis is None or x.dim() < 3:
            return (pp_axis,)
        if parent in ("attn", "cross_attn") and name in ("wq", "wk", "wv"):
            return (pp_axis, None, tp_axis)
        if parent in ("attn", "cross_attn") and name == "wo":
            return (pp_axis, tp_axis, None)
        if parent == "mlp" and name == "wi":
            return (pp_axis, None, tp_axis)
        if parent == "mlp" and name == "wo":
            return (pp_axis, tp_axis, None)
        return (pp_axis,)

    def walk(node, parent):
        return {k: walk(v, k) if isinstance(v, dict) else leaf(parent, k, v)
                for k, v in node.items()}

    return walk(stacked, "")


class _Handoff(torch.autograd.Function):
    """One tick's stage s → s + 1 hand-off over the pp group → (what
    stage s receives, a token for the next link of the chain)."""

    @staticmethod
    def forward(fctx, y, dep, mesh, shape, dtype):
        s, pp = mesh.pp_stage, mesh.pp
        buf = torch.zeros((pp,) + shape, dtype=dtype, device=dep.device)
        if y is not None and s + 1 < pp:
            buf[s + 1] = y
        recv = mesh.combine(buf, "pp")[s]
        fctx.mesh, fctx.shape, fctx.dtype = mesh, shape, dtype
        fctx.has_y = y is not None
        fctx.dep = (dep.shape, dep.dtype)
        return recv, torch.zeros((), dtype=torch.float32, device=dep.device)

    @staticmethod
    def backward(fctx, g_recv, g_tok):
        mesh = fctx.mesh
        s, pp = mesh.pp_stage, mesh.pp
        buf = torch.zeros((pp,) + fctx.shape, dtype=fctx.dtype,
                          device=g_tok.device)
        if s > 0:                      # stage 0 receives from nobody
            buf[s] = g_recv
        g = mesh.combine(buf, "pp")
        g_y = g[s + 1] if fctx.has_y and s + 1 < pp else None
        if fctx.has_y and g_y is None:
            g_y = torch.zeros(fctx.shape, dtype=fctx.dtype,
                              device=g_tok.device)
        shape, dtype = fctx.dep
        return (g_y, torch.zeros(shape, dtype=dtype, device=g_tok.device),
                None, None, None)


class _Collect(torch.autograd.Function):
    """The last stage's outputs [B, …] on every stage of the pp group."""

    @staticmethod
    def forward(fctx, y, dep, mesh, shape, dtype):
        buf = torch.zeros(shape, dtype=dtype, device=dep.device)
        if y is not None:
            buf.copy_(y)
        fctx.mesh, fctx.has_y = mesh, y is not None
        fctx.dep = (dep.shape, dep.dtype)
        return mesh.combine(buf, "pp")

    @staticmethod
    def backward(fctx, g):
        g = fctx.mesh.all_reduce(g.contiguous().clone(), "pp")
        shape, dtype = fctx.dep
        return (g if fctx.has_y else None,
                torch.zeros(shape, dtype=dtype, device=g.device),
                None, None, None)


def gpipe(mesh: MeshContext, stage_fn: Callable, acts_mb: torch.Tensor,
          dep: torch.Tensor) -> torch.Tensor:
    """Run the microbatches ``acts_mb`` [M, mb, …] through the pp stages:
    this rank runs ``stage_fn(x, m) -> x`` (its blocks on microbatch m)
    at each tick it holds a microbatch, and takes part in every tick's
    hand-off. ``dep`` is the chain's first link (a tensor of the step's
    graph on every rank). → the last stage's outputs [M·mb, …] on every
    stage."""
    pp, s = mesh.pp, mesh.pp_stage
    M = acts_mb.shape[0]
    shape, dtype = tuple(acts_mb.shape[1:]), acts_mb.dtype
    if pp > 1 and torch.is_grad_enabled() and not dep.requires_grad:
        # every link must be recorded on every rank, also where a stage's
        # tick has no input that needs a gradient (an idle tick over a
        # constant input), or the ranks' backwards run other hand-offs
        dep = torch.zeros((), dtype=torch.float32, device=dep.device,
                          requires_grad=True)
    outs: List[torch.Tensor] = []
    recv = None
    for t in range(M + pp - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            y = stage_fn(acts_mb[m] if s == 0 else recv, m)
            if s == pp - 1:
                outs.append(y)
        if pp == 1:
            continue
        recv, dep = _Handoff.apply(y, dep, mesh, shape, dtype)
    y = torch.cat(outs) if outs else None
    if pp == 1:
        return y
    return _Collect.apply(y, dep, mesh, (M * shape[0],) + shape[1:], dtype)


def _check(name: str, n: int, pp: int, heads: int, tp: int, B: int,
           n_micro: int) -> int:
    """JAX's assertions as ValueError (their tuples first) → rows per
    microbatch."""
    if n % pp:
        raise ValueError(f"{(n, pp)}: {name}: {n} layers not divisible by "
                         f"pp={pp}")
    if heads % tp:
        raise ValueError(f"{(heads, tp)}: {name}: {heads} heads not "
                         f"divisible by tp={tp}")
    if B % n_micro:
        raise ValueError(f"{(B, n_micro)}: {name}: a batch of {B} rows not "
                         f"divisible by pp_micro={n_micro}")
    return B // n_micro


def _stage_seeds(n: int, generator: Optional[torch.Generator]):
    """(the n layer seeds [n] int32 on the generator's device, the same as
    host ints) drawn as the sequential stack draws them; (None, None)
    without a generator."""
    from vqacl_tpu_torch.models.t5 import _layer_seeds

    seeds = _layer_seeds(n, generator)
    return (None, None) if seeds is None else (seeds, seeds.tolist())


def _layer_generator(host_seeds, li: int, m: int, device):
    """The dropout generator of layer ``li`` on microbatch ``m`` (JAX's
    ``fold_in(fold_in(key, layer), microbatch)``)."""
    if host_seeds is None:
        return None
    return torch.Generator(device=device).manual_seed(
        (int(host_seeds[li]) << 20) + m)


def encoder_stack_pp(p: Params, cfg, inputs_embeds: torch.Tensor,
                     position_bias: Optional[torch.Tensor],
                     mesh: MeshContext, n_micro: int,
                     fused: Optional[Dict[str, Any]] = None,
                     mask_add: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """``t5.encoder_stack`` pipelined over the pp group of ``mesh`` with
    ``n_micro`` microbatches. Unfused: ``position_bias`` [1,H,S,S] and
    ``mask_add`` [B,1,1,S]; fused (``fused`` = {"pos_bias" [H,L,L], "mask"
    [B,S]}): each stage's blocks run K1′/K2 (K1 without grad). The same
    result as the sequential stack at dropout 0."""
    from vqacl_tpu_torch.models import t5

    n, H = cfg.num_layers, cfg.num_heads
    B, S, D = inputs_embeds.shape
    mb = _check("encoder_stack_pp", n, mesh.pp, H, mesh.tp, B, n_micro)
    k, s = n // mesh.pp, mesh.pp_stage
    rate = cfg.dropout_rate
    x = t5.dropout(inputs_embeds, rate, generator)
    nh = t5.local_heads(p["block_0"]["attn"], cfg)
    seeds, host = _stage_seeds(n, generator)
    row0 = row_offset(B)
    if fused is not None:
        bias = t5.head_slice(fused["pos_bias"], 0, nh)
        bias = None if bias is None else bias.contiguous()
        side = fused["mask"]
    else:
        bias = t5.head_slice(position_bias, 1, nh)
        side = mask_add

    def stage(h, m):
        rows = slice(m * mb, (m + 1) * mb)
        with microbatch_rows(row0 + m * mb):
            for li in range(s * k, (s + 1) * k):
                g = _layer_generator(host, li, m, x.device)
                blk = p[f"block_{li}"]
                if fused is not None:
                    h = t5.encoder_block_fused(
                        blk, cfg, h, bias, side[rows],
                        None if seeds is None else seeds[li:li + 1], g)
                else:
                    h = t5.encoder_block(blk, cfg, h, bias, side[rows], g)
        return h

    out = gpipe(mesh, stage, x.reshape(n_micro, mb, S, D), x)
    x = t5.layer_norm(p["final_ln"], out.reshape(B, S, D),
                      cfg.layer_norm_epsilon)
    return t5.dropout(x, rate, generator)


def decoder_stack_pp(p: Params, cfg, inputs_embeds: torch.Tensor,
                     enc_states: torch.Tensor,
                     enc_mask: Optional[torch.Tensor],
                     mesh: MeshContext, n_micro: int,
                     generator: Optional[torch.Generator] = None,
                     fused: bool = False) -> torch.Tensor:
    """``t5.decoder_stack`` (train path semantics: no decoder padding
    mask) pipelined over the pp group of ``mesh``. ``fused`` (taken with
    an ``enc_mask``, as the sequential stack takes it): each stage's
    blocks run both attention cores in K1′/K2. The encoder states are the
    chain's first link, so the encoder's collect runs its backward after
    this stack's hand-offs."""
    from vqacl_tpu_torch.models import t5

    n, H = cfg.num_decoder_layers, cfg.num_heads
    B, T, D = inputs_embeds.shape
    mb = _check("decoder_stack_pp", n, mesh.pp, H, mesh.tp, B, n_micro)
    k, s = n // mesh.pp, mesh.pp_stage
    dev = inputs_embeds.device
    rate = cfg.dropout_rate
    pb = t5.compute_position_bias(
        p["rel_bias"], T, T, bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    x = t5.dropout(inputs_embeds, rate, generator)
    nh = t5.local_heads(p["block_0"]["attn"], cfg)
    enc = t5.copy_to_tp(enc_states)
    fused = bool(fused) and enc_mask is not None
    seeds, host = _stage_seeds(2 * n if fused else n, generator)
    row0 = row_offset(B)
    if fused:
        causal_add = (1.0 - t5.causal_mask(T, dev)[0, 0]) * t5.NEG_INF
        self_bias = t5.head_slice(pb[0].float() + causal_add[None], 0,
                                  nh).contiguous()
    else:
        self_bias = t5.head_slice(
            t5.attention_scores_bias(t5.causal_mask(T, dev), pb), 1, nh)
        cross_bias = None if enc_mask is None else t5.attention_scores_bias(
            enc_mask[:, None, None, :], None)

    def stage(h, m):
        rows = slice(m * mb, (m + 1) * mb)
        with microbatch_rows(row0 + m * mb):
            for li in range(s * k, (s + 1) * k):
                blk = p[f"block_{li}"]
                if fused:
                    g = _layer_generator(host, 2 * li, m, dev)
                    h = t5.decoder_block_fused(
                        blk, cfg, h, self_bias, enc[rows], enc_mask[rows],
                        None if seeds is None else seeds[2 * li:2 * li + 2],
                        g)
                else:
                    g = _layer_generator(host, li, m, dev)
                    h = t5.decoder_block(
                        blk, cfg, h, self_bias, enc[rows],
                        None if cross_bias is None else cross_bias[rows], g)
        return h

    out = gpipe(mesh, stage, x.reshape(n_micro, mb, T, D), enc_states)
    x = t5.layer_norm(p["final_ln"], out.reshape(B, T, D),
                      cfg.layer_norm_epsilon)
    return t5.dropout(x, rate, generator)
