"""T5 encoder and decoder pieces for the serving and training paths.

Counterpart of ``vqacl_tpu/models/t5.py``: plain functions on a nested
dict of tensors with the JAX pytree's keys. Linear weights are kept in
the JAX orientation ``[in, out]`` and applied as ``x @ W``.

Dropout follows the JAX placement (attention weights, MLP hidden, each
residual branch, stack input and output). A ``generator`` argument
(``torch.Generator`` on the tensors' device) turns it on; ``None`` is
the deterministic path, as JAX's ``deterministic=True``. Under a
data-parallel mesh (``parallel.mesh.data_parallel``) each mask is drawn
at the global batch's shape and this rank keeps its rows, and the fused
attention takes this rank's Philox row offset, so every rank's generator
stays in step and the ranks together draw a one-process step's masks.

Tensor parallelism (an active mesh with tp > 1; the Megatron layout of
``parallel/sharding.py``): the blocks take the rank's slices of q/k/v,
wi and the two wo, so they run ``nh_loc = wq.shape[1] // d_kv`` local
heads and ``d_ff / tp`` of the hidden (``encoder_block_tp``,
``decoder_block_tp``, and the fused blocks over K1′/K2). The normed input
of each column-parallel product goes through ``copy_to_tp`` and each
partial output through ``reduce_from_tp`` before its residual add, so
``x`` stays replicated over the tp group; the stacks pass the encoder
states (cross k/v of every layer) and the whole relative bias through
``copy_to_tp`` once, then cut the bias to the local heads. Dropout of
the attention probabilities and of the MLP hidden draws at the global
width and keeps the rank's heads or columns; the residual masks are the
same on every tp rank; the fused kernels take the rank's heads ``(Hc,
h0)``. A tp step at dropout > 0 so draws a one-process step's masks.

T5 specifics kept: RMS layer norm without mean or bias (variance in
f32), unscaled dot-product attention with f32 scores and softmax, the
relative position bias computed from one table per stack, an additive
−1e9 mask (not −inf), ReLU feed-forward, and tied embeddings with the
``d_model**-0.5`` output rescale. Cast points follow the JAX code:
products that JAX runs with ``preferred_element_type=float32`` are
computed here on f32 copies of the operands.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from vqacl_tpu_torch.parallel.mesh import (active, copy_to_tp,
                                           reduce_from_tp, row_offset,
                                           tp_active)

Params = Dict[str, Any]

NEG_INF = -1e9  # additive mask value; applied in f32 before softmax


def layer_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 RMS norm: no mean subtraction, no bias; variance in f32."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(dt)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            tp_dim: Optional[int] = None) -> torch.Tensor:
    """Keep each element with probability 1 − rate and scale kept ones
    by 1/(1 − rate); the identity without a generator or at rate 0.
    Under an active data-parallel mesh the draw covers the global batch
    (x's rows on every rank) and this rank keeps its own rows; under
    tensor parallelism, ``tp_dim`` names the dimension x holds the rank's
    slice of (heads, MLP hidden): the draw covers its global width and
    the rank keeps its slice."""
    if generator is None or rate == 0.0:
        return x
    ctx = active()
    shape = list(x.shape)
    if ctx is not None:
        shape[0] *= ctx.dp
    cut = tp_dim is not None and ctx is not None and ctx.tp > 1
    if cut:
        tp_dim %= x.dim()
        shape[tp_dim] *= ctx.tp
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    if ctx is not None:
        B = x.shape[0]
        keep = keep[ctx.dp_index * B:(ctx.dp_index + 1) * B]
    if cut:
        n = x.shape[tp_dim]
        keep = keep.narrow(tp_dim, ctx.tp_index * n, n)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bucketed relative positions (HF T5 semantics), int32."""
    rp = relative_position.to(torch.int32)
    ret = torch.zeros_like(rp)
    n = -rp
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.clamp_min(1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_bias_table: torch.Tensor,
                          q_len: int, k_len: int,
                          bidirectional: bool,
                          num_buckets: int, max_distance: int,
                          q_offset: int = 0) -> torch.Tensor:
    """[1, heads, q_len, k_len] relative attention bias."""
    dev = rel_bias_table.device
    ctx = torch.arange(q_len, device=dev)[:, None] + q_offset
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional,
                                       num_buckets, max_distance)
    values = rel_bias_table[buckets.long()]                 # [q, k, heads]
    return values.permute(2, 0, 1)[None]                    # [1, h, q, k]


def attention_scores_bias(mask: Optional[torch.Tensor],
                          position_bias: Optional[torch.Tensor],
                          dtype=torch.float32) -> Optional[torch.Tensor]:
    """Padding/causal mask (1 = attend) and position bias as one additive
    f32 term."""
    bias = None
    if position_bias is not None:
        bias = position_bias.to(dtype)
    if mask is not None:
        add = (1.0 - mask.to(dtype)) * NEG_INF
        bias = add if bias is None else bias + add
    return bias


def _merged_weight(ws, dt) -> torch.Tensor:
    """The projection weights ``ws`` ([D, H·dk] each, f32 masters)
    concatenated along their outputs and cast to ``dt``, per call as in
    JAX: autograd splits the gradient back onto each leaf, and the
    parameter tree keeps its separate ``wq``/``wk``/``wv`` leaves."""
    return torch.cat(list(ws), dim=1).to(dt)


def qkv_proj_merged_flat(p: Params, h: torch.Tensor) -> torch.Tensor:
    """Self-attention q|k|v as ONE GEMM → [B, L, 3·H·dk] (the buffer the
    fused kernels take as strided views)."""
    return h @ _merged_weight((p["wq"], p["wk"], p["wv"]), h.dtype)


def kv_proj_merged_flat(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Cross-attention k|v as one GEMM → [B, S, 2·H·dk]."""
    return x @ _merged_weight((p["wk"], p["wv"]), x.dtype)


def _split_heads(flat: torch.Tensor, n: int, num_heads: int, d_kv: int):
    """n equal column slices of [B, L, n·H·dk] as [B, L, H, dk] views."""
    B, L, _ = flat.shape
    inner = num_heads * d_kv
    return tuple(flat[..., i * inner:(i + 1) * inner].reshape(
        B, L, num_heads, d_kv) for i in range(n))


def qkv_proj_merged(p: Params, h: torch.Tensor, num_heads: int, d_kv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counterpart of JAX ``t5.qkv_proj_merged``: self-attention q/k/v as
    one [D, 3·H·dk] GEMM, returned as three [B,L,H,dk] views of its
    output. The parameter layout is unchanged."""
    return _split_heads(qkv_proj_merged_flat(p, h), 3, num_heads, d_kv)


def kv_proj_merged(p: Params, x: torch.Tensor, num_heads: int, d_kv: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of JAX ``t5.kv_proj_merged``: cross-attention k/v as
    one [D, 2·H·dk] GEMM → two [B,S,H,dk] views."""
    return _split_heads(kv_proj_merged_flat(p, x), 2, num_heads, d_kv)


def cross_kv_fold_all(p: Params, n_layers: int, x: torch.Tensor,
                      num_heads: int, d_kv: int
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Counterpart of JAX ``t5.cross_kv_fold_all``: every decoder layer's
    cross-attention k/v of the (layer-invariant) encoder states as ONE
    [D, n·2·H·dk] GEMM. ``p`` is the decoder stack's parameters; → per
    layer (k, v), [B,S,H,dk] views of the one output."""
    w = _merged_weight([p[f"block_{i}"]["cross_attn"][n]
                        for i in range(n_layers) for n in ("wk", "wv")],
                       x.dtype)
    kv = _split_heads(x @ w, 2 * n_layers, num_heads, d_kv)
    return [(kv[2 * i], kv[2 * i + 1]) for i in range(n_layers)]


def multihead_attention(p: Params,
                        q_in: torch.Tensor,
                        k_in: Optional[torch.Tensor],
                        v_in: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor],
                        num_heads: int,
                        d_kv: int,
                        kv_proj: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        mask_add: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        merged: bool = False,
                        ) -> torch.Tensor:
    """Unscaled T5 attention. q_in [B,Lq,D]; k_in/v_in [B,Lk,D], or
    ``kv_proj`` = already projected (k, v) [B,Lk,H,dk]. ``bias`` and
    ``mask_add`` are additive f32 terms broadcast to [B,H,Lq,Lk]. With a
    ``generator`` the f32 attention weights take dropout. ``merged`` runs
    the q/k/v (self) or k/v (cross) projections as one GEMM, as JAX."""
    B, Lq, _ = q_in.shape
    dt = q_in.dtype
    if merged and kv_proj is None and q_in is k_in:
        q, k, v = qkv_proj_merged(p, q_in, num_heads, d_kv)
    else:
        q = (q_in @ p["wq"].to(dt)).reshape(B, Lq, num_heads, d_kv)
        if kv_proj is not None:
            k, v = kv_proj
        elif merged and k_in is v_in:
            k, v = kv_proj_merged(p, k_in, num_heads, d_kv)
        else:
            Lk = k_in.shape[1]
            k = (k_in @ p["wk"].to(dt)).reshape(B, Lk, num_heads, d_kv)
            v = (v_in @ p["wv"].to(dt)).reshape(B, Lk, num_heads, d_kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias
    if mask_add is not None:
        scores = scores + mask_add
    w = torch.softmax(scores, dim=-1)
    w = dropout(w, dropout_rate, generator, tp_dim=1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(dt)
    return out.reshape(B, Lq, num_heads * d_kv) @ p["wo"].to(dt)


def mlp_apply(p: Params, x: torch.Tensor, activation: str,
              dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if activation == "relu":
        h = torch.relu(h)
    elif activation in ("gelu", "gated-gelu"):
        h = torch.nn.functional.gelu(h)
    else:
        raise ValueError(activation)
    h = dropout(h, dropout_rate, generator, tp_dim=-1)
    return h @ p["wo"].to(dt)


# the matrix products whose outputs remat="dots" keeps (as
# jax.checkpoint_policies.dots_saveable keeps dot_general outputs);
# ``x @ W`` and einsum reach the dispatcher as these
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _dots_contexts():
    """Selective checkpointing that saves the outputs of ``_DOT_OPS`` and
    recomputes every other op."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(list(_DOT_OPS))


def maybe_checkpoint(fn, remat, generator: Optional[torch.Generator]):
    """Counterpart of JAX ``t5._maybe_checkpoint``. ``remat``: False runs
    ``fn`` as it is; True or "full" recomputes the whole block in the
    backward pass (``torch.utils.checkpoint``, non-reentrant); "dots"
    keeps the matrix products' outputs and recomputes the rest (the
    layer norms, the softmax, dropout, the residuals, and the fused
    attention's forward kernel, which is not a matrix product to the
    dispatcher).

    The recompute replays the block's dropout: ``torch.utils.checkpoint``
    restores only the default generators, so the wrapper rewinds
    ``generator`` to its state at the block's forward before the
    recompute and puts it back afterwards. The run leaves the generator
    where a run without remat leaves it. The fused attention's Philox
    seeds are tensor inputs of the block and replay as they are."""
    if not remat:
        return fn
    if remat not in (True, "full", "dots"):
        raise ValueError(f"remat must be False, True, 'full' or 'dots', "
                         f"got {remat!r}")
    from torch.utils.checkpoint import checkpoint, noop_context_fn

    context_fn = _dots_contexts if remat == "dots" else noop_context_fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        body = fn
        if generator is not None:
            start = generator.get_state()
            calls = [0]

            def body(*a):
                calls[0] += 1
                if calls[0] == 1:
                    return fn(*a)
                after = generator.get_state()
                generator.set_state(start)
                try:
                    return fn(*a)
                finally:   # also when the recompute stops early
                    generator.set_state(after)
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)

    return run


def merged_qkv(cfg) -> bool:
    """Whether the blocks merge their projections: only a strict True, as
    JAX reads ``merged_qkv`` ("auto" is resolved by the CL trainer)."""
    return getattr(cfg, "merged_qkv", False) is True


def local_heads(p: Params, cfg) -> int:
    """The heads a block's attention parameters ``p`` hold: all of them,
    or a tensor-parallel rank's ``H / tp``."""
    return p["wq"].shape[1] // cfg.d_kv


def head_slice(bias: Optional[torch.Tensor], dim: int, nh: int
               ) -> Optional[torch.Tensor]:
    """Under tensor parallelism, this rank's ``nh`` heads of a bias over
    all heads (``dim``), after ``copy_to_tp`` of the whole bias so that
    its gradient sums the ranks' heads; the bias itself otherwise."""
    ctx = tp_active()
    if ctx is None or bias is None:
        return bias
    return copy_to_tp(bias).narrow(dim, ctx.tp_index * nh, nh)


def _head0(nh: int) -> int:
    """The first head of this rank's ``nh`` under tensor parallelism."""
    ctx = tp_active()
    return 0 if ctx is None else ctx.tp_index * nh


def encoder_block(p: Params, cfg, x: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  mask_add: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """One encoder block; under tensor parallelism ``encoder_block_tp``'s
    Megatron block (``bias`` then carries the local heads)."""
    rate = cfg.dropout_rate
    h = copy_to_tp(layer_norm(p["ln1"], x, cfg.layer_norm_epsilon))
    a = multihead_attention(p["attn"], h, h, h, bias,
                            local_heads(p["attn"], cfg), cfg.d_kv,
                            mask_add=mask_add, dropout_rate=rate,
                            generator=generator, merged=merged_qkv(cfg))
    x = x + dropout(reduce_from_tp(a), rate, generator)
    h = copy_to_tp(layer_norm(p["ln2"], x, cfg.layer_norm_epsilon))
    m = mlp_apply(p["mlp"], h, cfg.feed_forward_proj, rate, generator)
    return x + dropout(reduce_from_tp(m), rate, generator)


def _require_tp(name: str) -> None:
    if tp_active() is None:
        raise ValueError(f"{name} runs under an active mesh with tp > 1 "
                         f"(parallel.mesh.data_parallel)")


def encoder_block_tp(p: Params, cfg, x: torch.Tensor,
                     bias_local: Optional[torch.Tensor],
                     mask_add: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Counterpart of JAX ``t5.encoder_block_tp``: ``encoder_block`` with
    Megatron tensor parallelism over the active mesh's tp group. ``p``
    holds this rank's slices (wq/wk/wv/wi by output, wo by input),
    ``bias_local`` only the local heads (``head_slice``); the attention
    and MLP outputs are summed over tp (``reduce_from_tp``) before each
    residual add, so ``x`` stays replicated over the group. Raises
    ValueError outside such a mesh."""
    _require_tp("encoder_block_tp")
    return encoder_block(p, cfg, x, bias_local, mask_add, generator)


def encoder_block_fused(p: Params, cfg, x: torch.Tensor,
                        pos_bias: torch.Tensor, mask: torch.Tensor,
                        seed: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """``encoder_block`` with the attention core in
    ``ops.fused_attention`` (the CUDA kernels on CUDA tensors).
    pos_bias [H,L,L] f32 for the first L positions, mask [B,S], seed
    int32 [1] (the layer's attention-dropout stream). With ``merged_qkv``
    the kernels take q, k and v as strided views of the one merged
    projection output. Under tensor parallelism the block is Megatron's
    (``encoder_block_tp``) over the local heads: ``pos_bias`` holds them,
    and the kernels take the rank's Philox heads (Hc = H, h0)."""
    from vqacl_tpu_torch.ops.fused_attention import (
        fused_encoder_attention, fused_encoder_attention_merged)

    rate = cfg.dropout_rate
    attn_rate = 0.0 if generator is None else rate
    h = copy_to_tp(layer_norm(p["ln1"], x, cfg.layer_norm_epsilon))
    dt = h.dtype
    B, S, _ = h.shape
    a = p["attn"]
    nh = local_heads(a, cfg)
    streams = dict(bh0=row_offset(B) * cfg.num_heads, Hc=cfg.num_heads,
                   h0=_head0(nh))
    if merged_qkv(cfg):
        o = fused_encoder_attention_merged(
            qkv_proj_merged_flat(a, h), pos_bias, mask, nh,
            dropout_rate=attn_rate, seed=seed, **streams)
    else:
        q = (h @ a["wq"].to(dt)).reshape(B, S, nh, cfg.d_kv)
        k = (h @ a["wk"].to(dt)).reshape(B, S, nh, cfg.d_kv)
        v = (h @ a["wv"].to(dt)).reshape(B, S, nh, cfg.d_kv)
        o = fused_encoder_attention(q, k, v, pos_bias, mask,
                                    dropout_rate=attn_rate, seed=seed,
                                    **streams)
    x = x + dropout(reduce_from_tp(o @ a["wo"].to(dt)), rate, generator)
    h = copy_to_tp(layer_norm(p["ln2"], x, cfg.layer_norm_epsilon))
    m = mlp_apply(p["mlp"], h, cfg.feed_forward_proj, rate, generator)
    return x + dropout(reduce_from_tp(m), rate, generator)


def _layer_seeds(n: int, generator: Optional[torch.Generator]
                 ) -> Optional[torch.Tensor]:
    """n int32 dropout seeds for the fused attention, drawn from
    ``generator`` on its device (no host round trip); None without a
    generator. Every data-parallel rank draws the same seeds: the ranks
    differ by the kernels' Philox row offset, not by seed."""
    if generator is None:
        return None
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=generator,
                         dtype=torch.int32, device=generator.device)


def encoder_stack(p: Params, cfg, inputs_embeds: torch.Tensor,
                  position_bias: Optional[torch.Tensor],
                  fused: Optional[Dict[str, Any]] = None,
                  mask_add: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  remat=False) -> torch.Tensor:
    """Encoder over precomputed embeddings.

    Unfused: ``position_bias`` [1,H,S,S] and the padding mask
    ``mask_add`` [B,1,1,S] are additive terms. Fused (``fused`` dict with
    ``pos_bias`` [H,L,L] and ``mask`` [B,S]): attention runs in
    ``ops.fused_attention``, each layer with its own dropout seed drawn
    from ``generator`` on its device (no host round trip). ``remat``:
    see ``maybe_checkpoint``."""
    rate = cfg.dropout_rate
    x = dropout(inputs_embeds, rate, generator)
    nh = local_heads(p["block_0"]["attn"], cfg)
    if fused is not None:
        seeds = _layer_seeds(cfg.num_layers, generator)
        pos_bias = head_slice(fused["pos_bias"], 0, nh)
        pos_bias = None if pos_bias is None else pos_bias.contiguous()
        block_fn = maybe_checkpoint(encoder_block_fused, remat, generator)
        for i in range(cfg.num_layers):
            x = block_fn(
                p[f"block_{i}"], cfg, x, pos_bias, fused["mask"],
                None if seeds is None else seeds[i:i + 1], generator)
    else:
        bias = head_slice(position_bias, 1, nh)
        block_fn = maybe_checkpoint(encoder_block, remat, generator)
        for i in range(cfg.num_layers):
            x = block_fn(p[f"block_{i}"], cfg, x, bias, mask_add,
                         generator)
    x = layer_norm(p["final_ln"], x, cfg.layer_norm_epsilon)
    return dropout(x, rate, generator)


def decoder_block(p: Params, cfg, x: torch.Tensor,
                  self_bias: Optional[torch.Tensor],
                  enc_states: torch.Tensor,
                  cross_bias: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  cross_kv: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Teacher-forced decoder block: causal self-attention (``self_bias``
    [·,H,T,T] holds the causal mask and the relative bias), cross-
    attention to the encoder (``cross_bias`` [B,1,1,S]; ``cross_kv``: its
    k/v already projected, as ``folded_cross_kv`` gives them), MLP.
    Under tensor parallelism ``decoder_block_tp``'s Megatron block:
    ``self_bias`` then carries the local heads, and ``enc_states`` have
    passed ``copy_to_tp`` (the stack does both)."""
    rate = cfg.dropout_rate
    merged = merged_qkv(cfg)
    nh = local_heads(p["attn"], cfg)
    h = copy_to_tp(layer_norm(p["ln1"], x, cfg.layer_norm_epsilon))
    a = multihead_attention(p["attn"], h, h, h, self_bias, nh,
                            cfg.d_kv, dropout_rate=rate, generator=generator,
                            merged=merged)
    x = x + dropout(reduce_from_tp(a), rate, generator)
    h = copy_to_tp(layer_norm(p["ln2"], x, cfg.layer_norm_epsilon))
    c = multihead_attention(p["cross_attn"], h, enc_states, enc_states,
                            cross_bias, nh, cfg.d_kv,
                            kv_proj=cross_kv, dropout_rate=rate,
                            generator=generator, merged=merged)
    x = x + dropout(reduce_from_tp(c), rate, generator)
    h = copy_to_tp(layer_norm(p["ln3"], x, cfg.layer_norm_epsilon))
    m = mlp_apply(p["mlp"], h, cfg.feed_forward_proj, rate, generator)
    return x + dropout(reduce_from_tp(m), rate, generator)


def decoder_block_tp(p: Params, cfg, x: torch.Tensor,
                     self_bias_local: Optional[torch.Tensor],
                     enc_states: torch.Tensor,
                     cross_bias: Optional[torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     cross_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Counterpart of JAX ``t5.decoder_block_tp``: ``decoder_block`` under
    Megatron tensor parallelism (see ``encoder_block_tp``); the cross
    bias [B,1,1,S] broadcasts over heads, so only the self bias is cut to
    the local heads. ``enc_states`` must have passed ``copy_to_tp``.
    Raises ValueError outside a tp mesh."""
    _require_tp("decoder_block_tp")
    return decoder_block(p, cfg, x, self_bias_local, enc_states, cross_bias,
                         generator, cross_kv)


def decoder_block_fused(p: Params, cfg, x: torch.Tensor,
                        self_bias: torch.Tensor, enc_states: torch.Tensor,
                        enc_mask: torch.Tensor,
                        seeds: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """``decoder_block`` with both attention cores in
    ``ops.fused_attention`` (the CUDA kernels on CUDA tensors).
    ``self_bias`` [H,T,T] f32 is the whole causal + relative bias (one
    for every batch row: the train path has no decoder padding mask);
    the cross-attention is bias-free, masked by ``enc_mask`` [B,S].
    ``seeds`` int32 [2]: the self- and cross-attention dropout streams.
    With ``merged_qkv`` the self q/k/v and the cross k/v come from one
    GEMM each and reach the kernels as strided views. Under tensor
    parallelism the block is ``decoder_block_tp``'s over the local heads
    (``self_bias`` holds them; the kernels take the rank's Philox heads)."""
    from vqacl_tpu_torch.ops.fused_attention import (
        fused_cross_attention, fused_cross_attention_merged,
        fused_encoder_attention, fused_encoder_attention_merged)

    rate = cfg.dropout_rate
    attn_rate = 0.0 if generator is None else rate
    merged = merged_qkv(cfg)
    H, dkv = local_heads(p["attn"], cfg), cfg.d_kv
    B, T, _ = x.shape
    streams = dict(bh0=row_offset(B) * cfg.num_heads, Hc=cfg.num_heads,
                   h0=_head0(H))
    dt = x.dtype
    s_self = None if seeds is None else seeds[0:1]
    s_cross = None if seeds is None else seeds[1:2]

    h = copy_to_tp(layer_norm(p["ln1"], x, cfg.layer_norm_epsilon))
    a = p["attn"]
    ones = torch.ones((B, T), dtype=torch.float32, device=x.device)
    if merged:
        o = fused_encoder_attention_merged(
            qkv_proj_merged_flat(a, h), self_bias, ones, H,
            dropout_rate=attn_rate, seed=s_self, **streams)
    else:
        q = (h @ a["wq"].to(dt)).reshape(B, T, H, dkv)
        k = (h @ a["wk"].to(dt)).reshape(B, T, H, dkv)
        v = (h @ a["wv"].to(dt)).reshape(B, T, H, dkv)
        o = fused_encoder_attention(q, k, v, self_bias, ones,
                                    dropout_rate=attn_rate, seed=s_self,
                                    **streams)
    x = x + dropout(reduce_from_tp(o @ a["wo"].to(dt)), rate, generator)

    h = copy_to_tp(layer_norm(p["ln2"], x, cfg.layer_norm_epsilon))
    c = p["cross_attn"]
    S = enc_states.shape[1]
    qc = (h @ c["wq"].to(dt)).reshape(B, T, H, dkv)
    if merged:
        oc = fused_cross_attention_merged(
            qc, kv_proj_merged_flat(c, enc_states), enc_mask,
            dropout_rate=attn_rate, seed=s_cross, **streams)
    else:
        kc = (enc_states @ c["wk"].to(dt)).reshape(B, S, H, dkv)
        vc = (enc_states @ c["wv"].to(dt)).reshape(B, S, H, dkv)
        oc = fused_cross_attention(qc, kc, vc, enc_mask,
                                   dropout_rate=attn_rate, seed=s_cross,
                                   **streams)
    x = x + dropout(reduce_from_tp(oc @ c["wo"].to(dt)), rate, generator)

    h = copy_to_tp(layer_norm(p["ln3"], x, cfg.layer_norm_epsilon))
    m = mlp_apply(p["mlp"], h, cfg.feed_forward_proj, rate, generator)
    return x + dropout(reduce_from_tp(m), rate, generator)


def decoder_stack(p: Params, cfg, inputs_embeds: torch.Tensor,
                  enc_states: torch.Tensor,
                  enc_mask: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  fused: bool = False, remat=False) -> torch.Tensor:
    """Teacher-forced decoder with no decoder padding mask, as the train
    path runs it. inputs_embeds [B,T,D]; enc_mask [B,S].

    ``fused`` (taken when there is an ``enc_mask``, as in JAX): both
    attention cores run in ``ops.fused_attention``, the self-attention
    with the causal + relative bias [H,T,T] as a bias block covering
    every position, the cross-attention bias-free; each layer draws two
    dropout seeds. ``remat``: see ``maybe_checkpoint``. Unfused, with
    ``folded_cross_kv``, every layer's cross k/v come from one GEMM
    (``cross_kv_fold_all``), as in JAX; the fused branch projects them
    per block, as JAX's does."""
    T = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    pb = compute_position_bias(p["rel_bias"], T, T, bidirectional=False,
                               num_buckets=cfg.relative_attention_num_buckets,
                               max_distance=cfg.relative_attention_max_distance)
    rate = cfg.dropout_rate
    x = dropout(inputs_embeds, rate, generator)
    n = cfg.num_decoder_layers
    nh = local_heads(p["block_0"]["attn"], cfg)
    # every layer's cross k/v read the encoder states: one all_reduce of
    # their gradient over tp serves them all
    enc_states = copy_to_tp(enc_states)
    if fused and enc_mask is not None:
        causal_add = (1.0 - causal_mask(T, dev)[0, 0]) * NEG_INF
        self_bias_full = head_slice(pb[0].float() + causal_add[None], 0,
                                    nh).contiguous()
        seeds = _layer_seeds(2 * n, generator)
        block_fn = maybe_checkpoint(decoder_block_fused, remat, generator)
        for i in range(n):
            x = block_fn(p[f"block_{i}"], cfg, x, self_bias_full, enc_states,
                         enc_mask, None if seeds is None
                         else seeds[2 * i:2 * i + 2], generator)
    else:
        self_bias = head_slice(
            attention_scores_bias(causal_mask(T, dev), pb), 1, nh)
        cross_mask = None if enc_mask is None else enc_mask[:, None, None, :]
        cross_bias = attention_scores_bias(cross_mask, None)
        cross_kvs = [None] * n
        if getattr(cfg, "folded_cross_kv", False) is True:
            cross_kvs = cross_kv_fold_all(p, n, enc_states, nh, cfg.d_kv)
        block_fn = maybe_checkpoint(decoder_block, remat, generator)
        for i in range(n):
            x = block_fn(p[f"block_{i}"], cfg, x, self_bias, enc_states,
                         cross_bias, generator, cross_kvs[i])
    x = layer_norm(p["final_ln"], x, cfg.layer_norm_epsilon)
    return dropout(x, rate, generator)


def causal_mask(L: int, device=None) -> torch.Tensor:
    """[1,1,L,L] lower-triangular attend mask."""
    return torch.tril(torch.ones((L, L), dtype=torch.float32,
                                 device=device))[None, None]


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_token_id: int) -> torch.Tensor:
    """HF ``_shift_right``: prepend the start token, drop the last, and
    replace -100 with pad."""
    start = torch.full_like(labels[:, :1], decoder_start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id),
                       shifted)


def embed_tokens(shared: torch.Tensor, ids: torch.Tensor, dtype
                 ) -> torch.Tensor:
    """Gather, then cast (never casts the whole table)."""
    return shared[ids.long()].to(dtype)


def lm_logits(shared: torch.Tensor, hidden: torch.Tensor, d_model: int,
              tie_word_embeddings: bool = True,
              head_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied LM head with the mesh-tf rescale → f32 logits [..., V].

    The rescale multiplies in the compute dtype (the scalar rounded to
    it first, as JAX's weakly typed scalar is); the product with the
    table accumulates in f32. ``head_f32`` is ``shared`` already cast to
    the compute dtype and back to f32, for callers that apply the head
    many times."""
    h = hidden
    if tie_word_embeddings:
        h = h * torch.tensor(d_model ** -0.5, dtype=h.dtype, device=h.device)
    if head_f32 is None:
        head_f32 = shared.to(h.dtype).float()
    return h.float() @ head_f32.t()
