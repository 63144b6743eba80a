"""VL-T5: joint text+vision T5 encoder-decoder with prototype augmentation.

Counterpart of ``vqacl_tpu/models/vlt5.py``, cut to the serving and
training paths:

  ``init_vlt5_params``          seeded random init (numpy), the JAX pytree's keys
  ``cast_params_for_inference`` pre-cast the matmul weights once
  ``joint_pos_bias``            text-text-only relative bias
  ``encode``                    text‖visual joint encoding
  ``augment``                   prototype EMA update + retrieval + concat
  ``decode_hidden``/``decode_train``  teacher-forced decoder (+ LM head),
                                fused with ``cfg.fused_decoder``
  ``fused_head_loss``           tied LM head + weighted CE as one
                                ``autograd.Function``
  ``forward_train``             the train-time forward → loss, new
                                prototype state, aux metrics
  ``init_classifier_head``, ``classifier_logits``, ``classifier_bce_loss``
                                the answer-classification head
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models import t5
from vqacl_tpu_torch.models.prototype import (ProtoState, batch_class_means,
                                              cosine_retrieve, memory_loss,
                                              proto_update)
from vqacl_tpu_torch.models.visual_embedding import apply_visual_embedding
from vqacl_tpu_torch.ops import head_loss as HL
from vqacl_tpu_torch.utils.device import resolve_device
from vqacl_tpu_torch.utils.profiling import count, span

Params = Dict[str, Any]


def _init_numpy(rng: np.random.Generator, cfg) -> Params:
    """The JAX init's shapes and standard deviations (T5 factor 1.0)."""
    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    ones = lambda n: np.ones((n,), np.float32)
    D, H, dk, F = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.d_ff
    inner = H * dk

    def attention():
        return {"wq": normal((D, inner), (D * dk) ** -0.5),
                "wk": normal((D, inner), D ** -0.5),
                "wv": normal((D, inner), D ** -0.5),
                "wo": normal((inner, D), inner ** -0.5)}

    def stack(n, is_decoder):
        p: Params = {}
        for i in range(n):
            blk = {"attn": attention(), "ln1": ones(D),
                   "mlp": {"wi": normal((D, F), D ** -0.5),
                           "wo": normal((F, D), F ** -0.5)},
                   "ln2": ones(D)}
            if is_decoder:
                blk["cross_attn"] = attention()
                blk["ln3"] = ones(D)
            p[f"block_{i}"] = blk
        p["final_ln"] = ones(D)
        p["rel_bias"] = normal((cfg.relative_attention_num_buckets, H),
                               D ** -0.5)
        return p

    vis: Params = {
        "feat_w": normal((cfg.feat_dim, D), cfg.feat_dim ** -0.5),
        "feat_b": np.zeros((D,), np.float32),
        "pos_w": normal((cfg.pos_dim + 1, D), 1.0),
        "pos_b": np.zeros((D,), np.float32),
    }
    if cfg.use_vis_layer_norm and cfg.individual_vis_layer_norm:
        vis["feat_ln"] = ones(D)
        vis["pos_ln"] = ones(D)
    elif cfg.use_vis_layer_norm:
        vis["joint_ln"] = ones(D)
    if cfg.use_vis_order_embedding:
        vis["img_order"] = normal((cfg.n_images, D), 1.0)
    return {
        "shared": normal((cfg.vocab_size, D), 1.0),
        "encoder": stack(cfg.num_layers, False),
        "decoder": stack(cfg.num_decoder_layers, True),
        "visual_embedding": vis,
    }


def init_vlt5_params(seed: int, cfg, device="cuda") -> Params:
    """Random VL-T5 parameters (f32) from a numpy seed, on ``device``.
    Same keys, shapes and init scales as ``vqacl_tpu``'s init; the values
    differ (another generator)."""
    dev = resolve_device(device)
    tree = _init_numpy(np.random.default_rng(seed), cfg)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return torch.from_numpy(node).to(dev)

    return move(tree)


# leaves the compute path consumes in f32 (layer_norm upcasts its weight;
# the relative bias is gathered f32) — pre-casting them would change the
# numbers; every other weight is cast to the compute dtype at its use
_F32_LEAVES = frozenset({
    "ln1", "ln2", "ln3", "final_ln", "rel_bias",
    "feat_ln", "pos_ln", "joint_ln",
    # VL-Moonlight's norms and f32 router (models/moonlight.py)
    "attn_norm", "mlp_norm", "kv_norm", "final_norm", "router",
})


def cast_params_for_inference(params: Params,
                              dtype=torch.bfloat16) -> Params:
    """Cast the matmul weights to the compute dtype once (serving only;
    training keeps f32 master weights). Outputs are the same as casting
    at each use, since ``W.to(dtype)`` of a cast weight is a no-op."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in _F32_LEAVES or not node.is_floating_point():
            return node
        return node.to(dtype)

    return walk(params)


def joint_pos_bias(params: Params, cfg, L: int, V_L: int) -> torch.Tensor:
    """[1, H, L+V_L, L+V_L] f32: T5 relative bias on the text-text block
    only, zeros elsewhere."""
    S = L + V_L
    text_bias = t5.compute_position_bias(
        params["encoder"]["rel_bias"], L, L, bidirectional=True,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)      # [1,H,L,L]
    bias = torch.zeros((1, cfg.num_heads, S, S), dtype=torch.float32,
                       device=text_bias.device)
    bias[:, :, :L, :L] = text_bias.float()
    return bias


def encode(params: Params, cfg,
           input_ids: torch.Tensor,            # [B, L] int
           vis_feats: torch.Tensor,            # [B, N, feat_dim]
           boxes: torch.Tensor,                # [B, N, 4]
           dtype=torch.float32,
           generator: Optional[torch.Generator] = None,
           remat=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint encoder → (hidden [B, L+N, D], enc_mask [B, L+N] f32).

    With ``cfg.fused_attention`` the attention runs in
    ``ops.fused_attention`` with the relative bias of the text-text block
    only (the rest of the joint bias is zero, so it never moves);
    otherwise the full [1,H,S,S] bias and a [B,1,1,S] mask are added.
    A ``generator`` turns dropout on (training); ``remat`` recomputes
    the blocks in the backward pass (``t5.maybe_checkpoint``). With
    ``cfg.pp_mesh`` (a ``MeshContext`` with pp > 1, set by the trainer)
    the stack runs pipelined over its pp group in ``cfg.pp_micro``
    microbatches (``parallel.pipeline.encoder_stack_pp``), as JAX's
    ``encode`` does, with the same choice of fused or unfused
    attention."""
    B, L = input_ids.shape
    N = vis_feats.shape[1]
    # text keys attend unless pad; region keys always attend
    enc_mask = torch.cat([(input_ids != cfg.pad_token_id).float(),
                          torch.ones((B, N), dtype=torch.float32,
                                     device=input_ids.device)], dim=1)

    text_emb = t5.embed_tokens(params["shared"], input_ids, dtype)
    vis_emb = apply_visual_embedding(
        params["visual_embedding"], cfg, params["shared"], vis_feats, boxes,
        dtype=dtype)
    inputs = torch.cat([text_emb, vis_emb], dim=1)              # [B, S, D]

    pp_mesh = getattr(cfg, "pp_mesh", None)
    if cfg.fused_attention:
        text_bias = t5.compute_position_bias(
            params["encoder"]["rel_bias"], L, L, bidirectional=True,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)[0]  # [H,L,L]
        fused = {"pos_bias": text_bias.contiguous(), "mask": enc_mask}
        pos_bias = mask_add = None
    else:
        fused = None
        pos_bias = joint_pos_bias(params, cfg, L, N)
        mask_add = t5.attention_scores_bias(enc_mask[:, None, None, :], None)
    if pp_mesh is not None:
        from vqacl_tpu_torch.parallel.pipeline import encoder_stack_pp

        hidden = encoder_stack_pp(params["encoder"], cfg, inputs, pos_bias,
                                  pp_mesh, getattr(cfg, "pp_micro", 4),
                                  fused=fused, mask_add=mask_add,
                                  generator=generator)
    else:
        hidden = t5.encoder_stack(params["encoder"], cfg, inputs, pos_bias,
                                  fused=fused, mask_add=mask_add,
                                  generator=generator, remat=remat)
    return hidden, enc_mask


class ProtoAux(NamedTuple):
    loss_memory_q: torch.Tensor
    loss_memory_v: torch.Tensor
    retrieval_acc_q: torch.Tensor
    retrieval_acc_v: torch.Tensor

    @staticmethod
    def empty(device) -> "ProtoAux":
        """No memory loss (0) and no retrieval accuracy (-1)."""
        zero = torch.zeros((), dtype=torch.float32, device=device)
        none = torch.full((), -1.0, dtype=torch.float32, device=device)
        return ProtoAux(zero, zero, none, none)


def augment(cfg, hidden: torch.Tensor, enc_mask: torch.Tensor,
            proto_state: ProtoState,
            ques_labels: Optional[torch.Tensor] = None,   # [B, NQ] one-hot
            cate_labels: Optional[torch.Tensor] = None,   # [B, NV] one-hot
            proto_update_flag: bool = False,
            use_memory_loss: bool = False,
            proto_alpha: float = 0.5, proto_beta: float = 0.5,
            ) -> Tuple[torch.Tensor, torch.Tensor, ProtoState, ProtoAux]:
    """Prototype update + retrieval + concat. Mean-pool the text (first
    L positions, pads included) and visual positions; with
    ``proto_update_flag`` update the banks from this batch's class means
    first (and, with ``use_memory_loss``, pull the pooled hiddens toward
    the old banks); retrieve the nearest Q and V prototypes and append
    them (detached) as two more encoder positions.
    → (hidden_aug [B, S+2, D], enc_mask_aug [B, S+2], state, aux)."""
    L = cfg.max_text_length
    pooled_q = hidden[:, :L, :].float().mean(dim=1)             # [B,D]
    pooled_v = hidden[:, L:, :].float().mean(dim=1)             # [B,D]
    dev = hidden.device
    aux = ProtoAux.empty(dev)
    if proto_update_flag:
        if ques_labels is None or cate_labels is None:
            raise ValueError("augment: the prototype update needs labels")
        cur_q, num_q = batch_class_means(pooled_q, ques_labels)
        cur_v, num_v = batch_class_means(pooled_v, cate_labels)
        if use_memory_loss:
            lq, lv = memory_loss(pooled_q, pooled_v, ques_labels,
                                 cate_labels, proto_state)
            aux = aux._replace(loss_memory_q=lq, loss_memory_v=lv)
        proto_state = proto_update(proto_state, cur_q, cur_v, num_q, num_v,
                                   proto_alpha, proto_beta)
        q_vec, _, acc_q = cosine_retrieve(proto_state.q_proto, pooled_q,
                                          ques_labels)
        v_vec, _, acc_v = cosine_retrieve(proto_state.v_proto, pooled_v,
                                          cate_labels)
        aux = aux._replace(retrieval_acc_q=acc_q, retrieval_acc_v=acc_v)
    else:
        q_vec, _, _ = cosine_retrieve(proto_state.q_proto, pooled_q)
        v_vec, _, _ = cosine_retrieve(proto_state.v_proto, pooled_v)
    q_vec = q_vec.detach().to(hidden.dtype)[:, None, :]
    v_vec = v_vec.detach().to(hidden.dtype)[:, None, :]
    hidden_aug = torch.cat([hidden, q_vec, v_vec], dim=1)
    B = hidden.shape[0]
    mask_aug = torch.cat(
        [enc_mask, torch.ones((B, 2), dtype=enc_mask.dtype, device=dev)],
        dim=1)
    return hidden_aug, mask_aug, proto_state, aux


# ---------------------------------------------------------------------------
# teacher-forced decoding and the loss
# ---------------------------------------------------------------------------

def decode_hidden(params: Params, cfg, hidden: torch.Tensor,
                  enc_mask: torch.Tensor, labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  dtype=torch.float32, remat=False) -> torch.Tensor:
    """Teacher-forced decoder states [B, T, D] (before the LM head).
    ``labels`` uses -100 for padding and is shifted right here, as HF
    does. Both attention cores run in ``ops.fused_attention`` when
    ``cfg.fused_attention`` and ``cfg.fused_decoder`` are both set. With
    ``cfg.pp_mesh`` the stack runs pipelined
    (``parallel.pipeline.decoder_stack_pp``), as JAX's does."""
    dec_ids = t5.shift_right(labels, cfg.decoder_start_token_id,
                             cfg.pad_token_id)
    dec_emb = t5.embed_tokens(params["shared"], dec_ids, dtype)
    fused = bool(cfg.fused_attention) and bool(cfg.fused_decoder)
    pp_mesh = getattr(cfg, "pp_mesh", None)
    if pp_mesh is not None:
        from vqacl_tpu_torch.parallel.pipeline import decoder_stack_pp

        return decoder_stack_pp(params["decoder"], cfg, dec_emb, hidden,
                                enc_mask, pp_mesh,
                                getattr(cfg, "pp_micro", 4),
                                generator=generator, fused=fused)
    return t5.decoder_stack(params["decoder"], cfg, dec_emb, hidden, enc_mask,
                            generator=generator, fused=fused, remat=remat)


def decode_train(params: Params, cfg, hidden: torch.Tensor,
                 enc_mask: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, remat=False) -> torch.Tensor:
    """Teacher-forced decode → f32 logits [B, T, vocab]."""
    seq = decode_hidden(params, cfg, hidden, enc_mask, labels,
                        generator=generator, dtype=dtype, remat=remat)
    return t5.lm_logits(params["shared"], seq, cfg.d_model,
                        cfg.tie_word_embeddings)


def _safe_labels(labels: torch.Tensor, vocab: int) -> torch.Tensor:
    return torch.where(labels == -100, 0, labels).clamp(0, vocab - 1).long()


def token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE with ignore_index=-100 → (loss [B,T], mask [B,T])."""
    mask = (labels != -100).float()
    safe = _safe_labels(labels, logits.shape[-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return nll * mask, mask


def weighted_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """Per-token CE → per-sequence mean over non-pad → × per-sample
    answer score → batch mean."""
    nll, mask = token_cross_entropy(logits, labels)
    per_seq = nll.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    return (per_seq * scores.float()).mean()


def _token_weights(labels: torch.Tensor, scores: torch.Tensor
                   ) -> torch.Tensor:
    """d(loss)/d(nll[b,t]) of the weighted loss: mask × score_b /
    (valid_b · B)."""
    mask = (labels != -100).float()
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    return mask * scores.float()[:, None] / (denom * labels.shape[0])


@functools.lru_cache(maxsize=None)
def rounded(x: float, dtype: torch.dtype) -> float:
    """The value of ``torch.tensor(x, dtype=dtype)`` as a Python float. A
    tensor of ``dtype`` times it gives the bits of the tensor times that
    0-dim tensor (both multiply in f32, then round), and no scalar is
    copied to the device."""
    return float(torch.tensor(x, dtype=dtype))


def _head_logits(hidden: torch.Tensor, shared: torch.Tensor,
                 rs: float) -> torch.Tensor:
    """f32 logits of the hidden times ``rs`` against the table cast to the
    hidden's dtype (f32 products of the rounded operands)."""
    h = hidden if rs == 1.0 else hidden * rs
    return h.float() @ shared.to(hidden.dtype).float().t()


def _dscores(g, lse, ll, labels, scores):
    """The real scores cotangent: d/d(score_b) = the per-sequence mean
    NLL / B."""
    mask = (labels != -100).float()
    nll = (lse - ll) * mask
    valid = mask.sum(dim=1).clamp_min(1.0)
    return (g * nll.sum(dim=1) / valid / labels.shape[0]).to(scores.dtype)


# The plain version: f32 [B, T, V] logits, recomputed in the backward.
# Each route's forward takes (hidden, shared, safe labels, the rounded
# rescale) → (lse, label logit, residuals); its backward (residuals, lse,
# per-token weight × g, the rounded rescale) → (dh, dshared). The
# kernels' route is ``ops/head_loss.py::head_loss_forward/_backward``.

def _plain_forward(hidden, shared, safe, rs):
    logits = _head_logits(hidden, shared, rs)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1), ll, (hidden, shared, safe)


def _plain_backward(res, lse, w, rs):
    hidden, shared, safe = res
    logits = _head_logits(hidden, shared, rs)                     # recompute
    p = torch.exp(logits - lse[..., None])
    p.scatter_add_(-1, safe[..., None], -torch.ones_like(lse)[..., None])
    dt = hidden.dtype
    dlogits = (p * w[..., None]).to(dt)
    dh = (dlogits.float() @ shared.to(dt).float()).to(dt)
    hs = hidden
    if rs != 1.0:
        dh, hs = dh * rs, hidden * rs
    dshared = dlogits.float().flatten(0, 1).t() @ hs.float().flatten(0, 1)
    return dh, dshared


class _FusedHeadLoss(torch.autograd.Function):
    """Tied LM head + weighted CE as one op: the logits are recomputed in
    backward, so neither the f32 log-softmax nor f32 d(logits) is kept;
    d(logits) goes into the two gradient products in the hidden's dtype.
    ``ops/head_loss.py::head_loss_route`` picks the route unless ``route``
    names one: the kernels for bf16 on the card, the plain version for CPU
    tensors and f32. With the recorder on, the op is the span
    ``head_loss`` in the forward and again in the backward, and the
    counter ``head_loss.kernel`` or ``head_loss.plain`` counts each
    forward by route."""

    @staticmethod
    def forward(ctx, hidden, shared, labels, scores, rescale, route=None):
        if route is None:
            route = HL.head_loss_route(
                hidden.device.type, hidden.dtype, labels.numel(),
                hidden.shape[-1], shared.shape[0])
        count("head_loss.plain" if route == "plain" else "head_loss.kernel")
        fwd = _plain_forward if route == "plain" else HL.head_loss_forward
        rs = rounded(rescale, hidden.dtype)
        with span("head_loss"):
            safe = _safe_labels(labels, shared.shape[0])
            lse, ll, res = fwd(hidden, shared, safe, rs)
            loss = ((lse - ll) * _token_weights(labels, scores)).sum()
        ctx.save_for_backward(labels, scores, lse, ll, *res)
        ctx.route, ctx.rs = route, rs
        ctx.shared_dtype = shared.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        labels, scores, lse, ll, *res = ctx.saved_tensors
        bwd = (_plain_backward if ctx.route == "plain"
               else HL.head_loss_backward)
        with span("head_loss"):
            w = _token_weights(labels, scores) * g
            dh, dshared = bwd(res, lse, w, ctx.rs)
            dscores = _dscores(g, lse, ll, labels, scores)
        return dh, dshared.to(ctx.shared_dtype), None, dscores, None, None


def fused_head_loss(hidden: torch.Tensor, shared: torch.Tensor,
                    labels: torch.Tensor, scores: torch.Tensor,
                    rescale: float) -> torch.Tensor:
    """``weighted_lm_loss`` of the tied head's logits of ``hidden``
    [B,T,D] (scaled by ``rescale``) against ``labels`` [B,T] (-100 pad),
    weighted by ``scores`` [B]; differentiable in hidden, shared and
    scores."""
    return _FusedHeadLoss.apply(hidden, shared, labels, scores, rescale)


# ---------------------------------------------------------------------------
# classifier head (the working version of the reference's --classifier)
# ---------------------------------------------------------------------------

def init_classifier_head(seed: int, cfg, num_answers: int = 3129,
                         device="cuda") -> Params:
    """Answer-classification head over the top-k answer vocabulary
    (counterpart of JAX ``vlt5.init_classifier_head``): the decoder's
    start-token state → Linear(d, 2d) → GELU → T5 layer norm →
    Linear(2d, A), f32, from a numpy seed on ``device``. Same shapes and
    init scales as JAX's; the values differ (another generator)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def normal(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std)).to(dev)

    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {"fc1_w": normal((d, 2 * d), d ** -0.5),
            "fc1_b": zeros(2 * d),
            "ln": torch.ones((2 * d,), dtype=torch.float32, device=dev),
            "fc2_w": normal((2 * d, num_answers), (2 * d) ** -0.5),
            "fc2_b": zeros(num_answers)}


def classifier_logits(head: Params, cfg, params: Params,
                      hidden: torch.Tensor, enc_mask: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """One decoder step from the start token over the encoder states →
    answer logits [B, A] f32 (the reference test_step's classifier
    branch). The decoder runs unfused and without dropout, as in JAX."""
    B = hidden.shape[0]
    start = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                       device=hidden.device)
    dec_emb = t5.embed_tokens(params["shared"], start, dtype)
    seq = t5.decoder_stack(params["decoder"], cfg, dec_emb, hidden, enc_mask)
    h = seq[:, 0].float()                                       # [B, d]
    x = h @ head["fc1_w"] + head["fc1_b"]
    x = torch.nn.functional.gelu(x, approximate="none")
    x = t5.layer_norm(head["ln"], x, cfg.layer_norm_epsilon)
    return x @ head["fc2_w"] + head["fc2_b"]


def classifier_bce_loss(logits: torch.Tensor, targets: torch.Tensor
                        ) -> torch.Tensor:
    """BCE-with-logits over soft targets, through log-sigmoid so large
    logits stay finite."""
    F = torch.nn.functional
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits)).mean()


# ---------------------------------------------------------------------------
# the train-time forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    loss: torch.Tensor
    proto_state: ProtoState
    aux: ProtoAux


def forward_train(params: Params, cfg, batch: Dict[str, torch.Tensor],
                  proto_state: ProtoState,
                  proto_alpha: float, proto_beta: float,
                  use_prototype: bool = True,
                  use_memory_loss: bool = False,
                  lambda_q: float = 0.0, lambda_v: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  dtype=torch.bfloat16, remat=False) -> ForwardOut:
    """The full training forward. batch: input_ids [B,L], vis_feats
    [B,N,feat_dim], boxes [B,N,4], target_ids [B,T] (-100 padded),
    scores [B], ques_labels [B,NQ], cate_labels [B,NV], all on the
    parameters' device. ``generator`` drives dropout (None: off);
    ``remat`` recomputes the encoder and decoder blocks in the backward
    pass."""
    hidden, enc_mask = encode(params, cfg, batch["input_ids"],
                              batch["vis_feats"], batch["boxes"],
                              dtype=dtype, generator=generator, remat=remat)
    if use_prototype:
        hidden, enc_mask, proto_state, aux = augment(
            cfg, hidden, enc_mask, proto_state,
            ques_labels=batch["ques_labels"],
            cate_labels=batch["cate_labels"], proto_update_flag=True,
            use_memory_loss=use_memory_loss, proto_alpha=proto_alpha,
            proto_beta=proto_beta)
    else:
        aux = ProtoAux.empty(hidden.device)
    seq = decode_hidden(params, cfg, hidden, enc_mask, batch["target_ids"],
                        generator=generator, dtype=dtype, remat=remat)
    rescale = cfg.d_model ** -0.5 if cfg.tie_word_embeddings else 1.0
    loss = fused_head_loss(seq, params["shared"], batch["target_ids"],
                           batch["scores"], rescale)
    if use_memory_loss:
        loss = loss + lambda_q * aux.loss_memory_q \
            + lambda_v * aux.loss_memory_v
    return ForwardOut(loss=loss, proto_state=proto_state, aux=aux)
