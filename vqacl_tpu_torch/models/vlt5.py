"""VL-T5 joint text+vision encoder and prototype retrieval for serving.

Counterpart of ``vqacl_tpu/models/vlt5.py``, cut to the serving path:

  ``init_vlt5_params``          seeded random init (numpy), the JAX pytree's keys
  ``cast_params_for_inference`` pre-cast the matmul weights once
  ``joint_pos_bias``            text-text-only relative bias
  ``encode``                    text‖visual joint encoding
  ``augment``                   retrieval-only prototype concat
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models import t5
from vqacl_tpu_torch.models.prototype import ProtoState, cosine_retrieve
from vqacl_tpu_torch.models.visual_embedding import apply_visual_embedding
from vqacl_tpu_torch.utils.device import resolve_device

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
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint encoder → (hidden [B, L+N, D], enc_mask [B, L+N] f32).

    With ``cfg.fused_attention`` the attention runs in
    ``ops.fused_attention`` with the relative bias of the text-text block
    only (the rest of the joint bias is zero, so it never moves);
    otherwise the full [1,H,S,S] bias and a [B,1,1,S] mask are added."""
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

    if cfg.fused_attention:
        text_bias = t5.compute_position_bias(
            params["encoder"]["rel_bias"], L, L, bidirectional=True,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)[0]  # [H,L,L]
        fused = {"pos_bias": text_bias.contiguous(), "mask": enc_mask}
        hidden = t5.encoder_stack(params["encoder"], cfg, inputs, None,
                                  fused=fused)
    else:
        pos_bias = joint_pos_bias(params, cfg, L, N)
        mask_add = t5.attention_scores_bias(enc_mask[:, None, None, :], None)
        hidden = t5.encoder_stack(params["encoder"], cfg, inputs, pos_bias,
                                  mask_add=mask_add)
    return hidden, enc_mask


def augment(cfg, hidden: torch.Tensor, enc_mask: torch.Tensor,
            proto_state: ProtoState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval-only prototype augmentation: mean-pool the text (first
    L positions, pads included) and visual positions, retrieve the
    nearest Q and V prototypes, and append them (detached) as two more
    encoder positions. → (hidden_aug [B, S+2, D], enc_mask_aug [B, S+2])."""
    L = cfg.max_text_length
    pooled_q = hidden[:, :L, :].float().mean(dim=1)             # [B,D]
    pooled_v = hidden[:, L:, :].float().mean(dim=1)             # [B,D]
    q_vec, _, _ = cosine_retrieve(proto_state.q_proto, pooled_q)
    v_vec, _, _ = cosine_retrieve(proto_state.v_proto, pooled_v)
    q_vec = q_vec.detach().to(hidden.dtype)[:, None, :]
    v_vec = v_vec.detach().to(hidden.dtype)[:, None, :]
    hidden_aug = torch.cat([hidden, q_vec, v_vec], dim=1)
    B = hidden.shape[0]
    mask_aug = torch.cat(
        [enc_mask, torch.ones((B, 2), dtype=enc_mask.dtype,
                              device=enc_mask.device)], dim=1)
    return hidden_aug, mask_aug
