"""BART encoder-decoder and its VL-BART variant (counterpart of
``vqacl_tpu/models/bart.py``).

Plain functions on a nested dict of tensors, as ``models/t5.py``;
linear weights in the JAX ``[in, out]`` orientation, applied as
``x @ W + b``. BART specifics kept: learned positions with the +2
offset, post-layer-norm blocks (mean-subtracting LayerNorm with bias, eps
1e-5), ``layernorm_embedding`` after the token + position sum, scaled
dot-product attention (q × d_kv^-0.5) with biased projections, f32
scores and softmax, GELU feed-forward, the tied LM head plus
``final_logits_bias``, and ``shift_tokens_right`` with the decoder
starting from EOS. The VL variant appends the projected region features
(the port's ``visual_embedding``) after the text, as the reference's
joint encoder does.

Attention stays plain matrix products here, as JAX's einsums are: no
Pallas kernel covers BART in the JAX package, so none is ported. A
``generator`` (``torch.Generator`` on the tensors' device) turns dropout
on; ``None`` is the deterministic path. The config is any object with
the fields the functions read (``d_model``, ``num_heads``, ``d_ff``,
``num_layers``, ``num_decoder_layers``, ``vocab_size``,
``max_position_embeddings``, ``pad_token_id``,
``decoder_start_token_id``, ``dropout_rate`` and, for regions, the
visual embedding's).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.models.convert import from_jax_params
from vqacl_tpu_torch.models.t5 import dropout as _dropout
from vqacl_tpu_torch.models.visual_embedding import apply_visual_embedding
from vqacl_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]
NEG_INF = -1e9
POS_OFFSET = 2  # HF BART's learned-position offset


def std_layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5
                   ) -> torch.Tensor:
    """Mean-subtracting LayerNorm with weight and bias, in f32."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(dt)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return x @ p["w"].to(dt) + p["b"].to(dt)


def bart_attention(p: Params, cfg, q_in: torch.Tensor, kv_in: torch.Tensor,
                   mask4: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Scaled multi-head attention; mask4 [B,1,Lq,Lk] (1 = attend)."""
    B, Lq, _ = q_in.shape
    Lk = kv_in.shape[1]
    H = cfg.num_heads
    dk = cfg.d_model // H
    dt = q_in.dtype
    q = (_linear(p["q"], q_in) * (dk ** -0.5)).reshape(B, Lq, H, dk)
    k = _linear(p["k"], kv_in).reshape(B, Lk, H, dk)
    v = _linear(p["v"], kv_in).reshape(B, Lk, H, dk)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask4 is not None:
        s = s + (1.0 - mask4.float()) * NEG_INF
    w = _dropout(torch.softmax(s, dim=-1), cfg.dropout_rate, generator)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(dt).float(), v.float()).to(dt)
    return _linear(p["o"], o.reshape(B, Lq, H * dk))


def _ffn(p: Params, cfg, x: torch.Tensor,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    h = torch.nn.functional.gelu(_linear(p["fc1"], x), approximate="none")
    return _linear(p["fc2"], _dropout(h, cfg.dropout_rate, generator))


def bart_encoder_layer(p: Params, cfg, x: torch.Tensor, mask4,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    rate = cfg.dropout_rate
    a = bart_attention(p["self_attn"], cfg, x, x, mask4, generator)
    x = std_layer_norm(p["self_ln"], x + _dropout(a, rate, generator))
    f = _ffn(p, cfg, x, generator)
    return std_layer_norm(p["final_ln"], x + _dropout(f, rate, generator))


def bart_decoder_layer(p: Params, cfg, x: torch.Tensor, self_mask4,
                       enc: torch.Tensor, cross_mask4,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    rate = cfg.dropout_rate
    a = bart_attention(p["self_attn"], cfg, x, x, self_mask4, generator)
    x = std_layer_norm(p["self_ln"], x + _dropout(a, rate, generator))
    c = bart_attention(p["cross_attn"], cfg, x, enc, cross_mask4, generator)
    x = std_layer_norm(p["cross_ln"], x + _dropout(c, rate, generator))
    f = _ffn(p, cfg, x, generator)
    return std_layer_norm(p["final_ln"], x + _dropout(f, rate, generator))


def init_bart_params(seed: int, cfg, device="cuda") -> Params:
    """Random (VL-)BART parameters (f32) on ``device``, drawn from an
    explicit ``torch.Generator`` seeded with ``seed``: the JAX init's keys,
    shapes and scales (N(0, 0.02) weights, unit layer norms, zero biases;
    the visual embedding as ``vlt5``'s when ``cfg.use_vision``, the
    default). The values differ from JAX's (another generator)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    d = cfg.d_model

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def ln(n):
        return {"w": torch.ones(n), "b": torch.zeros(n)}

    def linear(din, dout):
        return {"w": normal((din, dout), 0.02), "b": torch.zeros(dout)}

    def attention():
        return {n: linear(d, d) for n in ("q", "k", "v", "o")}

    def layer(is_decoder):
        p = {"self_attn": attention(), "self_ln": ln(d),
             "fc1": linear(d, cfg.d_ff), "fc2": linear(cfg.d_ff, d),
             "final_ln": ln(d)}
        if is_decoder:
            p["cross_attn"] = attention()
            p["cross_ln"] = ln(d)
        return p

    n_pos = cfg.max_position_embeddings + POS_OFFSET
    params: Params = {
        "encoder": {f"layer_{i}": layer(False)
                    for i in range(cfg.num_layers)},
        "decoder": {f"layer_{i}": layer(True)
                    for i in range(cfg.num_decoder_layers)},
        "shared": normal((cfg.vocab_size, d), 0.02),
        "enc_pos": normal((n_pos, d), 0.02),
        "dec_pos": normal((n_pos, d), 0.02),
        "enc_ln_emb": ln(d),
        "dec_ln_emb": ln(d),
        "final_logits_bias": torch.zeros(cfg.vocab_size),
    }
    if getattr(cfg, "use_vision", True):
        vis: Params = {
            "feat_w": normal((cfg.feat_dim, d), cfg.feat_dim ** -0.5),
            "feat_b": torch.zeros(d),
            "pos_w": normal((cfg.pos_dim + 1, d), 1.0),
            "pos_b": torch.zeros(d),
        }
        if cfg.use_vis_layer_norm and cfg.individual_vis_layer_norm:
            vis["feat_ln"] = torch.ones(d)
            vis["pos_ln"] = torch.ones(d)
        elif cfg.use_vis_layer_norm:
            vis["joint_ln"] = torch.ones(d)
        if cfg.use_vis_order_embedding:
            vis["img_order"] = normal((cfg.n_images, d), 1.0)
        params["visual_embedding"] = vis

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return node.to(dev)

    return move(params)


def _positions(table: torch.Tensor, n: int, dtype) -> torch.Tensor:
    idx = torch.arange(n, device=table.device) + POS_OFFSET
    return table[idx].to(dtype)


def bart_encode(params: Params, cfg, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                vis_feats: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(VL-)BART encoder → (hidden [B,S,D], enc_mask [B,S] f32). With
    ``vis_feats`` and ``boxes`` the region embeddings follow the text
    and always attend."""
    B, L = input_ids.shape
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).float()
    x = params["shared"][input_ids.long()].to(dtype) \
        + _positions(params["enc_pos"], L, dtype)[None]
    mask = attention_mask.float()
    if vis_feats is not None:
        vis = apply_visual_embedding(params["visual_embedding"], cfg,
                                     params["shared"], vis_feats, boxes,
                                     dtype=dtype)
        x = torch.cat([x, vis], dim=1)
        mask = torch.cat([mask, torch.ones((B, vis.shape[1]),
                                           dtype=mask.dtype,
                                           device=mask.device)], dim=1)
    x = std_layer_norm(params["enc_ln_emb"], x)
    x = _dropout(x, cfg.dropout_rate, generator)
    mask4 = mask[:, None, None, :]
    for i in range(cfg.num_layers):
        x = bart_encoder_layer(params["encoder"][f"layer_{i}"], cfg, x,
                               mask4, generator)
    return x, mask


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """Prepend the start token, drop the last, replace -100 with pad."""
    start = torch.full_like(labels[:, :1], decoder_start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100,
                       torch.full_like(shifted, pad_token_id), shifted)


def bart_decode_train(params: Params, cfg, enc: torch.Tensor,
                      enc_mask: torch.Tensor, labels: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced decoder → f32 logits [B, T, vocab] (the tied head
    plus ``final_logits_bias``); ``labels`` -100 padded."""
    dec_ids = shift_tokens_right(labels, cfg.pad_token_id,
                                 cfg.decoder_start_token_id)
    B, T = dec_ids.shape
    x = params["shared"][dec_ids.long()].to(dtype) \
        + _positions(params["dec_pos"], T, dtype)[None]
    x = std_layer_norm(params["dec_ln_emb"], x)
    x = _dropout(x, cfg.dropout_rate, generator)
    causal = torch.tril(torch.ones((T, T), device=enc.device))[None, None]
    cross4 = enc_mask[:, None, None, :]
    for i in range(cfg.num_decoder_layers):
        x = bart_decoder_layer(params["decoder"][f"layer_{i}"], cfg, x,
                               causal, enc, cross4, generator)
    logits = x.float() @ params["shared"].to(x.dtype).float().t()
    return logits + params["final_logits_bias"].float()


# ---- HF weight import -------------------------------------------------------

def bart_from_state_dict(sd: Mapping[str, Any], cfg) -> Params:
    """An HF ``BartForConditionalGeneration`` state dict (numpy arrays or
    tensors) → the port's BART tree of f32 CPU tensors (no visual
    embedding: HF's checkpoint has none)."""
    def arr(k):
        v = sd[k]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    def t(k):
        return np.ascontiguousarray(arr(k).T)

    def lin(prefix):
        return {"w": t(f"{prefix}.weight"), "b": arr(f"{prefix}.bias")}

    def ln(prefix):
        return {"w": arr(f"{prefix}.weight"), "b": arr(f"{prefix}.bias")}

    def attn(prefix):
        return {"q": lin(f"{prefix}.q_proj"), "k": lin(f"{prefix}.k_proj"),
                "v": lin(f"{prefix}.v_proj"), "o": lin(f"{prefix}.out_proj")}

    def layer(prefix, is_decoder):
        p = {"self_attn": attn(f"{prefix}.self_attn"),
             "self_ln": ln(f"{prefix}.self_attn_layer_norm"),
             "fc1": lin(f"{prefix}.fc1"), "fc2": lin(f"{prefix}.fc2"),
             "final_ln": ln(f"{prefix}.final_layer_norm")}
        if is_decoder:
            p["cross_attn"] = attn(f"{prefix}.encoder_attn")
            p["cross_ln"] = ln(f"{prefix}.encoder_attn_layer_norm")
        return p

    return from_jax_params({
        "shared": arr("model.shared.weight"),
        "enc_pos": arr("model.encoder.embed_positions.weight"),
        "dec_pos": arr("model.decoder.embed_positions.weight"),
        "enc_ln_emb": ln("model.encoder.layernorm_embedding"),
        "dec_ln_emb": ln("model.decoder.layernorm_embedding"),
        "final_logits_bias": arr("final_logits_bias").reshape(-1),
        "encoder": {f"layer_{i}": layer(f"model.encoder.layers.{i}", False)
                    for i in range(cfg.num_layers)},
        "decoder": {f"layer_{i}": layer(f"model.decoder.layers.{i}", True)
                    for i in range(cfg.num_decoder_layers)},
    })
