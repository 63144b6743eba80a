"""Greedy autoregressive decoding (counterpart of
``vqacl_tpu/models/generate.py::greedy_decode``).

The encoder runs once and prototype retrieval is done before the loop;
each decoder layer's cross-attention K/V are projected once; the
self-attention K/V cache is preallocated for all steps and written in
place, one position per step. EOS handling follows HF greedy search:
once a row emits EOS every later position is pad, and the loop stops as
soon as every row has finished (one host check per step).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from vqacl_tpu_torch.models import t5

Params = Dict[str, Any]


def _precompute_cross_kv(params: Params, cfg, enc_states: torch.Tensor
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross-attention K/V of the encoder states,
    once. enc_states [B,S,D] → per layer ([B,S,H,dk], [B,S,H,dk])."""
    dt = enc_states.dtype
    B, S, _ = enc_states.shape
    out = []
    for i in range(cfg.num_decoder_layers):
        p = params["decoder"][f"block_{i}"]["cross_attn"]
        k = (enc_states @ p["wk"].to(dt)).reshape(B, S, cfg.num_heads,
                                                  cfg.d_kv)
        v = (enc_states @ p["wv"].to(dt)).reshape(B, S, cfg.num_heads,
                                                  cfg.d_kv)
        out.append((k, v))
    return out


def _decoder_step(params: Params, cfg, x: torch.Tensor, t: int,
                  cache: List[Tuple[torch.Tensor, torch.Tensor]],
                  self_bias_row: torch.Tensor,
                  cross_kv: List[Tuple[torch.Tensor, torch.Tensor]],
                  cross_bias: torch.Tensor) -> torch.Tensor:
    """One decoder step over all layers. x [B,1,D] is the current token's
    embedding; ``cache`` holds per-layer (k, v) [B,T,H,dk] and position t
    is written in place; self_bias_row [1,H,1,T] is the causal+relative
    bias of query position t. → hidden [B,1,D]."""
    B = x.shape[0]
    dt = x.dtype
    H, dk = cfg.num_heads, cfg.d_kv
    for i in range(cfg.num_decoder_layers):
        p = params["decoder"][f"block_{i}"]
        h = t5.layer_norm(p["ln1"], x, cfg.layer_norm_epsilon)
        ck, cv = cache[i]
        ck[:, t] = (h @ p["attn"]["wk"].to(dt)).reshape(B, H, dk)
        cv[:, t] = (h @ p["attn"]["wv"].to(dt)).reshape(B, H, dk)
        x = x + t5.multihead_attention(p["attn"], h, None, None,
                                       self_bias_row, H, dk, kv_proj=(ck, cv))
        h = t5.layer_norm(p["ln2"], x, cfg.layer_norm_epsilon)
        x = x + t5.multihead_attention(p["cross_attn"], h, None, None,
                                       cross_bias, H, dk, kv_proj=cross_kv[i])
        h = t5.layer_norm(p["ln3"], x, cfg.layer_norm_epsilon)
        x = x + t5.mlp_apply(p["mlp"], h, cfg.feed_forward_proj)
    return t5.layer_norm(params["decoder"]["final_ln"], x,
                         cfg.layer_norm_epsilon)


def greedy_decode(params: Params, cfg, enc_states: torch.Tensor,
                  enc_mask: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy generation → int32 token ids [B, gen_max_length-1] (without
    the decoder start token), zero-filled after the loop stops."""
    T = cfg.gen_max_length - 1  # steps after the start token
    B = enc_states.shape[0]
    dev = enc_states.device
    enc_states = enc_states.to(dtype)
    cross_kv = _precompute_cross_kv(params, cfg, enc_states)
    cross_bias = t5.attention_scores_bias(enc_mask[:, None, None, :], None)

    pb = t5.compute_position_bias(
        params["decoder"]["rel_bias"], T, T, bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    full_bias = t5.attention_scores_bias(t5.causal_mask(T, dev), pb)  # [1,H,T,T]
    head_f32 = params["shared"].to(dtype).float()

    cache = [(torch.zeros((B, T, cfg.num_heads, cfg.d_kv), dtype=dtype,
                          device=dev),
              torch.zeros((B, T, cfg.num_heads, cfg.d_kv), dtype=dtype,
                          device=dev))
             for _ in range(cfg.num_decoder_layers)]
    tok = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int32,
                     device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in range(T):
        if bool(finished.all()):
            break
        x = t5.embed_tokens(params["shared"], tok[:, None], dtype)  # [B,1,D]
        h = _decoder_step(params, cfg, x, t, cache,
                          full_bias[:, :, t:t + 1, :], cross_kv, cross_bias)
        logits = t5.lm_logits(params["shared"], h, cfg.d_model,
                              cfg.tie_word_embeddings,
                              head_f32=head_f32)[:, 0]            # [B,V]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        tokens[:, t] = nxt
        tok = nxt
    return tokens
