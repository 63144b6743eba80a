"""Autoregressive decoding: greedy and beam search (counterpart of
``vqacl_tpu/models/generate.py``).

The encoder runs once and prototype retrieval is done before the loop;
each decoder layer's cross-attention K/V are projected once; the
self-attention K/V cache is preallocated for all steps and written in
place, one position per step. EOS handling follows HF greedy search:
once a row emits EOS every later position is pad. ``greedy_decode``
stops as soon as every row has finished (one host check per step)
unless ``early_stop=False``, which runs all steps with no such check.

``beam_search`` is HF ``generate(num_beams=K, do_sample=False,
early_stopping=False)`` in the JAX package's static-shape form: 2K
candidates per item and step, a K-slot pool of finished hypotheses,
items that freeze once done, and a final merge of the open beams. Its
three top-k selections rank as ``jax.lax.top_k`` does (``_top_k``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from vqacl_tpu_torch.models import t5
from vqacl_tpu_torch.ops.topk import top_k

Params = Dict[str, Any]


def _precompute_cross_kv(params: Params, cfg, enc_states: torch.Tensor
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross-attention K/V of the encoder states,
    once. enc_states [B,S,D] → per layer ([B,S,H,dk], [B,S,H,dk]): one
    GEMM for every layer with ``folded_cross_kv``, one per layer with
    ``merged_qkv`` (views of its output), else two per layer, as JAX."""
    if getattr(cfg, "folded_cross_kv", False) is True:
        return t5.cross_kv_fold_all(params["decoder"], cfg.num_decoder_layers,
                                    enc_states, cfg.num_heads, cfg.d_kv)
    dt = enc_states.dtype
    B, S, _ = enc_states.shape
    merged = t5.merged_qkv(cfg)
    out = []
    for i in range(cfg.num_decoder_layers):
        p = params["decoder"][f"block_{i}"]["cross_attn"]
        if merged:
            out.append(t5.kv_proj_merged(p, enc_states, cfg.num_heads,
                                         cfg.d_kv))
            continue
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
        # not merged, as in JAX: the per-step self k/v stay two GEMMs
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




NEG = -1e9  # score of an empty pool slot or a dead beam, as in JAX


# beam search's ties (a dead beam's ``NEG`` every step) rank as in JAX
_top_k = top_k


def _prepare(params: Params, cfg, enc_states: torch.Tensor,
             enc_mask: torch.Tensor, T: int, dtype, repeat: int = 1):
    """What every decode step reads, for ``repeat`` rows per encoder row
    (the beams of one item adjacent): per-layer cross K/V projected once
    per item, the cross bias, the [1,H,T,T] causal+relative self bias and
    the head in f32. → (``step(tok [R] int32, t) -> f32 logits [R,V]``,
    the zeroed per-layer self K/V cache [R,T,H,dk] it writes)."""
    dev = enc_states.device
    cross_kv = _precompute_cross_kv(params, cfg, enc_states.to(dtype))
    if repeat > 1:
        cross_kv = [(k.repeat_interleave(repeat, 0),
                     v.repeat_interleave(repeat, 0)) for k, v in cross_kv]
        enc_mask = enc_mask.repeat_interleave(repeat, 0)
    cross_bias = t5.attention_scores_bias(enc_mask[:, None, None, :], None)
    pb = t5.compute_position_bias(
        params["decoder"]["rel_bias"], T, T, bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    full_bias = t5.attention_scores_bias(t5.causal_mask(T, dev), pb)
    head_f32 = params["shared"].to(dtype).float()
    R = enc_mask.shape[0]
    cache = [tuple(torch.zeros((R, T, cfg.num_heads, cfg.d_kv), dtype=dtype,
                               device=dev) for _ in range(2))
             for _ in range(cfg.num_decoder_layers)]

    def step(tok: torch.Tensor, t: int) -> torch.Tensor:
        x = t5.embed_tokens(params["shared"], tok[:, None], dtype)  # [R,1,D]
        h = _decoder_step(params, cfg, x, t, cache,
                          full_bias[:, :, t:t + 1, :], cross_kv, cross_bias)
        return t5.lm_logits(params["shared"], h, cfg.d_model,
                            cfg.tie_word_embeddings,
                            head_f32=head_f32)[:, 0]

    return step, cache


def greedy_decode(params: Params, cfg, enc_states: torch.Tensor,
                  enc_mask: torch.Tensor, max_length: Optional[int] = None,
                  dtype=torch.bfloat16, early_stop: bool = True
                  ) -> torch.Tensor:
    """Greedy generation → int32 token ids [B, max_length-1] (without the
    decoder start token; ``max_length`` defaults to
    ``cfg.gen_max_length``), zero-filled after the loop stops.
    ``early_stop=False`` runs every step with no per-step read of the
    finished flags (the JAX ``lax.scan`` path); the tokens are the same."""
    T = (max_length or cfg.gen_max_length) - 1  # steps after the start
    B = enc_states.shape[0]
    dev = enc_states.device
    step, _ = _prepare(params, cfg, enc_states, enc_mask, T, dtype)
    tok = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int32,
                     device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in range(T):
        if early_stop and bool(finished.all()):
            break
        nxt = torch.argmax(step(tok, t), dim=-1).to(torch.int32)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        tokens[:, t] = nxt
        tok = nxt
    return tokens


def beam_search(params: Params, cfg, enc_states: torch.Tensor,
                enc_mask: torch.Tensor, num_beams: int = 5,
                max_length: Optional[int] = None,
                length_penalty: float = 1.0,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Batched beam search → int32 token ids [B, max_length-1] of each
    item's best hypothesis (HF ``generate(num_beams=K, do_sample=False,
    early_stopping=False)``, as the JAX ``beam_search``).

    Per step: the 2K best of the K·V candidates (beam score + f32
    log-softmax); those ranked < K that emit EOS enter the item's K-slot
    pool of finished hypotheses, scored at insert by
    ``cur_len**length_penalty`` (f32) and stored with the EOS; the K
    best non-EOS candidates become the next beams, and each layer's self
    K/V cache follows its beam's parent (one ``index_select`` per layer
    and per k/v). An item is done once its worst pool score is at least
    its best candidate's normalized score; done items freeze (pad
    tokens, pinned scores, each beam its own parent). At the end the
    open items' beams join their pools, normalized by the full length,
    and each item returns its best. The loop stops early once every item
    is done (one host check per step): frozen items change nothing, so
    the tokens are those of all steps."""
    T = (max_length or cfg.gen_max_length) - 1
    B = enc_states.shape[0]
    K = num_beams
    V = cfg.vocab_size
    dev = enc_states.device
    f32 = torch.float32
    step, cache = _prepare(params, cfg, enc_states, enc_mask, T, dtype,
                           repeat=K)
    rows = torch.arange(B, device=dev)[:, None]
    own = torch.arange(K, device=dev)[None, :]
    may_finish = torch.arange(2 * K, device=dev)[None, :] < K

    tok = torch.full((B * K,), cfg.decoder_start_token_id, dtype=torch.int32,
                     device=dev)
    # only beam 0 is alive at the start (HF: beams 1..K-1 at -1e9)
    scores = torch.tensor([0.0] + [NEG] * (K - 1), dtype=f32,
                          device=dev).repeat(B)
    seqs = torch.zeros((B * K, T), dtype=torch.int32, device=dev)
    pool_scores = torch.full((B, K), NEG, dtype=f32, device=dev)
    pool_seqs = torch.zeros((B, K, T), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(T):
        if t and bool(done.all()):
            break
        logp = torch.log_softmax(step(tok, t), dim=-1)           # [BK,V]
        cand = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(cand, 2 * K)                # [B,2K]
        parent = top_idx // V
        token = (top_idx % V).to(torch.int32)
        is_eos = token == cfg.eos_token_id
        # a device tensor: CUDA divides by a host scalar as a product
        # with its reciprocal, which rounds differently
        norm = torch.tensor(float(t + 1), dtype=f32,
                            device=dev) ** length_penalty

        # the pool insert: the stored sequence gets the EOS at t
        ins_scores = torch.where(is_eos & may_finish & ~done[:, None],
                                 top_scores / norm, NEG)[:, :K]
        ins_seqs = seqs.view(B, K, T)[rows, parent[:, :K]]      # [B,K,T]
        ins_seqs[:, :, t] = cfg.eos_token_id
        pool_scores, keep = _top_k(torch.cat([pool_scores, ins_scores], 1),
                                   K)
        pool_seqs = torch.cat([pool_seqs, ins_seqs], 1)[rows, keep]

        # the next beams: the K best non-EOS candidates
        new_scores, pick = _top_k(torch.where(is_eos, NEG, top_scores), K)
        frozen = done[:, None]
        new_scores = torch.where(frozen, scores.view(B, K), new_scores)
        new_token = torch.where(frozen, cfg.pad_token_id,
                                token.gather(1, pick))
        new_parent = torch.where(frozen, own, parent.gather(1, pick))
        flat = (new_parent + rows * K).reshape(-1)
        seqs = seqs.index_select(0, flat)
        seqs[:, t] = new_token.reshape(-1)
        for i, (k, v) in enumerate(cache):
            cache[i] = (k.index_select(0, flat), v.index_select(0, flat))

        # HF is_done: worst finished ≥ best candidate (EOS ones included)
        best_possible = top_scores[:, 0] / norm
        done = done | ((pool_scores.min(dim=1).values >= best_possible)
                       & (pool_scores[:, -1] > NEG / 2))
        tok = new_token.reshape(-1).to(torch.int32)
        scores = new_scores.reshape(-1)

    # the open items' beams join the pool, normalized by the final length
    # (a Python power rounded to f32, as JAX's weakly typed constant)
    final = torch.tensor(float(T) ** length_penalty, dtype=f32, device=dev)
    fin_scores = torch.where(done[:, None], NEG, scores.view(B, K) / final)
    all_scores = torch.cat([pool_scores, fin_scores], 1)
    all_seqs = torch.cat([pool_seqs, seqs.view(B, K, T)], 1)
    best = torch.argmax(all_scores, dim=-1)
    return all_seqs[torch.arange(B, device=dev), best]
