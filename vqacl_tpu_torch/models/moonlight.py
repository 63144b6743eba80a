"""VL-Moonlight: Moonlight-16B-A3B's language model as a VQACL backbone.

The VQA model is built the way VL-T5 is: the language model after the
port's visual embedding (``visual_embedding.py``). The language model is
Moonlight-16B-A3B (moonshotai, the DeepSeek-V3 architecture; Kimi-VL-A3B
runs the same behind its vision tower), decoder-only:

  sequence   36 region tokens (the visual embedding), the question's
             tokens, then the decoder-start token and the teacher-forced
             answer: all causal, question pads masked as keys, RoPE
             positions 0 .. S-1;
  layer      x + MLA(RMSNorm(x)), then + MLP(RMSNorm(·)): SwiGLU for the
             first ``first_k_dense_replace`` layers, an MoE layer after;
  MLA        q = x·Wq [H, 128 + 64] (no q compression); [c_kv | k_pe] =
             x·Wkv_a, c_kv RMS-normed, [k_nope | v] = c_kv·Wkv_b per head;
             RoPE (HF DeepSeek-V3's interleaved pairing, θ 50,000) on q_pe
             and on k_pe, which every head shares; softmax(q·kᵀ/√192 +
             mask) in f32, ·v, ·Wo;
  MoE        s = σ(x·Wgᵀ) in f32 over the router's 64 experts; the top 6
             of s + b (b: the selection bias, DeepSeek-V3's
             auxiliary-loss-free balancing, not a parameter); weights s at
             the chosen experts over their sum × 2.446; the held experts'
             SwiGLUs (``ops/moe.py``) weighted and summed, + the shared
             experts (one SwiGLU of width 2 × 1408);
  balance    the sequence-wise balance loss α·Σ_i f_i·P_i per sequence
             (DeepSeek-V3 eqs. 17–20, f from the choices, P from s over
             its row sum), averaged over the batch and summed over layers;
  loss       final RMSNorm, the untied head, and VL-T5's answer loss (the
             per-sequence mean of the answer tokens' cross entropy
             weighted by the answer's score) through ``fused_head_loss``
             with rescale 1, + the balance loss.

The selection bias moves after each optimizer step: b_i += γ·sign(mean
load − load_i), the loads counted over all the router's experts from the
step's choices (``update_bias``), on the device.

A chip holds ``experts_held`` routed experts (ids 0 .. n-1, stacked
[n, D, F] leaves): the router still scores all of them, and the layer
adds what its own experts give (expert parallelism without its exchange;
the absent experts' part is left out). Compute in the given dtype with
f32 master weights, f32 router, norms and softmax; no dropout (the
published model has none). Greedy decoding re-runs the whole prefix per
token (no latent cache).

With the recorder of ``utils/profiling.py`` on, each attention is the
span ``mla`` and each MoE layer the span ``moe``, both open in the
backward pass too, over the kernels that differentiate them; inside
``moe`` the forward's parts are the spans ``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.shared`` and ``moe.combine``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from vqacl_tpu_torch.models import t5
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.models.visual_embedding import apply_visual_embedding
from vqacl_tpu_torch.models.vlt5 import ProtoAux, fused_head_loss
from vqacl_tpu_torch.ops import moe as M
from vqacl_tpu_torch.utils import profiling
from vqacl_tpu_torch.utils.device import resolve_device
from vqacl_tpu_torch.utils.profiling import span

Params = Dict[str, Any]
INIT_STD = 0.02        # HF initializer_range
NEG = -1e9             # additive key mask


def moe_layers(cfg) -> int:
    return cfg.num_hidden_layers - cfg.first_k_dense_replace


def layer_name(i: int) -> str:
    return f"layer_{i:02d}"


Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], Optional[float]]


def layout(cfg) -> List[Leaf]:
    """(path, shape, std) of every leaf (std None: ones, 0: zeros), in
    sorted path order."""
    D, H, V = cfg.d_model, cfg.num_heads, cfg.vocab_size
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, s = cfg.kv_lora_rank, INIT_STD
    out = [(("embed",), (V, D), s), (("head",), (V, D), s),
           (("final_norm",), (D,), None)]

    def swiglu(p, F, lead=()):
        out.extend([(p + ("w_gate",), lead + (D, F), s),
                    (p + ("w_up",), lead + (D, F), s),
                    (p + ("w_down",), lead + (F, D), s)])

    for i in range(cfg.num_hidden_layers):
        p = ("layers", layer_name(i))
        out.extend([(p + ("attn_norm",), (D,), None),
                    (p + ("mlp_norm",), (D,), None),
                    (p + ("attn", "wq"), (D, H * (dn + dr)), s),
                    (p + ("attn", "wkv_a"), (D, r + dr), s),
                    (p + ("attn", "kv_norm"), (r,), None),
                    (p + ("attn", "wkv_b"), (r, H * (dn + dv)), s),
                    (p + ("attn", "wo"), (H * dv, D), s)])
        if i < cfg.first_k_dense_replace:
            swiglu(p + ("mlp",), cfg.intermediate_size)
        else:
            out.append((p + ("moe", "router"), (cfg.router_experts, D), s))
            swiglu(p + ("moe", "experts"), cfg.moe_intermediate_size,
                   (cfg.experts_held,))
            swiglu(p + ("moe", "shared"),
                   cfg.n_shared_experts * cfg.moe_intermediate_size)
    fd, v = cfg.feat_dim, ("visual_embedding",)
    out.extend([(v + ("feat_w",), (fd, D), s), (v + ("feat_b",), (D,), 0.0),
                (v + ("pos_w",), (cfg.pos_dim + 1, D), s),
                (v + ("pos_b",), (D,), 0.0), (v + ("feat_ln",), (D,), None),
                (v + ("pos_ln",), (D,), None),
                (v + ("img_order",), (cfg.n_images, D), s)])
    return sorted(out, key=lambda leaf: leaf[0])


def _put(tree: Params, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(seed: int, cfg, device="cuda") -> Params:
    """f32 parameters from ``seed`` on ``device``: normal × 0.02 (one
    draw from a ``torch.Generator`` on the device, leaf after leaf in
    sorted order), ones for the norms, zeros for the biases."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    tree: Params = {}
    for path, shape, std in layout(cfg):
        if std is None:
            t = torch.ones(shape, device=dev)
        elif std == 0.0:
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=g, device=dev) * std
        _put(tree, path, t)
    return tree


def init_router_bias(cfg, device) -> torch.Tensor:
    """The selection bias of every MoE layer, f32 [layers, experts]."""
    return torch.zeros((moe_layers(cfg), cfg.router_experts),
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# spans that stay open over a block's backward
# ---------------------------------------------------------------------------

class _Open(torch.autograd.Function):
    """On a block's output: its backward opens the span."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        name, stack = ctx.box
        cm = profiling.span(name)
        cm.__enter__()
        stack.append(cm)
        return g, None


class _Close(torch.autograd.Function):
    """On a block's input: its backward closes the span."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        stack = ctx.box[1]
        if stack:
            stack.pop().__exit__(None, None, None)
        return g, None


def _block(name: str, fn, x: torch.Tensor, *rest):
    """``fn(x, *rest)`` inside the span ``name``; with the recorder on and
    a graph being recorded, the span also covers the block's backward
    (from its output, the first of a tuple, to its input)."""
    marks = profiling.recording() and torch.is_grad_enabled() \
        and x.requires_grad
    if marks:
        box = (name, [])
        x = _Close.apply(x, box)
    with span(name):
        out = fn(x, *rest)
    if marks:
        if isinstance(out, tuple):
            out = (_Open.apply(out[0], box),) + out[1:]
        else:
            out = _Open.apply(out, box)
    return out


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def rope_tables(S: int, dim: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [S, dim] f32 of positions 0 .. S-1 (HF's layout: the
    frequencies repeated over the two halves)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    f = torch.outer(torch.arange(S, device=device, dtype=torch.float32), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, h, d]: the pairs (2i, 2i+1) de-interleaved into halves,
    then rotated (HF DeepSeek-V3's ``apply_rotary_pos_emb``), in f32."""
    B, S, h, d = x.shape
    xf = x.float().view(B, S, h, d // 2, 2).transpose(-1, -2).reshape(
        B, S, h, d)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


def mla(p: Params, cfg, x: torch.Tensor, cos, sin, mask_add,
        dtype) -> torch.Tensor:
    """Multi-head latent attention of ``x`` [B, S, D] (already normed)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q = (x @ p["wq"].to(dtype)).view(B, S, H, dn + dr)
    kva = x @ p["wkv_a"].to(dtype)
    c = t5.layer_norm(p["kv_norm"], kva[..., :r], cfg.layer_norm_epsilon)
    k_pe = apply_rope(kva[..., r:].reshape(B, S, 1, dr), cos, sin)
    kv = (c @ p["wkv_b"].to(dtype)).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], -1)
    v = kv[..., dn:]
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float() \
        * (dn + dr) ** -0.5 + mask_add
    probs = torch.softmax(scores, dim=-1).to(dtype)
    o = (probs @ v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * dv)
    return o @ p["wo"].to(dtype)


def swiglu(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """(silu(x·Wg) ⊙ x·Wu)·Wd, the activation in f32."""
    a = torch.nn.functional.silu((x @ p["w_gate"].to(dtype)).float()) \
        * (x @ p["w_up"].to(dtype)).float()
    return a.to(dtype) @ p["w_down"].to(dtype)


class Routing(NamedTuple):
    idx: torch.Tensor       # int64 [T, k]: the chosen experts
    weights: torch.Tensor   # f32 [T, k]
    load: torch.Tensor      # f32 [experts]: tokens that chose each
    balance: torch.Tensor   # f32 0-dim: the sequence-wise balance loss


def route(router: torch.Tensor, cfg, x: torch.Tensor, bias: torch.Tensor,
          seq_len: int) -> Routing:
    """The router over ``x`` [T, D] (T = batch × ``seq_len``) in f32."""
    T = x.shape[0]
    E, k = cfg.router_experts, cfg.num_experts_per_tok
    s = torch.sigmoid(x.float() @ router.float().t())           # [T, E]
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.routed_scaling_factor
    chosen = torch.zeros_like(s).scatter_(1, idx, 1.0)          # [T, E]
    load = chosen.sum(0)
    B = T // seq_len
    f = chosen.view(B, seq_len, E).sum(1) * (E / (k * seq_len))
    P = (s / s.sum(-1, keepdim=True)).view(B, seq_len, E).mean(1)
    balance = cfg.seq_aux_alpha * (f * P).sum(-1).mean()
    return Routing(idx, w, load, balance)


def moe(p: Params, cfg, x: torch.Tensor, bias: torch.Tensor, dtype
        ) -> Tuple[torch.Tensor, Routing]:
    """The MoE layer of ``x`` [B, S, D] (already normed)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    with span("moe.router"):
        rt = route(p["router"], cfg, xt, bias, S)
    with span("moe.dispatch"):
        plan = M.route_plan(rt.idx, cfg.experts_held)
    ex = p["experts"]
    with span("moe.experts"):
        out = M.grouped_swiglu(xt, plan, ex["w_gate"], ex["w_up"],
                               ex["w_down"])
    with span("moe.shared"):
        shared = swiglu(p["shared"], xt, dtype)
    with span("moe.combine"):
        y = (M.combine(out, plan, rt.weights) + shared.float()).to(dtype)
    return y.view(B, S, D), rt


def stack(params: Params, cfg, x: torch.Tensor, key_mask: torch.Tensor,
          bias: torch.Tensor, dtype) -> Tuple[torch.Tensor, List[Routing]]:
    """The layers and the final norm over ``x`` [B, S, D] →
    (hidden [B, S, D], each MoE layer's routing)."""
    B, S, _ = x.shape
    cos, sin = rope_tables(S, cfg.qk_rope_head_dim, cfg.rope_theta,
                           x.device)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    mask_add = torch.where(causal[None, None] & key_mask[:, None, None, :],
                           0.0, NEG).float()
    eps = cfg.layer_norm_epsilon
    routes: List[Routing] = []
    for i in range(cfg.num_hidden_layers):
        p = params["layers"][layer_name(i)]
        h = t5.layer_norm(p["attn_norm"], x, eps)
        x = x + _block("mla", lambda a: mla(p["attn"], cfg, a, cos, sin,
                                            mask_add, dtype), h)
        h = t5.layer_norm(p["mlp_norm"], x, eps)
        if i < cfg.first_k_dense_replace:
            x = x + swiglu(p["mlp"], h, dtype)
        else:
            b = bias[len(routes)]
            y, rt = _block("moe", lambda a: moe(p["moe"], cfg, a, b, dtype),
                           h)
            routes.append(rt)
            x = x + y
    return t5.layer_norm(params["final_norm"], x, eps), routes


def embed(params: Params, cfg, input_ids, vis_feats, boxes, dec_ids,
          dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """[regions | question | decoder ids] embedded → (x [B, S, D], key
    mask [B, S] bool: False at the question's pads)."""
    vis = apply_visual_embedding(params["visual_embedding"], cfg,
                                 params["embed"], vis_feats, boxes,
                                 dtype=dtype)
    q = t5.embed_tokens(params["embed"], input_ids, dtype)
    a = t5.embed_tokens(params["embed"], dec_ids, dtype)
    B, N = vis.shape[:2]
    ones = lambda n: torch.ones((B, n), dtype=torch.bool,  # noqa: E731
                                device=vis.device)
    mask = torch.cat([ones(N), input_ids != cfg.pad_token_id,
                      ones(dec_ids.shape[1])], dim=1)
    return torch.cat([vis, q, a], dim=1), mask


class ForwardOut(NamedTuple):
    loss: torch.Tensor           # the answer loss + the balance loss
    proto_state: ProtoState      # unchanged: no prototypes
    aux: ProtoAux                # empty
    balance: torch.Tensor        # the balance loss, summed over layers
    load: torch.Tensor           # f32 [layers, experts] of this batch
    choices: Tuple[torch.Tensor, ...]   # each MoE layer's [T, k] choices


def forward_train(params: Params, cfg, batch: Dict[str, torch.Tensor],
                  proto_state: ProtoState, router_bias: torch.Tensor,
                  dtype=torch.bfloat16) -> ForwardOut:
    """``vlt5.forward_train``'s contract on VL-Moonlight: batch input_ids
    [B, L], vis_feats [B, N, feat_dim], boxes [B, N, 4], target_ids
    [B, T] (-100 padded), scores [B], on the parameters' device."""
    tgt = batch["target_ids"]
    dec = t5.shift_right(tgt, cfg.decoder_start_token_id, cfg.pad_token_id)
    x, mask = embed(params, cfg, batch["input_ids"], batch["vis_feats"],
                    batch["boxes"], dec, dtype)
    h, routes = stack(params, cfg, x, mask, router_bias, dtype)
    answer = h[:, -tgt.shape[1]:]
    loss = fused_head_loss(answer, params["head"], tgt, batch["scores"],
                           1.0)
    balance = torch.stack([r.balance for r in routes]).sum()
    load = torch.stack([r.load for r in routes]).detach()
    return ForwardOut(loss + balance, proto_state,
                      ProtoAux.empty(h.device), balance.detach(), load,
                      tuple(r.idx for r in routes))


def update_bias(bias: torch.Tensor, load: torch.Tensor, gamma: float
                ) -> torch.Tensor:
    """b_i + γ·sign(mean load − load_i), per layer."""
    return bias + gamma * torch.sign(load.mean(-1, keepdim=True) - load)


@torch.no_grad()
def greedy(params: Params, cfg, input_ids, vis_feats, boxes,
           router_bias: torch.Tensor, max_length: Optional[int] = None,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy answers → int32 [B, max_length-1] (without the start token,
    zero-filled after EOS), the whole prefix run again for each token."""
    T = (max_length or cfg.gen_max_length) - 1
    B = input_ids.shape[0]
    dev = input_ids.device
    dec = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for t in range(T):
        if bool(finished.all()):
            break
        x, mask = embed(params, cfg, input_ids, vis_feats, boxes, dec, dtype)
        h, _ = stack(params, cfg, x, mask, router_bias, dtype)
        logits = h[:, -1].float() @ params["head"].to(dtype).float().t()
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        tokens[:, t] = nxt.to(torch.int32)
        dec = torch.cat([dec, nxt[:, None]], dim=1)
    return tokens


@torch.no_grad()
def eval_loss(params: Params, cfg, batch: Dict[str, torch.Tensor],
              router_bias: torch.Tensor, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """The teacher-forced answer loss (no balance term)."""
    tgt = batch["target_ids"]
    dec = t5.shift_right(tgt, cfg.decoder_start_token_id, cfg.pad_token_id)
    x, mask = embed(params, cfg, batch["input_ids"], batch["vis_feats"],
                    batch["boxes"], dec, dtype)
    h, _ = stack(params, cfg, x, mask, router_bias, dtype)
    return fused_head_loss(h[:, -tgt.shape[1]:], params["head"], tgt,
                           batch["scores"], 1.0)
