"""VL-Moonlight in plain PyTorch, float32: the reference the port's
``vqacl_tpu_torch/models/moonlight.py`` is held to.

Moonlight-16B-A3B (moonshotai; the DeepSeek-V3 architecture, arXiv
2412.19437 §2.1, and HF's ``modeling_deepseek_v3``) as a VQA model, built
as VL-T5 builds its (the language model after VL-T5's visual embedding):
36 region tokens (region feature and box each projected and RMS-normed,
the image-order row and the object-order rows at the top of the
vocabulary), the question, the decoder-start token and the teacher-forced
answer, all causal, question pads masked as keys. Each layer: RMSNorm →
MLA (q without compression; [c_kv | k_pe] = x·Wkv_a, c_kv RMS-normed,
[k_nope | v] = c_kv·Wkv_b; RoPE θ with HF's interleaved pairing on q_pe
and the shared k_pe; softmax(q·kᵀ/√(d_nope + d_rope)) over the mask) →
residual → RMSNorm → SwiGLU (the first ``first_k_dense_replace`` layers)
or MoE → residual. MoE: s = σ(x·Wgᵀ) over all the router's experts, the
top k of s + b (b the selection bias), weights s at the chosen experts
over their sum × ``routed_scaling_factor``, the held experts' SwiGLUs
weighted and summed (each expert in turn over the tokens that chose it),
+ the shared SwiGLU. The loss (``forward``): final RMSNorm, the untied
head, VL-T5's answer loss (per-sequence mean cross entropy of the answer
tokens × the answer's score, batch mean), + the sequence-wise balance
loss α·Σ_i f_i·P_i per sequence (eqs. 17–20), averaged over the batch
and summed over layers. ``loss_and_grads`` differentiates it by
autograd; ``update_bias`` is the selection bias's move after an
optimizer step, b_i += γ·sign(mean load − load_i).

Departures from the published model: region tokens from a feature table
stand for the vision tower; T5 tokenizer ids stand for Moonlight's (the
vocabulary stays whole); only routed experts 0 .. ``experts_held``-1 are
held (expert parallelism: the absent experts' part is left out; the
router still scores all ``router_experts``); the depth is the
configuration's; no dropout.

``cfg`` has the port's ``ModelConfig`` attribute names. Everything is
float32, with TF32 off while ``loss_and_grads`` runs. Imports nothing of
the port or of JAX.
"""

from __future__ import annotations

import contextlib

import torch

NEG = -1e9


def layer_name(i: int) -> str:
    return f"layer_{i:02d}"


def mm(a, b):
    return a @ b


def rms(w, x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x [B, S, h, d]: pairs (2i, 2i+1) rotated by pos·θ^(−2i/d), laid out
    as HF DeepSeek-V3 leaves them (first elements, then second)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos[:, None].float() * inv[None]                    # [S, d/2]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def visual(p, c, embed, feats, boxes):
    eps = c.layer_norm_epsilon
    f = rms(p["feat_ln"], mm(feats, p["feat_w"]) + p["feat_b"], eps)
    area = (boxes[..., 3] - boxes[..., 2]) * (boxes[..., 1] - boxes[..., 0])
    pos = torch.cat([boxes, area[..., None]], dim=-1)
    g = rms(p["pos_ln"], mm(pos, p["pos_w"]) + p["pos_b"], eps)
    N = feats.shape[1]
    return f + g + p["img_order"][0] + embed[c.vocab_size - N:].flip(0)


def mla(p, c, x, mask_add):
    B, S, _ = x.shape
    H = c.num_heads
    dn, dr, dv, r = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                     c.kv_lora_rank)
    pos = torch.arange(S, device=x.device)
    q = mm(x, p["wq"]).view(B, S, H, dn + dr)
    kva = mm(x, p["wkv_a"])
    kv = mm(rms(p["kv_norm"], kva[..., :r], c.layer_norm_epsilon),
            p["wkv_b"]).view(B, S, H, dn + dv)
    k_pe = rope(kva[..., r:].reshape(B, S, 1, dr), pos, c.rope_theta)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, c.rope_theta)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], -1)
    v = kv[..., dn:]
    w = torch.softmax(q.transpose(1, 2)
                      @ k.permute(0, 2, 3, 1) * (dn + dr) ** -0.5
                      + mask_add, dim=-1)
    o = (w @ v.transpose(1, 2)).transpose(1, 2).reshape(B, S, -1)
    return mm(o, p["wo"])


def swiglu(wg, wu, wd, x):
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


def moe(p, c, x, bias):
    """The MoE layer of x [B, S, D] → (y, balance loss, load [E], the
    chosen experts [B·S, k])."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    E, k = c.router_experts, c.num_experts_per_tok
    s = torch.sigmoid(mm(xt, p["router"].t()))
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    w = s.gather(1, idx)
    if c.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * c.routed_scaling_factor
    chosen = torch.zeros_like(s).scatter_(1, idx, 1.0)
    f = chosen.view(B, S, E).sum(1) * (E / (k * S))
    Pm = (s / s.sum(-1, keepdim=True)).view(B, S, E).mean(1)
    balance = c.seq_aux_alpha * (f * Pm).sum(-1).mean()
    ex = p["experts"]
    y = torch.zeros_like(xt)
    for e in range(c.experts_held):
        hit = idx == e                                            # [T, k]
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        we = (w * hit).sum(-1)[tok]
        out = swiglu(ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e],
                     xt[tok])
        y = y.index_add(0, tok, we[:, None] * out)
    sh = p["shared"]
    y = y + swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], xt)
    return y.view(B, S, D), balance, chosen.sum(0).detach(), idx


def forward(w, c, batch, bias):
    """→ (loss, balance, loads [layers, E], choices per MoE layer)."""
    tgt = batch["target_ids"]
    start = torch.full_like(tgt[:, :1], c.decoder_start_token_id)
    dec = torch.cat([start, tgt[:, :-1]], 1)
    dec = torch.where(dec == -100, torch.full_like(dec, c.pad_token_id), dec)
    ids = batch["input_ids"]
    x = torch.cat([visual(w["visual_embedding"], c, w["embed"],
                          batch["vis_feats"], batch["boxes"]),
                   w["embed"][ids], w["embed"][dec]], dim=1)
    B, S, _ = x.shape
    N = batch["vis_feats"].shape[1]
    keys = torch.cat([torch.ones((B, N), dtype=torch.bool, device=x.device),
                      ids != c.pad_token_id,
                      torch.ones_like(dec, dtype=torch.bool)], dim=1)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    mask_add = torch.where(causal[None, None] & keys[:, None, None], 0.0,
                           NEG)
    balances, loads, choices = [], [], []
    eps = c.layer_norm_epsilon
    for i in range(c.num_hidden_layers):
        p = w["layers"][layer_name(i)]
        x = x + mla(p["attn"], c, rms(p["attn_norm"], x, eps), mask_add)
        h = rms(p["mlp_norm"], x, eps)
        if i < c.first_k_dense_replace:
            m = p["mlp"]
            x = x + swiglu(m["w_gate"], m["w_up"], m["w_down"], h)
        else:
            y, bal, load, idx = moe(p["moe"], c, h, bias[len(loads)])
            x = x + y
            balances.append(bal)
            loads.append(load)
            choices.append(idx)
    h = rms(w["final_norm"], x, eps)[:, -tgt.shape[1]:]
    logits = mm(h, w["head"].t())
    logp = torch.log_softmax(logits, dim=-1)
    mask = (tgt != -100).float()
    safe = torch.where(tgt == -100, 0, tgt)
    nll = -logp.gather(-1, safe[..., None])[..., 0] * mask
    per_seq = nll.sum(1) / mask.sum(1).clamp_min(1.0)
    balance = torch.stack(balances).sum()
    loss = (per_seq * batch["scores"]).mean() + balance
    return loss, balance, torch.stack(loads), choices


def update_bias(bias, load, gamma):
    return bias + gamma * torch.sign(load.mean(-1, keepdim=True) - load)


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def flatten(tree, prefix=()):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [x for k in sorted(tree) for x in flatten(tree[k], prefix + (k,))]


def loss_and_grads(params, cfg, batch, bias):
    """f32 copies of ``params`` → (loss, balance, loads, choices, {path:
    gradient}) with every input cast to float32."""
    with no_tf32():
        pairs = flatten(params)
        leaves = [t.detach().float().clone().requires_grad_(True)
                  for _, t in pairs]
        w: dict = {}
        for (path, _), t in zip(pairs, leaves):
            node = w
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        b = {k: (v.float() if v.is_floating_point() else v)
             for k, v in batch.items()}
        loss, balance, load, choices = forward(w, cfg, b, bias.float())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), balance.detach(), load, choices, {
        ".".join(p): (torch.zeros_like(t) if g is None else g)
        for (p, _), t, g in zip(pairs, leaves, grads)}
