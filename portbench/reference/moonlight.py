"""VL-Moonlight in plain PyTorch, and its first training steps from the
seed: the reference that decides ``correct`` in the cell
``vqa_cl_train_moonlight``.

Moonlight-16B-A3B (moonshotai; the DeepSeek-V3 architecture, arXiv
2412.19437 §2.1, and HF's ``modeling_deepseek_v3``) as a VQA model:
36 region tokens (VL-T5's visual embedding: region feature and box each
projected and RMS-normed, the image-order row and the object-order rows
at the top of the vocabulary), the question, the decoder-start token and
the teacher-forced answer, causal, question pads masked as keys. Each
layer: RMSNorm → MLA (q without compression; [c_kv | k_pe] = x·Wkv_a,
c_kv RMS-normed, [k_nope | v] = c_kv·Wkv_b; RoPE θ 50,000 with HF's
interleaved pairing on q_pe and the shared k_pe; softmax(q·kᵀ/√192)
over the mask) → residual → RMSNorm → SwiGLU (dense layers) or MoE →
residual. MoE: s = σ(x·Wgᵀ), the top k of s + b (b the selection
bias), weights s over their sum × the scaling factor, the held experts'
SwiGLUs weighted and summed (each expert taken in turn over the tokens
that chose it), + the shared SwiGLU. The loss: final RMSNorm, the untied
head, VL-T5's answer loss (per-sequence mean cross entropy of the answer
tokens × the answer's score, batch mean), + the sequence-wise balance
loss α·Σ f_i·P_i per sequence, averaged. After each optimizer step
b_i += γ·sign(mean load − load_i).

Departures from the published model, as in the program: region tokens
from the feature table stand for the vision tower (not run); the T5
tokenizer's ids stand for Moonlight's (the vocabulary stays whole); this
chip holds routed experts 0 .. n-1 of the router's 64 (expert
parallelism: the absent experts' part is left out); the depth is the
configuration's (the first pipeline stage); no dropout.

Every product goes through the precision ``P`` (f32 with TF32 off, or
the fp8 control); the router, norms and softmax are f32. Imports nothing
of the port.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import inputs
from portbench.reference.precision import Precision
from portbench.reference.train import MOMENT, lr_at

NEG = -1e9
INIT_STD = 0.02

# the configuration file's keys (HF names) → the sizes used here
_NAMES = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
          "rms_norm_eps": "eps", "n_routed_experts": "experts_held"}


def sizes(cfg: Dict) -> SimpleNamespace:
    """The configuration file as attributes (HF's names, and d_model,
    num_heads, eps, experts_held for four of them)."""
    out = dict(cfg)
    for k, v in _NAMES.items():
        out[v] = cfg[k]
    return SimpleNamespace(**out)


def layer_name(i: int) -> str:
    return f"layer_{i:02d}"


def layout(c: SimpleNamespace):
    """(path, shape, std) of every leaf (std None: ones; 0: zeros), in
    sorted path order: the program's tree."""
    D, H, V = c.d_model, c.num_heads, c.vocab_size
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    r, s = c.kv_lora_rank, INIT_STD
    out = [(("embed",), (V, D), s), (("head",), (V, D), s),
           (("final_norm",), (D,), None)]

    def swiglu(p, F, lead=()):
        out.extend([(p + ("w_gate",), lead + (D, F), s),
                    (p + ("w_up",), lead + (D, F), s),
                    (p + ("w_down",), lead + (F, D), s)])

    for i in range(c.num_hidden_layers):
        p = ("layers", layer_name(i))
        out.extend([(p + ("attn_norm",), (D,), None),
                    (p + ("mlp_norm",), (D,), None),
                    (p + ("attn", "wq"), (D, H * (dn + dr)), s),
                    (p + ("attn", "wkv_a"), (D, r + dr), s),
                    (p + ("attn", "kv_norm"), (r,), None),
                    (p + ("attn", "wkv_b"), (r, H * (dn + dv)), s),
                    (p + ("attn", "wo"), (H * dv, D), s)])
        if i < c.first_k_dense_replace:
            swiglu(p + ("mlp",), c.intermediate_size)
        else:
            out.append((p + ("moe", "router"), (c.router_experts, D), s))
            swiglu(p + ("moe", "experts"), c.moe_intermediate_size,
                   (c.experts_held,))
            swiglu(p + ("moe", "shared"),
                   c.n_shared_experts * c.moe_intermediate_size)
    v = ("visual_embedding",)
    out.extend([(v + ("feat_w",), (c.feat_dim, D), s),
                (v + ("feat_b",), (D,), 0.0), (v + ("pos_w",), (5, D), s),
                (v + ("pos_b",), (D,), 0.0), (v + ("feat_ln",), (D,), None),
                (v + ("pos_ln",), (D,), None),
                (v + ("img_order",), (2, D), s)])
    return sorted(out, key=lambda leaf: leaf[0])


def _put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The f32 tree from ``seed``: one normal draw covers every random
    leaf (each a view of it, scaled by 0.02 in place)."""
    leaves = layout(sizes(cfg))
    n = [0 if std in (None, 0.0) else _numel(shape)
         for _, shape, std in leaves]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(n), generator=g, device=device)
    tree: Dict = {}
    off = 0
    for (path, shape, std), k in zip(leaves, n):
        if std is None:
            t = torch.ones(shape, device=device)
        elif std == 0.0:
            t = torch.zeros(shape, device=device)
        else:
            t = flat[off:off + k].view(shape).mul_(std)
            off += k
        _put(tree, path, t)
    return tree


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k


def flatten(tree, prefix=()):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [x for k in sorted(tree) for x in flatten(tree[k], prefix + (k,))]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

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


def visual(P, p, c, embed, feats, boxes):
    f = rms(p["feat_ln"], P.mm(feats, p["feat_w"]) + p["feat_b"], c.eps)
    area = (boxes[..., 3] - boxes[..., 2]) * (boxes[..., 1] - boxes[..., 0])
    pos = torch.cat([boxes, area[..., None]], dim=-1)
    g = rms(p["pos_ln"], P.mm(pos, p["pos_w"]) + p["pos_b"], c.eps)
    N = feats.shape[1]
    return f + g + p["img_order"][0] + embed[c.vocab_size - N:].flip(0)


def mla(P, p, c, x, mask_add):
    B, S, _ = x.shape
    H = c.num_heads
    dn, dr, dv, r = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                     c.kv_lora_rank)
    pos = torch.arange(S, device=x.device)
    q = P.mm(x, p["wq"]).view(B, S, H, dn + dr)
    kva = P.mm(x, p["wkv_a"])
    kv = P.mm(rms(p["kv_norm"], kva[..., :r], c.eps),
              p["wkv_b"]).view(B, S, H, dn + dv)
    k_pe = rope(kva[..., r:].reshape(B, S, 1, dr), pos, c.rope_theta)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, c.rope_theta)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], -1)
    v = kv[..., dn:]
    w = torch.softmax(P.q(q.transpose(1, 2))
                      @ P.q(k.permute(0, 2, 3, 1)) * (dn + dr) ** -0.5
                      + mask_add, dim=-1)
    o = (P.q(w) @ P.q(v.transpose(1, 2))).transpose(1, 2).reshape(B, S, -1)
    return P.mm(o, p["wo"])


def swiglu(P, wg, wu, wd, x):
    return P.mm(torch.nn.functional.silu(P.mm(x, wg)) * P.mm(x, wu), wd)


def moe(P, p, c, x, bias, held=None):
    """The MoE layer of x [B, S, D] → (y, balance loss, load [E], the
    chosen experts [B·S, k]). ``held``: another side's choices [T', k],
    taken in place of this side's own for the first min(T', B·S)
    tokens (routing held equal)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    E, k = c.router_experts, c.num_experts_per_tok
    s = torch.sigmoid(P.mm(xt, p["router"].t()))
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    if held is not None:
        n = min(len(held), len(idx))
        idx = torch.cat([held[:n].to(idx.device), idx[n:]])
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
        out = swiglu(P, ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e],
                     xt[tok])
        y = y.index_add(0, tok, we[:, None] * out)
    sh = p["shared"]
    y = y + swiglu(P, sh["w_gate"], sh["w_up"], sh["w_down"], xt)
    return y.view(B, S, D), balance, chosen.sum(0).detach(), idx


def forward(P: Precision, w, c, batch, bias, held=None):
    """→ (loss, balance, loads [layers, E], choices per MoE layer);
    ``held``: choices per MoE layer to route by (``moe``)."""
    tgt = batch["target_ids"]
    start = torch.full_like(tgt[:, :1], c.decoder_start_token_id)
    dec = torch.cat([start, tgt[:, :-1]], 1)
    dec = torch.where(dec == -100, torch.full_like(dec, c.pad_token_id), dec)
    ids = batch["input_ids"]
    x = torch.cat([visual(P, w["visual_embedding"], c, w["embed"],
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
    for i in range(c.num_hidden_layers):
        p = w["layers"][layer_name(i)]
        x = x + mla(P, p["attn"], c, rms(p["attn_norm"], x, c.eps),
                    mask_add)
        h = rms(p["mlp_norm"], x, c.eps)
        if i < c.first_k_dense_replace:
            m = p["mlp"]
            x = x + swiglu(P, m["w_gate"], m["w_up"], m["w_down"], h)
        else:
            y, bal, load, idx = moe(P, p["moe"], c, h, bias[len(loads)],
                                    None if held is None
                                    else held[len(loads)])
            x = x + y
            balances.append(bal)
            loads.append(load)
            choices.append(idx)
    h = rms(w["final_norm"], x, c.eps)[:, -tgt.shape[1]:]
    logits = P.mm(h, w["head"].t())
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


# ---------------------------------------------------------------------------
# the first steps
# ---------------------------------------------------------------------------

def first_steps(traffic, cfg: Dict, seed: int,
                steps: Sequence[Tuple[list, int]], sched, device,
                P: Precision, held=None) -> Dict[str, List]:
    """The reference's steps over the rows the program ran first: the
    weights from the seed, the configuration's clip, HF AdamW (moments
    stored in the stated type, no decay on ``*_b`` and ``*_norm``
    leaves), the warmup schedule, the selection bias moved after each
    step. → each step's loss, each leaf's first clipped gradient norm
    and change over the steps (sorted path order), and each step's
    choices. ``held``: each step's choices per MoE layer (another side's
    ``choices``), routed by in place of the reference's own."""
    c = sizes(cfg)
    tr = cfg["train"]
    pairs = flatten(make_weights(cfg, seed, device))
    paths = [p for p, _ in pairs]
    leaves = [t.clone().requires_grad_(True) for _, t in pairs]
    p0 = [t for _, t in pairs]
    w: Dict = {}
    for path, t in zip(paths, leaves):
        _put(w, path, t)
    mdt = MOMENT[cfg["precision"]["adam_moments"]]
    mu = [torch.zeros_like(t, dtype=mdt) for t in leaves]
    nu = [torch.zeros_like(t, dtype=mdt) for t in leaves]
    decay = [not (p[-1].endswith("_b") or p[-1].endswith("_norm"))
             for p in paths]
    bias = torch.zeros((c.num_hidden_layers - c.first_k_dense_replace,
                        c.router_experts), device=device)
    b1, b2, eps = tr["adam_beta1"], tr["adam_beta2"], tr["adam_eps"]
    out: Dict[str, List] = {"loss": [], "grad1": [], "grad_norm": [],
                            "choices": []}
    for k, (qids, Bp) in enumerate(steps):
        batch = inputs.batch(traffic, qids, Bp, cfg,
                             cfg["precision"]["feature_table"], device)
        loss, _, load, choices = forward(P, w, c, batch, bias,
                                         None if held is None else held[k])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        if gnorm >= tr["clip_grad_norm"]:
            grads = [g / gnorm * tr["clip_grad_norm"] for g in grads]
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(float(gnorm))
        out["choices"].append([x.cpu() for x in choices])
        if k == 0:
            out["grad1"] = [float(g.norm()) for g in grads]
        n = k + 1
        corr = (1.0 - b2 ** n) ** 0.5 / (1.0 - b1 ** n)
        lr = lr_at(k, tr["lr"], sched[0], sched[1], tr["schedule"])
        with torch.no_grad():
            for i, (t, g) in enumerate(zip(leaves, grads)):
                m2 = b1 * mu[i].float() + (1.0 - b1) * g
                v2 = b2 * nu[i].float() + (1.0 - b2) * g * g
                u = corr * m2 / (torch.sqrt(v2) + eps)
                if decay[i]:
                    u = u + tr["weight_decay"] * t
                mu[i], nu[i] = m2.to(mdt), v2.to(mdt)
                t -= lr * u
            bias = update_bias(bias, load, c.router_bias_gamma)
        del grads, loss
    out["change"] = [float((t.detach() - a).norm())
                     for t, a in zip(leaves, p0)]
    out["paths"] = [".".join(p) for p in paths]
    return out
