"""VL-T5 in plain PyTorch, as the VL-T5 paper and T5 v1.0 describe it.

T5: RMS layer norm without mean or bias, unscaled dot-product attention
with a relative position bias (one table per stack, bidirectional
buckets in the encoder, causal in the decoder), an additive −1e9 key
mask, ReLU feed-forward, the input embedding tied to the output head with
the d_model^-0.5 rescale. VL-T5: the encoder reads the text tokens
followed by one token per region (or clip): the region feature and its
box (x1, y1, x2, y2, and an area term in the reference code's index
convention, (y2 − x2)(y1 − x1)) each projected and layer-normed, summed
with the image-order row and the object-order rows at the top of the
vocabulary; the relative bias covers the text-text block only. VQACL's
prototypes: the text and region positions are mean-pooled, a training
step first updates the Q and V banks from the batch's class means (the
EMA of ``proto_update``), each row retrieves its nearest prototype of
each bank by cosine of tanh, and the two retrieved rows join the encoder
output as two more positions.

Dropout (rate ``dropout``) sits where T5 puts it: the stack input, each
attention's probabilities, each residual branch, the MLP hidden and the
stack output. Its masks come from ``gen``, in the order this code draws
them: a uniform draw per mask (kept below 1 − rate) and, in the encoder,
one seed per layer for the attention probabilities, whose mask is
Philox4x32-10 (``philox.keep_mask``). Every product goes through the
precision ``P``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from portbench.reference import philox
from portbench.reference.precision import Precision

NEG = -1e9


class Drop:
    """The dropout masks of one forward, from ``gen`` (None: no dropout)."""

    def __init__(self, gen: Optional[torch.Generator], rate: float):
        self.gen, self.rate = gen, rate

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None or self.rate == 0.0:
            return x
        keep = torch.rand(tuple(x.shape), generator=self.gen,
                          device=x.device) < (1.0 - self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def seeds(self, n: int) -> Optional[torch.Tensor]:
        if self.gen is None:
            return None
        return torch.randint(0, 2 ** 31 - 1, (n,), generator=self.gen,
                             dtype=torch.int32, device=self.gen.device)

    def attention(self, p: torch.Tensor, seed: Optional[torch.Tensor]
                  ) -> torch.Tensor:
        if seed is None or self.rate == 0.0:
            return p
        B, H, Tq, Sk = p.shape
        keep = philox.keep_mask(seed, B, H, Tq, Sk, self.rate)
        kd = torch.tensor(1.0 - self.rate, device=p.device)
        return torch.where(keep, p / kd, torch.zeros_like(p))


def rms_norm(w, x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def buckets(rel: torch.Tensor, bidirectional: bool, n: int, max_d: int):
    ret = torch.zeros_like(rel)
    m = -rel
    if bidirectional:
        n //= 2
        ret = ret + (m < 0).long() * n
        m = m.abs()
    else:
        m = m.clamp_min(0)
    exact = n // 2
    large = exact + (torch.log(m.clamp_min(1).float() / exact)
                     / math.log(max_d / exact) * (n - exact)).long()
    return ret + torch.where(m < exact, m, large.clamp_max(n - 1))


def position_bias(table, q_len, k_len, bidirectional, cfg):
    dev = table.device
    rel = torch.arange(k_len, device=dev)[None, :] \
        - torch.arange(q_len, device=dev)[:, None]
    b = buckets(rel, bidirectional, cfg["relative_attention_num_buckets"],
                cfg["relative_attention_max_distance"])
    return table[b].permute(2, 0, 1)                        # [H, q, k]


def attention(P: Precision, p, xq, xkv, bias, H, drop: Drop,
              seed: Optional[torch.Tensor] = None):
    """bias: additive f32 term broadcast to [B, H, Tq, Sk]. The mask of
    the probabilities: Philox from ``seed``, or a uniform draw."""
    B, Tq, _ = xq.shape
    Sk = xkv.shape[1]
    q = P.mm(xq, p["wq"]).view(B, Tq, H, -1).transpose(1, 2)
    k = P.mm(xkv, p["wk"]).view(B, Sk, H, -1).transpose(1, 2)
    v = P.mm(xkv, p["wv"]).view(B, Sk, H, -1).transpose(1, 2)
    w = torch.softmax(P.q(q) @ P.q(k).transpose(-1, -2) + bias, dim=-1)
    w = drop.attention(w, seed) if seed is not None else drop(w)
    o = (P.q(w) @ P.q(v)).transpose(1, 2).reshape(B, Tq, -1)
    return P.mm(o, p["wo"])


def mlp(P, p, x, drop: Drop):
    return P.mm(drop(torch.relu(P.mm(x, p["wi"]))), p["wo"])


def visual(P, p, cfg, shared, feats, boxes):
    eps = cfg["layer_norm_epsilon"]
    N = feats.shape[1]
    f = rms_norm(p["feat_ln"], P.mm(feats, p["feat_w"]) + p["feat_b"], eps)
    area = (boxes[..., 3] - boxes[..., 2]) * (boxes[..., 1] - boxes[..., 0])
    pos = torch.cat([boxes, area[..., None]], -1)
    g = rms_norm(p["pos_ln"], P.mm(pos, p["pos_w"]) + p["pos_b"], eps)
    V = cfg["vocab_size"]
    return f + g + p["img_order"][0] + shared[V - N:V].flip(0)[None]


def encode(P, w, cfg, batch, drop: Drop):
    """→ (hidden [B, S, D], mask [B, S])."""
    ids = batch["input_ids"]
    B, L = ids.shape
    N = batch["vis_feats"].shape[1]
    eps = cfg["layer_norm_epsilon"]
    H = cfg["num_heads"]
    mask = torch.cat([(ids != 0).float(),
                      torch.ones(B, N, device=ids.device)], 1)
    x = torch.cat([w["shared"][ids],
                   visual(P, w["visual_embedding"], cfg, w["shared"],
                          batch["vis_feats"], batch["boxes"])], 1)
    S = L + N
    e = w["encoder"]
    bias = torch.zeros(H, S, S, device=ids.device)
    bias[:, :L, :L] = position_bias(e["rel_bias"], L, L, True, cfg)
    bias = bias[None] + ((1.0 - mask) * NEG)[:, None, None, :]
    x = drop(x)
    seeds = drop.seeds(cfg["num_layers"])
    for i in range(cfg["num_layers"]):
        p = e[f"block_{i}"]
        h = rms_norm(p["ln1"], x, eps)
        a = attention(P, p["attn"], h, h, bias, H, drop,
                      None if seeds is None else seeds[i:i + 1])
        x = x + drop(a)
        x = x + drop(mlp(P, p["mlp"], rms_norm(p["ln2"], x, eps), drop))
    return drop(rms_norm(e["final_ln"], x, eps)), mask


def _unit_tanh(x):
    t = torch.tanh(x)
    return t / t.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def similarities(bank, pooled):
    """Cosine of tanh between each pooled row and each bank row [B, C]."""
    return _unit_tanh(pooled) @ _unit_tanh(bank).t()


def update_banks(banks: Dict[str, torch.Tensor], pooled_q, pooled_v,
                 ql, cl, alpha: float, beta: float) -> Dict:
    """The VQACL prototype update for one batch (``banks`` holds q, v,
    q_mem, counts, the task id and the batches seen in this task):
    first batch of a task: V ← batch means, Q[task] ← its mean (all of
    Q in task 0); second: the memory bank starts from the batch means
    with the task's row zeroed; later: Q_mem ← α·Q_mem + (1 − α)·those;
    from the second batch on Q ← Q_mem with the task's row the batch
    mean, and V ← β·V + (1 − β)·batch means."""
    def means(pooled, lab):
        cnt = lab.sum(0)
        sums = lab.t() @ pooled.detach()
        return sums / torch.where(cnt <= 0, torch.ones_like(cnt),
                                  cnt)[:, None], cnt
    cur_q, nq = means(pooled_q, ql)
    cur_v, nv = means(pooled_v, cl)
    tid, step = banks["task"], banks["step"]
    row = (torch.arange(cur_q.shape[0], device=cur_q.device) == tid)[:, None]
    mem = torch.where(row, torch.zeros_like(cur_q), cur_q)
    out = dict(banks)
    if step == 0:
        out["q"] = cur_q if tid == 0 else torch.where(row, cur_q, banks["q"])
        out["v"] = cur_v
        out["nq"], out["nv"] = nq, nv
    else:
        q_mem = mem if step == 1 else \
            alpha * banks["q_mem"] + (1.0 - alpha) * mem
        out["q_mem"] = q_mem
        out["q"] = cur_q if tid == 0 else torch.where(row, cur_q, q_mem)
        out["v"] = beta * banks["v"] + (1.0 - beta) * cur_v
        out["nq"], out["nv"] = banks["nq"] + nq, banks["nv"] + nv
    out["step"] = step + 1
    return out


def pool(hidden, L):
    return hidden[:, :L].mean(1), hidden[:, L:].mean(1)


def append(hidden, mask, q_vec, v_vec):
    B = hidden.shape[0]
    return (torch.cat([hidden, q_vec.detach()[:, None],
                       v_vec.detach()[:, None]], 1),
            torch.cat([mask, torch.ones(B, 2, device=mask.device)], 1))


def decode(P, w, cfg, hidden, mask, labels, drop: Drop):
    """Teacher-forced decoder over ``labels`` (−100 padded) → hidden
    [B, T, D] before the head."""
    eps = cfg["layer_norm_epsilon"]
    H = cfg["num_heads"]
    B, T = labels.shape
    dec = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]], 1)
    dec = torch.where(dec == -100, torch.zeros_like(dec), dec)
    d = w["decoder"]
    causal = torch.tril(torch.ones(T, T, device=labels.device))
    self_bias = (position_bias(d["rel_bias"], T, T, False, cfg)
                 + (1.0 - causal) * NEG)[None]
    cross_bias = ((1.0 - mask) * NEG)[:, None, None, :]
    x = drop(w["shared"][dec])
    for i in range(cfg["num_decoder_layers"]):
        p = d[f"block_{i}"]
        h = rms_norm(p["ln1"], x, eps)
        x = x + drop(attention(P, p["attn"], h, h, self_bias, H, drop))
        h = rms_norm(p["ln2"], x, eps)
        x = x + drop(attention(P, p["cross_attn"], h, hidden, cross_bias,
                               H, drop))
        x = x + drop(mlp(P, p["mlp"], rms_norm(p["ln3"], x, eps), drop))
    return drop(rms_norm(d["final_ln"], x, eps))


def logits(P, w, cfg, seq):
    return P.mm(seq * cfg["d_model"] ** -0.5, w["shared"].t())


def weighted_loss(lg, labels, scores):
    """Per-token CE (−100 ignored) → mean over each row's tokens → × the
    row's answer score → mean over the rows."""
    m = (labels != -100).float()
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    nll = -torch.log_softmax(lg, -1).gather(-1, safe[..., None])[..., 0]
    per = (nll * m).sum(1) / m.sum(1).clamp_min(1.0)
    return (per * scores).mean()


def train_loss(P, w, cfg, batch, banks, drop: Drop, alpha, beta
               ) -> Tuple[torch.Tensor, Dict]:
    """One training forward → (loss, updated banks)."""
    hidden, mask = encode(P, w, cfg, batch, drop)
    pq, pv = pool(hidden, cfg["max_text_length"])
    banks = update_banks(banks, pq.detach(), pv.detach(),
                         batch["ques_labels"], batch["cate_labels"],
                         alpha, beta)
    q_vec = banks["q"][similarities(banks["q"], pq.detach()).argmax(-1)]
    v_vec = banks["v"][similarities(banks["v"], pv.detach()).argmax(-1)]
    hidden, mask = append(hidden, mask, q_vec, v_vec)
    seq = decode(P, w, cfg, hidden, mask, batch["target_ids"], drop)
    return weighted_loss(logits(P, w, cfg, seq), batch["target_ids"],
                         batch["scores"]), banks

