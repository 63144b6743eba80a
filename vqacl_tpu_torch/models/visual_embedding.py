"""Region-feature visual embedding (counterpart of
``vqacl_tpu/models/visual_embedding.py``).

Projects region features plus box geometry (x1,y1,x2,y2,area) into
d_model, adds image-order and object-order embeddings (object order
indexes the top of the shared vocab — the ``<vis_extra_id_i>`` rows),
with per-stream T5 layer norms.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from vqacl_tpu_torch.models.t5 import layer_norm

Params = Dict[str, Any]


def apply_visual_embedding(p: Params, cfg, shared: torch.Tensor,
                           feats: torch.Tensor, boxes: torch.Tensor,
                           img_order_ids: Optional[torch.Tensor] = None,
                           obj_order_ids: Optional[torch.Tensor] = None,
                           dtype=torch.float32) -> torch.Tensor:
    """feats [B,N,feat_dim], boxes [B,N,4] (x1,y1,x2,y2 in [0,1]) → [B,N,D].

    The box area keeps the reference VL-T5 index convention
    (height = pos[...,3]-pos[...,2], width = pos[...,1]-pos[...,0]),
    which with (x1,y1,x2,y2) boxes computes (y2-x2)*(y1-x1): a quirk
    kept on purpose so the numbers match."""
    N = feats.shape[1]
    feats = feats.to(dtype)
    boxes = boxes.to(dtype)

    feat_emb = feats @ p["feat_w"].to(dtype) + p["feat_b"].to(dtype)
    if "feat_ln" in p:
        feat_emb = layer_norm(p["feat_ln"], feat_emb, cfg.layer_norm_epsilon)

    area = (boxes[:, :, 3] - boxes[:, :, 2]) * (boxes[:, :, 1] - boxes[:, :, 0])
    pos = torch.cat([boxes, area[..., None]], dim=2)            # [B,N,5]
    pos_emb = pos @ p["pos_w"].to(dtype) + p["pos_b"].to(dtype)
    if "pos_ln" in p:
        pos_emb = layer_norm(p["pos_ln"], pos_emb, cfg.layer_norm_epsilon)

    vis = feat_emb + pos_emb

    if cfg.use_vis_order_embedding:
        if img_order_ids is None:
            img_order_ids = torch.zeros((1, N), dtype=torch.long,
                                        device=feats.device)
        vis = vis + p["img_order"].to(dtype)[img_order_ids.long()]
        # object order i → vocab row (V - i - 1): the <vis_extra_id_*>
        # block at the top of the shared embedding
        if obj_order_ids is None:
            rows = shared[cfg.vocab_size - N:cfg.vocab_size].flip(0)
            vis = vis + rows[None].to(dtype)
        else:
            inv_ids = cfg.vocab_size - obj_order_ids.long() - 1
            vis = vis + shared[inv_ids].to(dtype)

    if "joint_ln" in p:
        vis = layer_norm(p["joint_ln"], vis, cfg.layer_norm_epsilon)
    return vis
