"""Eval step (counterpart of ``vqacl_tpu/train/step.py::make_eval_step``).

encode once → prototype retrieval without update → greedy decode. The
train step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from vqacl_tpu_torch.models import vlt5
from vqacl_tpu_torch.models.generate import greedy_decode
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.utils.device import resolve_device

_BATCH_KEYS = ("input_ids", "vis_feats", "boxes")


def make_eval_step(cfg, dtype=torch.bfloat16, device="cuda") -> Callable:
    """Returns ``(params, proto, batch) -> token ids [B, gen_max_length-1]``
    (int32, on ``device``). ``params``/``proto`` must already be on
    ``device``; ``batch`` holds ``input_ids``, ``vis_feats`` and ``boxes``
    as numpy arrays or tensors (moved to ``device`` here)."""
    dev = resolve_device(device)
    mcfg = cfg.model

    def to_dev(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dev, non_blocking=True)

    @torch.inference_mode()
    def eval_step(params: Dict, proto: ProtoState, batch: Dict
                  ) -> torch.Tensor:
        ids, feats, boxes = (to_dev(batch[k]) for k in _BATCH_KEYS)
        hidden, enc_mask = vlt5.encode(params, mcfg, ids, feats, boxes,
                                       dtype=dtype)
        if mcfg.use_prototype:
            hidden, enc_mask = vlt5.augment(mcfg, hidden, enc_mask, proto)
        return greedy_decode(params, mcfg, hidden, enc_mask, dtype=dtype)

    return eval_step
