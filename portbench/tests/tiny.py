"""Tiny versions of the benchmark's cells for the CPU tests: the cell's
own files with the model cut to a few hundred thousand parameters (the
vocabulary kept: the tokenizer's ids span it), the traffic and batches
cut to match, and float32 compute unless asked otherwise."""

from __future__ import annotations

import copy
from typing import Dict, Optional

from portbench import spec

MODEL = dict(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2,
             num_decoder_layers=2, relative_attention_num_buckets=8,
             relative_attention_max_distance=16, feat_dim=16)


def cell(name: str, compute: str = "float32",
         limits: Optional[Dict[str, float]] = None) -> spec.Cell:
    c = spec.load(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(MODEL)
    cfg["n_boxes"] = min(cfg["n_boxes"], 4)
    cfg["max_text_length"] = min(cfg["max_text_length"], 8)
    cfg["target_max_length"] = min(cfg["target_max_length"], 5)
    cfg["gen_max_length"] = 6
    cfg["precision"] = dict(cfg["precision"], compute=compute)
    cfg["train"] = dict(cfg["train"], batch_size=8, valid_batch_size=8,
                        m_size=40)
    mix = copy.deepcopy(c.traffic)
    mix["images"] = 64
    mix["splits"] = [dict(s, qa=min(s["qa"], 160 if s["split"] == "train"
                                    else 24)) for s in mix["splits"]]
    wl = copy.deepcopy(c.workload)
    wl["params"] = dict(wl.get("params", {}), trace_pairs=1)
    if limits is not None:
        wl["limits"] = limits
    return spec.Cell(name, wl, cfg, mix, c.end_to_end, c.per_layer)
