"""What every entry shares: the port's configuration built from a
configuration file, the data module the port's trainer reads, the
tokenizer, and the prototype state.

The port is imported here and in ``entries/``, never in ``reference/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import tempfile
import time
from typing import Any, Dict

import torch

from vqacl_tpu_torch.data.partition import VQAPartitionDataset
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.utils.config import Config, ModelConfig, TrainConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(config: Dict[str, Any], seed: int) -> Config:
    """The port's ``Config`` for a configuration file: its top-level model
    sizes, its ``train`` settings, the feature path and the seed (which
    seeds the trainer's group order, exemplars, loader shuffles and
    dropout)."""
    cfg = Config()
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    for k, v in config.items():
        if k in names:
            setattr(cfg.model, k, v)
    tnames = {f.name for f in dataclasses.fields(TrainConfig)}
    for k, v in config["train"].items():
        if k in tnames:
            setattr(cfg.train, k, v)
    cfg.train.seed = int(seed)
    cfg.train.adam_dtype = config["precision"]["adam_moments"]
    cfg.data.device_cache = config["feature_path"] == "device_cache"
    cfg.data.device_cache_dtype = config["precision"]["feature_table"]
    cfg.output = os.path.join(tempfile.gettempdir(), "portbench_out")
    cfg.verbose = False
    return cfg


def traffic(cell, seed: int, device):
    """The cell's traffic, made by the generator its mix names
    (``traffic/<generator>.py``)."""
    mod = importlib.import_module(
        f"portbench.traffic.{cell.traffic['generator']}")
    return mod.make(cell.traffic, cell.config, seed, device)


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    return DTYPES[config["precision"]["compute"]]


class DataModule:
    """The trainer's data module over the benchmark's traffic: the port's
    Partition_Q dataset (tokenizing, answer sampling, feature joins or
    device-cache slots) over the generated items and feature table."""

    def __init__(self, traffic, tokenizer, config: Dict[str, Any]):
        self.tok = tokenizer
        self.tasks = list(traffic.tasks)
        self.features = traffic.table
        self.cate_map = traffic.cate_map
        self.ques_map = traffic.ques_map
        self.category_splits = traffic.groups
        self._items = traffic.items
        self._L = config["max_text_length"]
        self._T = config["target_max_length"]

    def train_items(self, task: str):
        return self._items[task].get("train", [])

    def make_dataset(self, items, mode: str = "train", task_idx=None):
        return VQAPartitionDataset(items, self.tok, self.features,
                                   self.ques_map, self.cate_map,
                                   max_text_length=self._L,
                                   target_max_length=self._T, mode=mode,
                                   task_idx=task_idx)

    def dataset(self, task: str, split: str, task_idx=None):
        mode = "train" if split == "train" else "val"
        return self.make_dataset(self._items[task].get(split, []), mode,
                                 task_idx)


def tokenizer() -> VLT5Tokenizer:
    """The VL-T5 id space with the word-hash encoding (no sentencepiece
    file: none ships with the benchmark)."""
    return VLT5Tokenizer()


def proto_state(banks: Dict[str, torch.Tensor], task: int,
                config: Dict[str, Any], device) -> ProtoState:
    """The port's prototype state holding the benchmark's banks, at the
    start of task ``task``."""
    z = ProtoState.create(config["n_ques_types"], config["n_categories"],
                          config["d_model"], device=device)
    return z._replace(q_proto=banks["q_proto"].clone(),
                      v_proto=banks["v_proto"].clone(),
                      q_mem_proto=banks["q_mem_proto"].clone()
                      ).start_task(task)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def part(rec: Dict, name: str):
    """Adds the block's host seconds to ``rec["setup_parts"][name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        parts = rec.setdefault("setup_parts", {})
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
