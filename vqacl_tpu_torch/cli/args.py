"""argparse → Config bridge (counterpart of ``vqacl_tpu/cli/args.py``).

Covers the behaviorally-live flags of the reference CLI
(VL-T5/src/param.py:54-218; see SURVEY §5 for the live
subset) with the same spellings, so reference launch commands translate
1:1, plus the JAX package's mesh/dtype knobs, every one with its
spelling and default. Two flags name the card instead of the TPU:

- ``--platform`` is ``auto`` (the CUDA card, through ``resolve_device``,
  which raises when there is none: ``auto`` never means the CPU),
  ``cuda`` or ``cpu``;
- ``--fused_attention`` ``auto``/``on`` → True (the hand-written kernels
  on CUDA tensors, their plain versions on CPU tensors), ``off`` → False
  (the unfused attention).

The mesh flags fill ``MeshConfig``: ``--mesh_dp``, ``--mesh_tp`` and
``--mesh_pp`` (the ranks ``torchrun`` starts, laid out as JAX's (dp, tp,
pp) mesh), ``--pp_micro`` and ``--param_layout`` ("replicated", "tp" or
"fsdp").
"""

from __future__ import annotations

import argparse
import signal
from typing import Optional, Sequence

import torch

from vqacl_tpu_torch.utils.config import Config
from vqacl_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vqacl_tpu_torch")
    # data
    p.add_argument("--dataset_root", default="datasets")
    p.add_argument("--train", default="karpathy_train")
    p.add_argument("--valid", default="karpathy_val")
    p.add_argument("--test", default="karpathy_test")
    p.add_argument("--train_topk", type=int, default=-1)
    p.add_argument("--valid_topk", type=int, default=-1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device_cache", action="store_true",
                   help="preload all region features to the device; "
                        "batches carry slot indices")
    p.add_argument("--device_cache_dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="device feature-table storage: bf16 (bit-exact vs host pipeline), f32, or int8 (per-row symmetric quant, half the memory, <=0.4%% of row peak error)")
    p.add_argument("--device_cache_sharded", action="store_true",
                   help="row-shard the device feature table over the dp "
                        "ranks")
    # model
    p.add_argument("--backbone", default="t5-base")
    p.add_argument("--tokenizer", default=None,
                   help="path to spiece.model (fallback tokenizer if unset)")
    p.add_argument("--n_boxes", type=int, default=36)
    p.add_argument("--max_text_length", type=int, default=20)
    p.add_argument("--gen_max_length", type=int, default=20)
    p.add_argument("--use_vision", action="store_true", default=True)
    p.add_argument("--use_vis_order_embedding", action="store_true",
                   default=True)
    p.add_argument("--use_vis_layer_norm", action="store_true", default=True)
    p.add_argument("--individual_vis_layer_norm", action="store_true",
                   default=True)
    # training
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--adam_eps", type=float, default=1e-6)
    p.add_argument("--adam_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="Adam moment storage (arithmetic is always f32); "
                        "float32 gives bit-exact reference-AdamW parity, "
                        "bfloat16 (default) halves optimizer memory traffic")
    p.add_argument("--fused_attention", default="auto",
                   choices=["auto", "on", "off"],
                   help="encoder attention through the fused CUDA "
                        "kernels (auto, on: yes; off: the unfused "
                        "attention); CPU tensors take the kernels' plain "
                        "versions")
    p.add_argument("--fused_decoder", action="store_true",
                   help="the fused kernels for the TRAIN decoder too "
                        "(off by default, as in the JAX package)")
    p.add_argument("--folded_cross_kv", action="store_true",
                   help="fold all decoder layers' cross K/V projections "
                        "into one GEMM (off by default, as in the JAX "
                        "package; for deep decoders)")
    p.add_argument("--adam_impl", default="hf", choices=["hf", "torch"],
                   help="AdamW direction: hf = reference's transformers "
                        "4.2.1 AdamW (eps inside, correction in step "
                        "size); torch = optax/torch m-hat/(sqrt(v-hat)+eps)")
    p.add_argument("--clip_grad_norm", type=float, default=5.0)
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="the device: auto and cuda = the CUDA card (an "
                        "error without one), cpu = the plain PyTorch path "
                        "on the host")
    p.add_argument("--gradient_accumulation_steps", "--grad_accum",
                   dest="grad_accum", type=int, default=1,
                   help="microbatches per optimizer step (reference flag, param.py:108; here it actually accumulates)")
    p.add_argument("--batch_size", type=int, default=80)
    p.add_argument("--valid_batch_size", type=int, default=100)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--seed", type=int, default=66666)
    p.add_argument("--from_scratch", action="store_true")
    p.add_argument("--freeze", action="store_true")
    # continual learning
    p.add_argument("--memory", action="store_true")
    p.add_argument("--m_size", type=int, default=5000)
    p.add_argument("--comp_cate", default="G-1")
    p.add_argument("--now_train", action="store_true")
    p.add_argument("--checkpoint", default="None",
                   help="task name to resume after")
    p.add_argument("--proto_alpha", type=float, default=0.5)
    p.add_argument("--proto_beta", type=float, default=0.3)
    p.add_argument("--use_memory_loss", action="store_true",
                   help="enable the SI regularizer (dead in the shipped "
                        "reference; this trains the paper's full objective)")
    p.add_argument("--lambda_Q", type=float, default=0.01)
    p.add_argument("--lambda_V", type=float, default=0.1)
    p.add_argument("--lambda_Q_new", type=float, default=0.0)
    p.add_argument("--lambda_V_new", type=float, default=0.0)
    p.add_argument("--cl_reg",
                   choices=["none", "ewc", "mas", "der", "derpp"],
                   default="none",
                   help="CL baseline (Table-1 comparison methods; not in "
                        "the reference repo): EWC/MAS parameter-importance "
                        "penalties, DER/DER++ logit-replay distillation")
    p.add_argument("--reg_lambda", type=float, default=1.0,
                   help="EWC/MAS penalty weight λ / DER distillation α")
    p.add_argument("--fisher_batches", type=int, default=40,
                   help="importance-estimation batches per task")
    p.add_argument("--der_beta", type=float, default=0.5,
                   help="DER++ ground-truth CE weight β on replay batches")
    p.add_argument("--use_class_hierarchy", action="store_true", default=True)
    # output
    p.add_argument("--output", default="snap/vqacl")
    p.add_argument("--tiny_model", action="store_true",
                   help="scaled-down architecture (CI/e2e smoke)")
    # placement over the torchrun ranks (parallel/mesh.py)
    p.add_argument("--mesh_dp", type=int, default=-1)
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--mesh_pp", type=int, default=1,
                   help="pipeline-parallel stages (GPipe microbatching "
                        "over a pp mesh axis; num_layers must divide)")
    p.add_argument("--pp_micro", type=int, default=4,
                   help="pipeline microbatches per step")
    p.add_argument("--param_layout", default="replicated",
                   choices=["replicated", "tp", "fsdp"],
                   help="parameter placement: replicated (reference DDP "
                        "semantics), tp (Megatron head/hidden sharding), "
                        "fsdp (ZeRO-3-style dp sharding)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true")
    return p


def install_cli_runtime(cli) -> None:
    """Shared CLI preamble for the training entry points: SIGTERM
    (eviction, maintenance, timeout(1)) raises SystemExit(143) in the main
    thread, which the CL trainer's BaseException handler turns into an
    emergency checkpoint before exiting (cl/trainer.py). Kernels build on
    their first launch, so there is no compile cache to set."""

    def _graceful_term(signum, frame):
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, _graceful_term)
    except ValueError:        # not the main thread (library use)
        pass


def platform_device(platform: str) -> torch.device:
    """``--platform`` → the device: ``auto`` and ``cuda`` the card (a
    RuntimeError without one, never the CPU), ``cpu`` the host."""
    return resolve_device("cpu" if platform == "cpu" else "cuda")


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config()
    if args.tiny_model:
        from vqacl_tpu_torch.utils.config import tiny_model_config
        cfg.model = tiny_model_config(vocab_size=32200, feat_dim=2048,
                                      n_boxes=36, max_text_length=20,
                                      target_max_length=10)
    m, t, me, d = cfg.model, cfg.train, cfg.mesh, cfg.data
    m.n_boxes = args.n_boxes
    m.max_text_length = args.max_text_length
    m.gen_max_length = args.gen_max_length
    m.use_vis_order_embedding = args.use_vis_order_embedding
    m.use_vis_layer_norm = args.use_vis_layer_norm
    m.individual_vis_layer_norm = args.individual_vis_layer_norm
    t.lr = args.lr
    t.warmup_ratio = args.warmup_ratio
    t.weight_decay = args.weight_decay
    t.adam_eps = args.adam_eps
    t.adam_dtype = args.adam_dtype
    cfg.model.fused_attention = {"auto": True, "on": True,
                                 "off": False}[args.fused_attention]
    m.fused_decoder = args.fused_decoder
    m.folded_cross_kv = args.folded_cross_kv
    t.adam_impl = args.adam_impl
    t.clip_grad_norm = args.clip_grad_norm
    t.grad_accum = args.grad_accum
    t.batch_size = args.batch_size
    t.valid_batch_size = args.valid_batch_size
    t.epochs = args.epochs
    t.seed = args.seed
    t.from_scratch = args.from_scratch
    t.freeze = args.freeze
    t.memory = args.memory
    t.m_size = args.m_size
    t.comp_cate = args.comp_cate
    t.proto_alpha = args.proto_alpha
    t.proto_beta = args.proto_beta
    t.use_memory_loss = args.use_memory_loss
    t.lambda_Q = args.lambda_Q
    t.lambda_V = args.lambda_V
    t.lambda_Q_new = args.lambda_Q_new
    t.lambda_V_new = args.lambda_V_new
    t.cl_reg = args.cl_reg
    t.reg_lambda = args.reg_lambda
    t.fisher_batches = args.fisher_batches
    t.der_beta = args.der_beta
    me.dp = args.mesh_dp
    me.tp = args.mesh_tp
    me.pp = args.mesh_pp
    me.pp_micro = args.pp_micro
    me.param_layout = args.param_layout
    me.dtype = args.dtype
    me.remat = args.remat
    d.dataset_root = args.dataset_root
    d.train_split = args.train
    d.valid_split = args.valid
    d.test_split = args.test
    d.train_topk = args.train_topk
    d.valid_topk = args.valid_topk
    d.n_workers = args.num_workers
    d.device_cache = args.device_cache
    d.device_cache_sharded = args.device_cache_sharded
    d.device_cache_dtype = args.device_cache_dtype
    cfg.output = args.output
    cfg.backbone = args.backbone
    cfg._cli = args  # stash for entry points
    return cfg
