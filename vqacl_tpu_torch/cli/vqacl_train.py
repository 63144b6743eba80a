"""VQACL training entry point (counterpart of
``vqacl_tpu/cli/vqacl_train.py``; reference: scripts/VQACL_train.sh →
src/vqacl.py; comp variant: scripts/VQACL_COMP_train.sh → vqacl_comp.py).

    python -m vqacl_tpu_torch.cli.vqacl_train --memory --m_size 5000 \
        --comp_cate G-1 --now_train --from_scratch --output snap/vqacl

Runs on the CUDA card; ``--platform cpu`` runs the plain PyTorch path on
the host. Eval-only (the reference's ``VQACL.sh`` without
``--now_train``): omit ``--now_train`` to run ``Test()`` over saved
per-task checkpoints. Data parallel over N ranks, one card each (NCCL;
gloo on the CPU), as the reference's DDP launch, and tensor and pipeline
parallel over the same ranks (N = dp·tp·pp):

    torchrun --nproc_per_node=N -m vqacl_tpu_torch.cli.vqacl_train \
        --mesh_dp N [--param_layout fsdp] [--device_cache_sharded] ...
    torchrun --nproc_per_node=8 -m vqacl_tpu_torch.cli.vqacl_train \
        --mesh_tp 2 --mesh_pp 2 --pp_micro 4 --param_layout tp ...
"""

from __future__ import annotations

import sys

import torch

from vqacl_tpu_torch.cli.args import (install_cli_runtime, parse_config,
                                      platform_device)
from vqacl_tpu_torch.cl.comp_trainer import CompVQACLTrainer, comp_enabled
from vqacl_tpu_torch.cl.tasks import CATEGORY_SPLITS
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.data.vqa_module import VQADataModule
from vqacl_tpu_torch.parallel.mesh import make_mesh


def compute_dtype(cfg) -> torch.dtype:
    """``--dtype`` → the trainer's compute dtype."""
    return torch.bfloat16 if cfg.mesh.dtype == "bfloat16" else torch.float32


def load_backbone(cfg):
    """The start of the JAX CLI (vqacl_train.py:41-52): without
    ``--from_scratch`` and ``--tiny_model``, the ``--backbone`` weights
    through ``load_t5_base`` (local files only); if that fails, it says
    so and the trainer starts from its seeded random init (None).

    A vanilla t5-base file holds no visual embedding. The reference
    VL-T5 starts a fresh one on top of t5-base; the JAX CLI hands its
    trainer the tree without it, which no forward can run. Here the
    missing embedding is the seeded random init's."""
    cli = cfg._cli
    # --tiny_model never loads the t5-base backbone: the shapes cannot match
    if cfg.train.from_scratch or not cfg.backbone \
            or getattr(cli, "tiny_model", False):
        return None
    from vqacl_tpu_torch.models.hf_import import load_t5_base
    try:
        init_params = load_t5_base(cfg.model, cfg.backbone)
        print(f"loaded pretrained backbone {cfg.backbone}")
    except Exception as e:  # no local weights: train from scratch
        print(f"pretrained load failed ({e}); training from scratch")
        return None
    if "visual_embedding" not in init_params:
        from vqacl_tpu_torch.models.vlt5 import init_vlt5_params

        init_params["visual_embedding"] = init_vlt5_params(
            cfg.train.seed, cfg.model, device="cpu")["visual_embedding"]
        print("the backbone has no visual embedding: starting a fresh one")
    return init_params


def cli_mesh(cfg):
    """The mesh of ``--mesh_dp/--mesh_tp/--mesh_pp`` (JAX's CLI calls
    ``make_mesh`` the same way, vqacl_train.py:38) on the device of
    ``--platform``: the card of this rank (``LOCAL_RANK``) or the CPU."""
    device = platform_device(cfg._cli.platform)
    return make_mesh(dp=cfg.mesh.dp, tp=cfg.mesh.tp, pp=cfg.mesh.pp,
                     device=None if device.type == "cuda" else device)


def make_trainer(cfg, data=None):
    """The trainer ``main`` runs, from a parsed config: the tokenizer of
    ``--tokenizer``, ``VQADataModule`` over ``--dataset_root`` (unless
    ``data`` is given), the backbone start, the class by
    ``comp_enabled(comp_cate, CATEGORY_SPLITS)`` and the mesh
    (``cli_mesh``) on the device of ``--platform``."""
    cli = cfg._cli
    ctx = cli_mesh(cfg)
    tok = VLT5Tokenizer(vocab_file=cli.tokenizer)
    if data is None:
        data = VQADataModule(cfg.data.dataset_root, tok,
                             train_split=cfg.data.train_split,
                             valid_split=cfg.data.valid_split,
                             test_split=cfg.data.test_split,
                             train_topk=cfg.data.train_topk,
                             valid_topk=cfg.data.valid_topk,
                             seed=cfg.train.seed)
    init_params = load_backbone(cfg)
    cls = CompVQACLTrainer if comp_enabled(cli.comp_cate, CATEGORY_SPLITS) \
        else VQACLTrainer
    return cls(cfg, data, tok, device=ctx.device, init_params=init_params,
               dtype=compute_dtype(cfg), mesh_ctx=ctx)


def run(trainer, cli):
    """``train(resume_task=--checkpoint)`` with ``--now_train``, else
    ``Test()``."""
    if cli.now_train:
        resume = None if cli.checkpoint in ("None", None) else cli.checkpoint
        return trainer.train(resume_task=resume)
    metrics = trainer.Test()
    print(metrics)
    return metrics


def main(argv=None):
    cfg = parse_config(argv)
    install_cli_runtime(cfg._cli)
    return run(make_trainer(cfg), cfg._cli)


if __name__ == "__main__":
    main(sys.argv[1:])
