"""NExT-QA continual-learning entry point (counterpart of
``vqacl_tpu/cli/nextqa_train.py``; reference: nextqa/train.sh →
nextqa/nextqa_CL.py).

    python -m vqacl_tpu_torch.cli.nextqa_train --dataset_root /path/nextqa \
        --memory --m_size 500 --proto_alpha 0.3 --proto_beta 0.5 \
        --seed 6666 --now_train --output snap/nextqa

Runs on the CUDA card; ``--platform cpu`` runs the plain PyTorch path on
the host; ``torchrun --nproc_per_node=N ... --mesh_dp/--mesh_tp/
--mesh_pp`` runs data, tensor and pipeline parallel, as
``cli/vqacl_train.py`` does. The CSV partitions and
``app_mot_*.h5`` features of ``from_root`` need ``h5py``;
``NextQADataModule``'s constructor over tables does not.
"""

from __future__ import annotations

import os
import sys

from vqacl_tpu_torch.cli.args import install_cli_runtime, parse_config
from vqacl_tpu_torch.cli.vqacl_train import cli_mesh, compute_dtype, run
from vqacl_tpu_torch.cl.comp_trainer import CompVQACLTrainer, comp_enabled
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
from vqacl_tpu_torch.nextqa.data import (ANS_LEN, N_CLIPS, NEXTQA_SPLITS,
                                         TEXT_LEN, NextQADataModule)


def nextqa_geometry(cfg) -> None:
    """NExT-QA geometry (nextqa_data.py:172-207) + linear LR schedule
    (nextqa/trainer_base.py:207), in place: 23 text + 16 clip encoder
    positions, 6 answer tokens, 8 question types, and no λ memory-loss
    terms (the nextqa train_step has none, nextqa_CL.py:445)."""
    cfg.model.max_text_length = TEXT_LEN
    cfg.model.n_boxes = N_CLIPS
    cfg.model.target_max_length = ANS_LEN
    cfg.model.n_ques_types = 8
    cfg.train.schedule = "linear_warmup"
    cfg.train.lambda_Q = 0.0
    cfg.train.lambda_V = 0.0


def make_trainer(cfg, data=None):
    """The trainer ``main`` runs, from a parsed config with the NExT-QA
    geometry applied: ``NextQADataModule.from_root`` over
    ``--dataset_root`` (unless ``data`` is given) and the class by the
    comp gate on the 1-based ``NEXTQA_SPLITS``: nextqa_CL.py runs
    comp/noncomp tests per task iff comp_cate is a real group key
    (:421-423), so the shipped G-1 disables them."""
    cli = cfg._cli
    ctx = cli_mesh(cfg)
    tok = VLT5Tokenizer(vocab_file=cli.tokenizer)
    if data is None:
        data = NextQADataModule.from_root(
            cfg.data.dataset_root, tok,
            add_reference_path=os.path.join(cfg.data.dataset_root,
                                            "add_reference_answer_test.json"))
    cls = CompVQACLTrainer if comp_enabled(cli.comp_cate, NEXTQA_SPLITS) \
        else VQACLTrainer
    return cls(cfg, data, tok, device=ctx.device, dtype=compute_dtype(cfg),
               mesh_ctx=ctx)


def main(argv=None):
    cfg = parse_config(argv)
    install_cli_runtime(cfg._cli)
    nextqa_geometry(cfg)
    return run(make_trainer(cfg), cfg._cli)


if __name__ == "__main__":
    main(sys.argv[1:])
