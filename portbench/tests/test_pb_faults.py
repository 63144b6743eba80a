"""A run with the timed path broken underneath comes out not correct:
a step that returns its state unchanged, half of each batch left out
(the mean taken over the rest). The harness's look for a card is skipped (``execute`` on the
CPU); the limits are tight ones for float32 at tiny widths, which the
sound run meets."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

LIMITS = {"loss": 1e-5, "grad1": 8e-3, "change3": 1e-3}
SEED = 2 ** 31 + 99


def run(name, seconds=0.5):
    cell = tiny.cell(name, limits=LIMITS)
    out = harness.execute(cell, SEED, seconds, False, torch.device("cpu"),
                          0.0)
    ok, judged = harness.verdict(out["numbers"], cell.limits, out["rec"])
    return ok, judged


def broken_step(monkeypatch, how):
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    make = VQACLTrainer._train_step

    def patched(self, use_memory_loss):
        fn = make(self, use_memory_loss)

        def step(state, batch):
            if how == "unchanged":
                return state, fn(state, batch)[1]
            B = batch["input_ids"].shape[0]
            half = {k: v[:B // 2] if hasattr(v, "shape") and v.shape
                    and v.shape[0] == B else v for k, v in batch.items()}
            return fn(state, half)
        return step
    monkeypatch.setattr(VQACLTrainer, "_train_step", patched)


@pytest.mark.parametrize("name", ["vqa_cl_train", "nextqa_cl_train"])
def test_sound_train_run_is_correct(name):
    assert run(name)[0]


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_broken_train_step_is_not_correct(monkeypatch, how):
    broken_step(monkeypatch, how)
    ok, judged = run("vqa_cl_train")
    assert not ok, judged

