"""Novel-composition evaluation trainer (counterpart of
``vqacl_tpu/cl/comp_trainer.py``).

The reference's ``VL-T5/src/vqacl_comp.py`` (a delta over vqacl.py):
during training one category group (``comp_cate``, G5 in the published
runs) is held out of every task except the first trained one; after each
task the model is also evaluated on

- the COMP matrix: only the held-out group's test questions, novel
  (question-type × object-group) compositions never seen together in
  training (vqacl_comp.py:568-579);
- the NONCOMP matrix: the other four groups, aggregated weighted by
  their question counts (vqacl_comp.py:613-645).

Final metrics are the standard pair plus comp/noncomp Avg-Acc/Forget
(vqacl_comp.py:737-764).
"""

from __future__ import annotations

import json
import os
from typing import Dict

from vqacl_tpu_torch.cl.metrics import ResultMatrix, evaluate_metric
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.partition import group_loaders


def comp_enabled(comp_cate: str, splits: Dict) -> bool:
    """The reference's comp-test gate is *key membership*, not a G-1
    sentinel: ``if self.composition_test_cate in Category_splits``
    (nextqa_CL.py:421-423). Any value that is not a group key — the
    shipped ``--comp_cate G-1`` included — disables comp/noncomp
    testing."""
    return comp_cate in splits


class CompVQACLTrainer(VQACLTrainer):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.result_matrix_comp = ResultMatrix(self.tasks)
        self.result_matrix_noncomp = ResultMatrix(self.tasks)
        self._test_group_loaders: Dict[str, Dict] = {}

    def _group_test_loaders(self, task: str, task_idx: int):
        if task not in self._test_group_loaders:
            ds = self._slotify(self.data.dataset(task, "test",
                                                 task_idx=task_idx))
            self._test_group_loaders[task] = group_loaders(
                ds, self.cfg.train.valid_batch_size, shuffle=False,
                with_targets=False, collate_kw=self._ck(),
                splits=self.splits)
        return self._test_group_loaders[task]

    def test(self, task: str, load: bool = False) -> None:
        super().test(task, load=load)
        comp_g = self.cfg.train.comp_cate
        trained_upto = self.tasks.index(task)
        for j in range(trained_upto + 1):
            test_task = self.tasks[j]
            loaders = self._group_test_loaders(test_task, j)
            # composition: held-out group only
            if comp_g in loaders and loaders[comp_g].num_examples > 0:
                acc = self.evaluate(loaders[comp_g],
                                    test_task).get("overall", 0.0)
                self.result_matrix_comp.record(task, test_task, acc)
                self._log(f"   comp[{task}→{test_task}] = {acc:.2f}")
            # non-composition: other groups, weighted by size
            # (vqacl_comp.py:613-645)
            total, weighted = 0, 0.0
            for g, loader in loaders.items():
                if g == comp_g or loader.num_examples == 0:
                    continue
                acc = self.evaluate(loader, test_task).get("overall", 0.0)
                weighted += acc * loader.num_examples
                total += loader.num_examples
            if total > 0:
                acc = weighted / total
                self.result_matrix_noncomp.record(task, test_task, acc)
                self._log(f"   noncomp[{task}→{test_task}] = {acc:.2f}")

    def train(self, resume_task=None) -> Dict:
        metrics = super().train(resume_task=resume_task)
        comp = evaluate_metric(self.result_matrix_comp.to_dict())
        noncomp = evaluate_metric(self.result_matrix_noncomp.to_dict())
        out = {
            "standard": metrics,
            "comp": comp,
            "noncomp": noncomp,
        }
        with open(os.path.join(self.cfg.output, "metrics_comp.json"),
                  "w") as f:
            json.dump(out, f, indent=2, default=float)
        self._log(f"COMP Avg_acc {comp['Avg_acc']:.2f} "
                  f"Forget {comp['Avg_forget']:.2f} | "
                  f"NONCOMP Avg_acc {noncomp['Avg_acc']:.2f}")
        return out
