"""``cl_train``: the in-group steady state of a continual-learning task.

Set-up builds the port's ``VQACLTrainer`` over the generated data with the
benchmark's weights and prototype banks, then does what
``cl/trainer.py::train_task`` does before its inner loop for task
``task_index``: the exemplar buffer rebuilt from the previous task's
items, the group loaders over the task's train items and over the
exemplars (``data/partition.py::group_loaders``), the seeded group order,
whose first group with both train and replay items is the cell's group,
and a fresh optimizer for it. The loop is the inner loop's: a train
batch and a replay batch from ``zip(train, cycle(memory))``, each through
the trainer's train step (``_train_step``, through the device cache when
the configuration has one), the losses kept on the device and drained at
each epoch's end. An epoch that ends starts the next of the same group;
validation is not run.

The first three steps (train, replay, train) are the run's first: the
program's losses, each leaf's first gradient (read back from the Adam
moment after step 1: m₁ = (1 − β₁)·g) and each leaf's change over the
three steps (against the weights made again from the seed, before step
4) are kept for the check. Step 4 and ``warm_pairs`` more pairs finish
the warm-up. The window then runs pairs until ``seconds`` have passed
and waits for the card.
"""

from __future__ import annotations

import itertools
import math
import statistics
import time
from typing import Dict, List

import torch

from portbench import common, weights as W
from portbench.trace import label, sub_window
from vqacl_tpu_torch.cl.tasks import random_dic
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.partition import group_loaders
from vqacl_tpu_torch.parallel.mesh import shard_batch


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.rec: Dict = {}
        self.loader_s = 0.0
        self.rows = 0
        self.steps = 0
        self.pend: List[torch.Tensor] = []
        self.losses: List[float] = []

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        c, dev = self.cell.config, self.device
        cfg = common.port_config(c, self.seed)
        with common.part(self.rec, "traffic"):
            self.traffic = common.traffic(self.cell, self.seed, dev)
        tok = common.tokenizer()
        data = common.DataModule(self.traffic, tok, c)
        with common.part(self.rec, "weights"):
            params = W.make_weights(c, self.seed, dev)
            self.banks = W.make_banks(c, self.seed, dev)
        with common.part(self.rec, "trainer"):
            tr = VQACLTrainer(cfg, data, tok, verbose=False, device=dev,
                              init_params=params,
                              dtype=common.compute_dtype(c))
        del params
        self.tr = tr
        t = int(self.cell.param("task_index", 1))
        self.task = t
        task = tr.tasks[t]
        tr.buffer.update(t, data.train_items(tr.tasks[t - 1]),
                         data.cate_map, tr.py_rng)
        train_ds = tr._slotify(data.dataset(task, "train", task_idx=t))
        mem_ds = tr._slotify(data.make_dataset(tr.buffer.all_examplars(),
                                               mode="train", task_idx=t))
        bs, nw = cfg.train.batch_size, int(cfg.data.n_workers)
        tls = group_loaders(train_ds, bs, shuffle=True, seed=cfg.train.seed,
                            collate_kw=tr._ck(), splits=tr.splits,
                            num_workers=nw)
        mls = group_loaders(mem_ds, bs, shuffle=True,
                            seed=cfg.train.seed + 7, collate_kw=tr._ck(),
                            splits=tr.splits, num_workers=nw)
        tr.state = tr.state._replace(
            proto=common.proto_state(self.banks, t, c, dev))
        order = random_dic({g: None for g in tls}, tr.py_rng)
        self.group = next(g for g in order if tls[g].num_examples > 0
                          and mls[g].num_examples > 0)
        self.tl, self.ml = tls[self.group], mls[self.group]
        tr._reset_optimizer(2 * self.tl.num_examples)
        use_mem = bool(cfg.train.use_memory_loss and cfg.train.memory
                       and cfg.model.use_prototype)
        self.step_fn = tr._train_step(use_mem)
        self.accum = int(cfg.train.grad_accum)
        self.pairs = self._epochs()

        # the first three steps, kept for the check
        t_steps = time.perf_counter()
        b1, m1 = next(self.pairs)
        l1 = self._step("train", b1)
        b1m = 1.0 - cfg.train.adam_beta1
        grad1 = [float(m.float().norm()) / b1m
                 for _, m in W.flatten(tr.state.opt_state.mu)]
        l2 = self._step("replay", m1)
        b2, m2 = next(self.pairs)
        l3 = self._step("train", b2)
        p0 = W.make_weights(c, self.seed, dev)
        change = [float((p - a).norm()) for (_, p), (_, a) in
                  zip(W.flatten(tr.state.params), W.flatten(p0))]
        del p0
        self.first = {
            "loss": [float(x) for x in (l1, l2, l3)], "grad1": grad1,
            "change": change,
            "steps": [(list(b["meta"]["question_ids"]),
                       b["tensors"]["input_ids"].shape[0])
                      for b in (b1, m1, b2)]}
        self._step("replay", m2)
        for _ in range(int(self.cell.param("warm_pairs", 1))):
            self._pair(*next(self.pairs))
        common.sync(dev)
        self.rec.setdefault("setup_parts", {})["steps"] = \
            time.perf_counter() - t_steps

    def _epochs(self):
        """The inner loop's (train, replay) batches, epoch after epoch;
        the host seconds blocked in ``next`` go to ``loader_s``."""
        while True:
            it = zip(self.tl, itertools.cycle(self.ml))
            while True:
                t0 = time.perf_counter()
                with label("loader"):
                    nxt = next(it, None)
                self.loader_s += time.perf_counter() - t0
                if nxt is None:
                    break
                yield nxt
            self._drain()

    def _drain(self) -> None:
        """The epoch-end read of the losses kept on the device."""
        if self.pend:
            self.losses += torch.stack(self.pend).float().tolist()
            self.pend = []

    def _step(self, kind: str, batch) -> torch.Tensor:
        tr = self.tr
        with label(f"{kind}_step"):
            tr.state, m = self.step_fn(tr.state, shard_batch(
                tr.ctx, batch["tensors"], self.accum))
        self.pend.append(m["loss"])
        self.rows += int(batch["meta"]["n_real"])
        self.steps += 1
        return m["loss"]

    def _pair(self, batch, mem) -> None:
        self._step("train", batch)
        self._step("replay", mem)

    # -- the window ----------------------------------------------------
    def window(self, seconds: float) -> Dict:
        from portbench import flops
        self._drain()
        self.losses = []
        rows0, steps0, load0 = self.rows, self.steps, self.loader_s
        cpu0 = (time.thread_time(), time.process_time())
        t0 = time.perf_counter()
        deadline = t0 + seconds
        ends = [t0]
        while ends[-1] < deadline:
            self._pair(*next(self.pairs))
            ends.append(time.perf_counter())
        common.sync(self.device)
        wall = time.perf_counter() - t0
        cpu = (time.thread_time() - cpu0[0], time.process_time() - cpu0[1])
        self._drain()
        rows = self.rows - rows0
        pair_s = [b - a for a, b in zip(ends, ends[1:])]
        # the host's side of the window, for the diagnostics on stderr:
        # the launching thread's and the process's CPU seconds, and the
        # spread of the pairs' host times
        self.rec["host"] = {
            "main_cpu_s": cpu[0], "process_cpu_s": cpu[1],
            "pair_s_q10_q50_q90": statistics.quantiles(pair_s, n=10)[::4]
            if len(pair_s) > 1 else pair_s}
        self.rec.update(
            window_s=wall, rows=rows, steps=self.steps - steps0,
            loader_s=self.loader_s - load0,
            flops=rows * flops.train_qa(self.cell.config),
            attempted=self.steps - steps0,
            failed=sum(not math.isfinite(x) for x in self.losses))
        return self.rec

    def trace(self) -> Dict:
        """``trace_pairs`` pairs under a device-only profile (busy time,
        launches, kernel times), then one pair under a profile of host
        and device (what the host did in the idle gaps)."""
        from vqacl_tpu_torch.ops import fused_attention as fa
        n = int(self.cell.param("trace_pairs", 3))
        k0 = (fa.fused_attention_fwd_train.launches,
              fa.fused_attention_bwd.launches)
        out: Dict = {}
        with sub_window(self.device, out):
            for _ in range(n):
                self._pair(*next(self.pairs))
        k1 = (fa.fused_attention_fwd_train.launches,
              fa.fused_attention_bwd.launches)
        host: Dict = {}
        with sub_window(self.device, host, host=True):
            self._pair(*next(self.pairs))
        self._drain()
        self.rec.update(
            trace=out["trace"], host_trace=host["trace"],
            trace_steps=2 * n,
            attention_launches={"fwd_train": k1[0] - k0[0],
                                "bwd": k1[1] - k0[1]})
        return self.rec

    # -- the check -----------------------------------------------------
    def release(self) -> None:
        """Drops the program's state before the reference runs."""
        self.n_group = sum(
            1 for d in self.traffic.items[self.tr.tasks[self.task]]["train"]
            if self.traffic.cate_map[d["img_id"]]
            in self.traffic.groups[self.group])
        del self.tr, self.step_fn, self.pairs, self.tl, self.ml
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision=None) -> Dict:
        """The program's first three steps against the reference's."""
        from portbench import check
        from portbench.reference import precision as P
        from portbench.reference.train import first_steps, schedule
        c = self.cell.config
        sched = schedule(c, self.n_group, replay=True)
        with P.f32_matmul():
            ref = first_steps(self.traffic, c, self.seed,
                              self.first["steps"], self.banks, self.task,
                              sched, self.device, P.F32)
            ctl = None if precision is None else first_steps(
                self.traffic, c, self.seed, self.first["steps"], self.banks,
                self.task, sched, self.device, P.BY_NAME[precision])
        return check.train_numbers(self.first, ref, ctl)
