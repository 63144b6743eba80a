"""``cl_train_moonlight``: ``cl_train``'s in-group steady state on the
VL-Moonlight backbone (``arch: "moonlight"``).

The same loop as ``cl_train`` (the port's ``VQACLTrainer`` over the
generated data, the exemplar buffer of the previous task, the seeded
group order, a fresh optimizer, train and replay steps from
``zip(train, cycle(memory))`` through the trainer's train step over the
bf16 device cache), with the model's weights made from the seed by the
reference's ``make_weights`` and no prototypes. Its additions:

- the model FLOPs of a QA (``train_qa``), routed products counted at
  the expected held choices a token (k · held / router experts);
- in the traced sub-window, the device-side tally of the rows routed to
  each expert (the steps' ``expert_load``, added on the device) and the
  grouped-GEMM launches; then one pair with the program's recorder on
  under a profile of host and device, whose kernels
  ``profiling.attribute`` assigns to the spans (``mla``, ``moe.*``);
- the check against ``reference/moonlight.py``'s first steps, routed on
  its own and again routed by the program's choices (``*_held``), with
  the share of the top-k choices in which the program and the reference
  differ (``choice_diff``).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import time
from typing import Dict, List

import torch

from portbench import common
from portbench.entries import cl_train
from portbench.reference import moonlight as RM
from portbench.trace import label, sub_window
from vqacl_tpu_torch.cl.tasks import random_dic
from vqacl_tpu_torch.cl.trainer import VQACLTrainer
from vqacl_tpu_torch.data.partition import group_loaders
from vqacl_tpu_torch.ops import moe as port_moe
from vqacl_tpu_torch.parallel.mesh import shard_batch
from vqacl_tpu_torch.utils import profiling

# the configuration file's HF keys → the port's ModelConfig fields
MODEL_KEYS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
              "rms_norm_eps": "layer_norm_epsilon",
              "n_routed_experts": "experts_held"}


def train_qa(m: Dict) -> int:
    """Forward + backward model FLOPs of one question (3× the forward;
    2·m·k·n a product): the visual embedding; per layer MLA's q, kv_a,
    kv_b and o projections and its scores and probabilities' product
    over the causal S × S positions counted whole; the dense SwiGLU,
    or the router, the shared SwiGLU and the routed SwiGLUs at k · held
    / router experts choices a token; the head over the answer
    positions. Norms, RoPE, softmax and the combine are left out."""
    D, H, V = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    r, N, T = m["kv_lora_rank"], m["n_boxes"], m["target_max_length"]
    S = N + m["max_text_length"] + T
    mla = (2 * S * D * H * (dn + dr) + 2 * S * D * (r + dr)
           + 2 * S * r * H * (dn + dv) + 2 * S * S * H * (dn + dr)
           + 2 * S * S * H * dv + 2 * S * H * dv * D)
    dense = 3 * 2 * S * D * m["intermediate_size"]
    Fm = m["moe_intermediate_size"]
    held = m["num_experts_per_tok"] * m["n_routed_experts"] \
        / m["router_experts"]
    moe = (2 * S * D * m["router_experts"]
           + 3 * 2 * S * D * m["n_shared_experts"] * Fm
           + held * 3 * 2 * S * D * Fm)
    k = m["first_k_dense_replace"]
    vis = 2 * N * m["feat_dim"] * D + 2 * N * 5 * D
    fwd = vis + m["num_hidden_layers"] * mla + k * dense \
        + (m["num_hidden_layers"] - k) * moe + 2 * T * D * V
    return int(round(3 * fwd))


def port_config(c: Dict, seed: int):
    cfg = common.port_config(c, seed)
    for k, v in MODEL_KEYS.items():
        setattr(cfg.model, v, c[k])
    return cfg


class Run(cl_train.Run):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.tally = None
        self.choices = None

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        """``cl_train``'s set-up with this model's configuration and
        weights, no prototype banks, and the first steps' choices kept."""
        c, dev = self.cell.config, self.device
        cfg = port_config(c, self.seed)
        with common.part(self.rec, "traffic"):
            self.traffic = common.traffic(self.cell, self.seed, dev)
        tok = common.tokenizer()
        data = common.DataModule(self.traffic, tok, c)
        with common.part(self.rec, "weights"):
            params = RM.make_weights(c, self.seed, dev)
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
        order = random_dic({g: None for g in tls}, tr.py_rng)
        self.group = next(g for g in order if tls[g].num_examples > 0
                          and mls[g].num_examples > 0)
        self.tl, self.ml = tls[self.group], mls[self.group]
        tr._reset_optimizer(2 * self.tl.num_examples)
        self.step_fn = tr._train_step(False)
        self.accum = 1
        self.pairs = self._epochs()

        # the first three steps, kept for the check
        t_steps = time.perf_counter()
        self.choices = []
        b1, m1 = next(self.pairs)
        l1 = self._step("train", b1)
        b1m = 1.0 - cfg.train.adam_beta1
        grad1 = [float(m.float().norm()) / b1m
                 for _, m in RM.flatten(tr.state.opt_state.mu)]
        l2 = self._step("replay", m1)
        b2, m2 = next(self.pairs)
        l3 = self._step("train", b2)
        choices, self.choices = self.choices, None
        p0 = RM.make_weights(c, self.seed, dev)
        change = [float((p - a).norm()) for (_, p), (_, a) in
                  zip(RM.flatten(tr.state.params), RM.flatten(p0))]
        del p0
        self.first = {
            "loss": [float(x) for x in (l1, l2, l3)], "grad1": grad1,
            "change": change, "choices": choices,
            "steps": [(list(b["meta"]["question_ids"]),
                       b["tensors"]["input_ids"].shape[0])
                      for b in (b1, m1, b2)]}
        self._step("replay", m2)
        for _ in range(int(self.cell.param("warm_pairs", 1))):
            self._pair(*next(self.pairs))
        common.sync(dev)
        self.rec.setdefault("setup_parts", {})["steps"] = \
            time.perf_counter() - t_steps

    def _step(self, kind: str, batch) -> torch.Tensor:
        tr = self.tr
        with label(f"{kind}_step"):
            tr.state, m = self.step_fn(tr.state, shard_batch(
                tr.ctx, batch["tensors"], self.accum))
        self.pend.append(m["loss"])
        if self.tally is not None:
            self.tally += m["expert_load"]
        if self.choices is not None:
            self.choices.append([x.cpu() for x in m["choices"]])
        self.rows += int(batch["meta"]["n_real"])
        self.steps += 1
        return m["loss"]

    # -- the window ----------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """``cl_train``'s window (a copy: that file counts VL-T5's FLOPs
        and stays as it is) with this model's FLOPs a QA."""
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
        self.rec["host"] = {
            "main_cpu_s": cpu[0], "process_cpu_s": cpu[1],
            "pair_s_q10_q50_q90": statistics.quantiles(pair_s, n=10)[::4]
            if len(pair_s) > 1 else pair_s}
        self.rec.update(
            window_s=wall, rows=rows, steps=self.steps - steps0,
            loader_s=self.loader_s - load0,
            flops=rows * train_qa(self.cell.config),
            attempted=self.steps - steps0,
            failed=sum(not math.isfinite(x) for x in self.losses))
        return self.rec

    def trace(self) -> Dict:
        """``trace_pairs`` pairs under a device-only profile, with the
        routed rows tallied on the device and the grouped-GEMM launches
        counted; one pair under a profile of host and device; one pair
        with the program's recorder on, its kernels attributed to its
        spans."""
        c = self.cell.config
        n = int(self.cell.param("trace_pairs", 3))
        layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
        self.tally = torch.zeros((layers, c["router_experts"]),
                                 device=self.device)
        k0 = port_moe.grouped_swiglu.launches
        out: Dict = {}
        with sub_window(self.device, out):
            for _ in range(n):
                self._pair(*next(self.pairs))
        tally, self.tally = self.tally, None
        k1 = port_moe.grouped_swiglu.launches
        host: Dict = {}
        with sub_window(self.device, host, host=True):
            self._pair(*next(self.pairs))
        spans = self._span_window()
        self._drain()
        self.rec.update(
            trace=out["trace"], host_trace=host["trace"], trace_steps=2 * n,
            moe_rows=tally[:, :c["n_routed_experts"]].sum(1).tolist(),
            moe_launches=k1 - k0, span_device_s=spans["device_s"],
            span_launches=spans["launches"], span_names=spans["names"],
            span_steps=2)
        return self.rec

    def _span_window(self) -> Dict:
        """One pair with the recorder on under a profile of host and
        device → ``profiling.attribute``'s record of it."""
        P = torch.profiler.ProfilerActivity
        cuda = torch.device(self.device).type == "cuda"
        common.sync(self.device)
        profiling.take()
        profiling.enable()
        try:
            with torch.profiler.profile(
                    activities=[P.CPU] + [P.CUDA] * cuda) as prof:
                self._pair(*next(self.pairs))
                common.sync(self.device)
        finally:
            profiling.enable(False)
        taken = profiling.take()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_spans_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        out = profiling.attribute(doc, taken.spans, taken.anchor)
        out["names"] = sorted({sp[0] for sp in taken.spans})
        return out

    # -- the check -----------------------------------------------------
    def check(self, precision=None) -> Dict:
        """The program's first three steps against the reference's
        (``loss``, ``grad1``, ``change3``), again against the reference
        routed by the program's own choices (``*_held``: the gaps that
        remain with routing held equal), and the share of top-k choices
        that differ (``choice_diff``). The control side is held to the
        reference routed by the control's choices."""
        from portbench import check
        from portbench.reference import precision as P
        from portbench.reference.train import schedule
        c = self.cell.config
        sched = schedule(c, self.n_group, replay=True)
        with P.f32_matmul():
            ref = RM.first_steps(self.traffic, c, self.seed,
                                 self.first["steps"], sched, self.device,
                                 P.F32)
            ctl = None if precision is None else RM.first_steps(
                self.traffic, c, self.seed, self.first["steps"], sched,
                self.device, P.BY_NAME[precision])
            # routing held equal: the f32 reference routed by each
            # side's own choices
            held = RM.first_steps(self.traffic, c, self.seed,
                                  self.first["steps"], sched, self.device,
                                  P.F32, held=self.first["choices"])
            held_ctl = None if ctl is None else RM.first_steps(
                self.traffic, c, self.seed, self.first["steps"], sched,
                self.device, P.F32, held=ctl["choices"])
        out = check.train_numbers(self.first, ref, ctl)
        out["choice_diff"] = {"value": choice_diff(self.first["choices"],
                                                   ref["choices"])}
        if ctl is not None:
            out["choice_diff"]["control"] = choice_diff(ctl["choices"],
                                                        ref["choices"])
        prog = check.train_numbers(self.first, held)
        side = None if ctl is None else check.train_numbers(ctl, held_ctl)
        for k in ("loss", "grad1", "change3"):
            out[f"{k}_held"] = {"value": prog[k]["value"]}
            if side is not None:
                out[f"{k}_held"]["control"] = side[k]["value"]
        return out


def choice_diff(a: List[List[torch.Tensor]], b: List[List[torch.Tensor]]
                ) -> float:
    """The share of top-k choices (over steps, layers and tokens) that one
    side made and the other did not."""
    diff = total = 0
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            n = min(len(x), len(y))      # rows the other side lacks differ
            same = (x[:n, :, None] == y[:n, None, :]).any(-1).sum()
            total += max(len(x), len(y)) * x.shape[-1]
            diff += max(len(x), len(y)) * x.shape[-1] - int(same)
    return diff / max(total, 1)

