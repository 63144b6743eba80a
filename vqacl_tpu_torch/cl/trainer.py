"""VQACL continual-learning trainer: the dual-level task loop (counterpart
of ``vqacl_tpu/cl/trainer.py``).

The reference's ``Trainer`` (``VL-T5/src/vqacl.py:54-635``) as host
orchestration around the port's steps, on one device or one rank of a
data-parallel mesh:

  for task in 10 linguistic tasks:                (vqacl.py:165)
    rebuild exemplar buffer from prev task         (:170-203)
    build per-group train/val/memory loaders + test loaders (:214-283)
    shuffle group order (seeded)                   (:314)
    for group in G1..G5 (shuffled):                (:316)
      fresh optimizer, t_total = (2×)train size    (:324-335)
      skip if group == comp_cate and not first task (:337-339)
      for epoch in epochs:                         (:342)
        for batch, mem_batch in zip(train, cycle(memory)):  (:358-373)
          train_step(batch); train_step(mem_batch)
        validate on the group's val loader         (:399)
    save {task}_LAST checkpoint                    (:414)
    test(task): eval on all previously trained tasks → result matrix (:417,533-584)
  final: Avg-Acc / Avg-Forget metrics              (:661-673)

The random draws (group order and exemplars from ``random.Random``,
loader shuffles and answer sampling from numpy generators) are the JAX
trainer's in the same order, so the same seed trains on the same batches.
With ``cl_reg`` "ewc"/"mas" the train step carries the anchor penalty and
each task ends with an importance pass; with "der"/"derpp" replay batches
distill against logits captured when their exemplars entered the buffer.

With ``data.device_cache`` the whole region-feature table of the data
module's store goes to the device once (data/device_cache.py, in
``data.device_cache_dtype``); every dataset is switched to slot mode and
the train, replay, capture, importance and eval steps gather their
features on the device, so batches carry int32 slots.

Data parallelism (``mesh_ctx``, default ``parallel.mesh.make_mesh()``:
one process, or the ranks ``torchrun`` started): every rank builds the
same global batches, exemplar buffer and group order from the same
seeds, runs its rows of each batch (``shard_batch``, where JAX calls it)
and takes part in the steps' collectives; ``predict`` merges the ranks'
answers (``merge_quesid2ans``), the DER capture gathers the ranks'
logits rows before they enter the buffer, and a barrier closes each
task. Only the main process writes checkpoints, logs, the prototype
banks and ``metrics.json``. ``mesh.param_layout="fsdp"`` keeps each
rank's slices of the large parameters and their moments
(``parallel.sharding.FsdpLayout``); ``data.device_cache_sharded``
row-shards the device cache over dp.

Tensor and pipeline parallelism (a mesh with tp or pp above 1, as
``make_mesh`` builds it): the tp and pp ranks of one dp index run the
same rows. ``mesh.param_layout="tp"`` keeps each rank's Megatron slices
and their moments (``TpLayout``; "fsdp" at tp > 1 shards those slices
over dp, as JAX composes them; "replicated" keeps the whole tree, cut
per step); the train steps run the tp blocks. With pp > 1 the trainer
sets ``cfg.model.pp_mesh``/``pp_micro`` as JAX's does, so every encode
and teacher-forced decode (train, replay, capture, importance, eval
encode) runs the GPipe stacks; greedy and beam decoding are not
pipelined. Predict and validation run on the gathered tree, and
checkpoints hold the full leaves. Refused with ``ValueError``: a layout
nobody knows, a ``mesh.dp``/``tp``/``pp`` other than the mesh's, global
batch sizes dp (× pp_micro under pp) does not divide, and heads, d_ff or
layers that tp or pp do not divide.

``wall_s`` sums host seconds by phase (``loader``: waiting for the next
train or memory batch; ``train``: the step calls and the epoch-end loss
drain; ``predict``; ``checkpoint``: the host copy of each task-boundary
save and the final drain of the writer), ``task_wall_s`` each task's
seconds (train, save and test), and ``counts`` the steps and batches of
each kind (``train_steps``, ``replay_steps``, ``predict_batches``,
``importance_batches``, ``capture_batches``). ``times_ms`` holds each of
those calls' milliseconds under the same keys: on a card the span
between two CUDA events recorded around the call, read once the host
has waited for the card anyway (at the end of each ``predict``), so the
loop keeps no sync per call; on the CPU the host clock. Its ``saves``
are each task-boundary save's host copy on the host clock.
``step_losses`` keeps every train and replay step's loss, drained with
the epoch's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.cl import regularizers as R
from vqacl_tpu_torch.cl.exemplar import ExemplarBuffer
from vqacl_tpu_torch.cl.metrics import ResultMatrix, evaluate_metric
from vqacl_tpu_torch.cl.tasks import CATEGORY_SPLITS, make_rng, random_dic
from vqacl_tpu_torch.data import device_cache as DC
from vqacl_tpu_torch.data.partition import (BatchLoader, all_loader,
                                            group_loaders)
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.models.vlt5 import (cast_params_for_inference,
                                         init_vlt5_params)
from vqacl_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from vqacl_tpu_torch.parallel.multihost import (barrier, is_main_process,
                                                merge_quesid2ans,
                                                process_count)
from vqacl_tpu_torch.parallel.sharding import (FsdpLayout, StoredLayout,
                                               TpLayout)
from vqacl_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                              load_checkpoint,
                                              load_reference_prototypes,
                                              save_checkpoint)
from vqacl_tpu_torch.train.optim import make_transform, tree_map
from vqacl_tpu_torch.train.state import TrainState
from vqacl_tpu_torch.train.step import (make_der_replay_step,
                                        make_eval_step, make_logits_step,
                                        make_train_step)
from vqacl_tpu_torch.utils.config import resolve_merged_qkv
from vqacl_tpu_torch.utils.device import resolve_device

CL_REGS = ("none", "ewc", "mas", "der", "derpp")
LAYOUTS = ("replicated", "tp", "fsdp")


class LossMeter:
    """Window-100 running mean (utils.py:40-56)."""

    def __init__(self, maxlen: int = 100):
        self.vals: List[float] = []
        self.maxlen = maxlen

    def update(self, v: float) -> None:
        self.vals.append(v)
        if len(self.vals) > self.maxlen:
            self.vals.pop(0)

    @property
    def val(self) -> float:
        return sum(self.vals) / len(self.vals) if self.vals else 0.0


def _refuse_unported(cfg, ctx) -> None:
    """ValueError for the options the port does not take (yet) and for a
    configuration the mesh ``ctx`` cannot run."""
    if cfg.data.device_cache_dtype not in DC.DTYPES:
        raise ValueError(f"data.device_cache_dtype="
                         f"{cfg.data.device_cache_dtype!r}; pick from "
                         f"{tuple(DC.DTYPES)}")
    if cfg.mesh.param_layout not in LAYOUTS:
        raise ValueError(f"mesh.param_layout={cfg.mesh.param_layout!r}; pick "
                         f"from {LAYOUTS}")
    if int(cfg.mesh.dp) not in (-1, ctx.dp):
        raise ValueError(f"mesh.dp={cfg.mesh.dp}, but the mesh has "
                         f"dp={ctx.dp} ranks")
    for axis in ("tp", "pp"):
        if int(getattr(cfg.mesh, axis)) != getattr(ctx, axis):
            raise ValueError(f"mesh.{axis}={getattr(cfg.mesh, axis)}, but the "
                             f"mesh has {axis}={getattr(ctx, axis)}")
    m = cfg.model
    for what, n, axis in (("num_heads", m.num_heads, "tp"),
                          ("d_ff", m.d_ff, "tp"),
                          ("num_layers", m.num_layers, "pp"),
                          ("num_decoder_layers", m.num_decoder_layers, "pp")):
        if n % getattr(ctx, axis):
            raise ValueError(f"model.{what}={n} is not divisible by "
                             f"{axis}={getattr(ctx, axis)}")
    accum = int(cfg.train.grad_accum)
    micro = int(cfg.mesh.pp_micro) if ctx.pp > 1 else 1
    for name, size, div in (("batch_size", cfg.train.batch_size,
                             ctx.dp * accum * micro),
                            ("valid_batch_size", cfg.train.valid_batch_size,
                             ctx.dp * micro)):
        if size % div:
            raise ValueError(f"train.{name}={size} is not divisible by "
                             f"dp={ctx.dp}"
                             + (f" x grad_accum={accum}" if accum > 1
                                and name == "batch_size" else "")
                             + (f" x pp_micro={micro}" if micro > 1
                                else ""))
    if cfg.train.cl_reg not in CL_REGS:
        raise ValueError(f"train.cl_reg={cfg.train.cl_reg!r}; pick from "
                         f"{CL_REGS}")
    if cfg.train.cl_reg in ("der", "derpp") and not cfg.train.memory:
        raise ValueError("cl_reg='der'/'derpp' is a replay method: it "
                         "requires train.memory")


class VQACLTrainer:
    def __init__(self, cfg, data, tokenizer, verbose: bool = True,
                 device="cuda", init_params=None, dtype=torch.bfloat16,
                 mesh_ctx=None):
        """``data``: a DataModule (``data/synthetic_module.py``);
        ``init_params``: the port's parameter tree to start from (else a
        seeded random init); ``dtype``: the compute dtype (f32 master
        weights either way); ``mesh_ctx``: this rank's mesh (default
        ``make_mesh(device=device)``), whose device the trainer runs on."""
        self.ctx = mesh_ctx if mesh_ctx is not None else \
            make_mesh(device=device)
        self.device = resolve_device(self.ctx.device)
        _refuse_unported(cfg, self.ctx)
        # "auto" → merged projections on one device, separate ones on a
        # mesh of more, as JAX's trainer resolves it
        resolve_merged_qkv(cfg.model, n_devices=self.ctx.world_size)
        # pipelined stacks (parallel/pipeline.py): recorded on the model
        # config (not a field), so encode()/decode_hidden() route through
        # them, as JAX's trainer does (trainer.py:83-87)
        if self.ctx.pp > 1:
            cfg.model.pp_mesh = self.ctx
            cfg.model.pp_micro = int(cfg.mesh.pp_micro)
        self.cfg = cfg
        self.data = data
        self.tok = tokenizer
        self.verbose = verbose
        self.tasks: List[str] = list(data.tasks)
        self.dtype = dtype
        m = cfg.model
        params = init_vlt5_params(cfg.train.seed, m, device=self.device) \
            if init_params is None else \
            tree_map(lambda p: p.to(self.device, torch.float32),
                     init_params)
        proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                                  device=self.device)
        # the same transform as the train steps build: resetting the
        # optimizer per group goes through it
        self._tx = make_transform(cfg.train)
        # params placed per mesh.param_layout: rank 0's broadcast, then
        # this rank's tp slices ("tp", and "fsdp" at tp > 1) and their
        # FSDP slices (the moments made from them follow)
        layout = cfg.mesh.param_layout
        self._tp = TpLayout(self.ctx, params) \
            if layout in ("tp", "fsdp") and self.ctx.tp > 1 else None
        self._fsdp = FsdpLayout(self.ctx, params, tp=self._tp) \
            if layout == "fsdp" else None
        self._layout = StoredLayout(self._tp, self._fsdp) \
            if self._tp is not None or self._fsdp is not None else None
        params = self._place(params)
        # dropout generator seeded as the JAX trainer seeds its key; the
        # ranks' generators stay in step (models/t5.py::dropout)
        state = TrainState.create(params, self._tx, proto,
                                  seed=cfg.train.seed + 1)
        self.state = state._replace(
            step=replicate(self.ctx, state.step),
            proto=replicate(self.ctx, state.proto),
            generator=replicate(self.ctx, state.generator),
            sched=replicate(self.ctx, state.sched))
        # the device feature cache: the whole table on the device,
        # batches carry slots (data/device_cache.py)
        self._cache = None
        self._slot_of = None
        if cfg.data.device_cache:
            if not hasattr(getattr(data, "features", None), "get"):
                raise ValueError("data.device_cache needs a data module with "
                                 "a feature store (.features)")
            self._cache, self._slot_of = DC.DeviceFeatureCache.from_store(
                data.features, sorted(data.cate_map.keys()),
                device=self.device,
                feat_dtype=DC.DTYPES[cfg.data.device_cache_dtype],
                shard=cfg.data.device_cache_sharded, mesh_ctx=self.ctx)
            self._log(f"device feature cache: {self._cache.n} images "
                      f"({self._cache.nbytes / 1e9:.2f} GB)")
            self.eval_step = DC.make_cached_eval_step(
                cfg, self._cache, dtype=dtype, device=self.device)
        else:
            self.eval_step = make_eval_step(cfg, dtype=dtype,
                                            device=self.device)
        self._train_step_cache: Dict[Any, Any] = {}

        # EWC/MAS importance + anchor (cl/regularizers.py), DER/DER++
        # replay (train/step.py::make_der_replay_step)
        cl_reg = cfg.train.cl_reg
        self._reg = None
        self._imp_step = None
        self._der = cl_reg in ("der", "derpp")
        self._der_step_fn = None
        self._logits_step = None
        if cl_reg in ("ewc", "mas"):
            self._reg = R.init_reg_state(self._full_params())
            self._log(f"CL regularizer: {cl_reg} "
                      f"(λ={cfg.train.reg_lambda})")
        elif self._der:
            self._log(f"CL regularizer: {cl_reg} "
                      f"(α={cfg.train.reg_lambda}"
                      + (f", β={cfg.train.der_beta}" if cl_reg == "derpp"
                         else "") + ")")

        # NExT-QA swaps in its G0..G4 video-category groups
        self.splits = getattr(data, "category_splits", CATEGORY_SPLITS)
        self.buffer = ExemplarBuffer(cfg.train.m_size, splits=self.splits)
        self.result_matrix = ResultMatrix(self.tasks)
        self.py_rng = make_rng(cfg.train.seed)
        # task-boundary saves go through a background writer: the npz
        # write overlaps the per-task test matrix. Emergency saves stay
        # synchronous.
        self._ckpt_writer = AsyncCheckpointer()
        self.task_total_num: Dict[int, int] = {}
        self.metrics_log: List[Dict] = []
        self.test_loader_dict_all: Dict[str, BatchLoader] = {}
        self.wall_s: Dict[str, float] = collections.defaultdict(float)
        self.task_wall_s: Dict[str, float] = {}
        self.counts: Dict[str, int] = collections.Counter()
        self.times_ms: Dict[str, List[float]] = collections.defaultdict(list)
        self._spans: List[Tuple[str, Any, Any]] = []
        self.step_losses: Dict[str, List[float]] = {"train": [],
                                                    "replay": []}

    @contextlib.contextmanager
    def _call(self, kind: str):
        """Counts one step or batch of ``kind`` and keeps its time: CUDA
        events around it on a card (read by ``_read_spans``), the host
        clock on the CPU."""
        self.counts[kind] += 1
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._spans.append((kind, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.times_ms[kind].append((time.perf_counter() - t0) * 1e3)

    def _read_spans(self) -> None:
        for kind, start, end in self._spans:
            end.synchronize()
            self.times_ms[kind].append(start.elapsed_time(end))
        self._spans.clear()

    # ------------------------------------------------------------------
    def _place(self, params):
        """Parameters as the layout keeps them: rank 0's values on every
        rank (``replicate``), then this rank's tp and FSDP slices."""
        params = replicate(self.ctx, params)
        return params if self._layout is None else self._layout.shard(params)

    def _full_params(self):
        """The whole parameter tree (gathered from the ranks' slices under
        tp and FSDP; every rank must call it together)."""
        return self.state.params if self._layout is None else \
            self._layout.gather(self.state.params)

    def _train_step(self, use_memory_loss: bool):
        key = bool(use_memory_loss)
        if key not in self._train_step_cache:
            reg_lambda = float(self.cfg.train.reg_lambda) \
                if self._reg is not None else 0.0
            kw = dict(dtype=self.dtype, device=self.device,
                      use_memory_loss=use_memory_loss,
                      remat=self.cfg.mesh.remat, reg_lambda=reg_lambda,
                      mesh_ctx=self.ctx, fsdp=self._fsdp, tp=self._tp)
            fn = make_train_step(self.cfg, **kw) if self._cache is None \
                else DC.make_cached_train_step(self.cfg, self._cache, **kw)
            if self._reg is not None:
                raw = fn
                # late-bound: consolidation swaps self._reg between tasks
                fn = lambda state, batch: raw(state, batch, self._reg)  # noqa: E731
            self._train_step_cache[key] = fn
        return self._train_step_cache[key]

    def _slotify(self, ds):
        """Switch a dataset into the device cache's slot mode."""
        if self._slot_of is not None:
            ds.slot_of = self._slot_of
        return ds

    def _der_replay_step(self):
        if self._der_step_fn is None:
            kw = dict(dtype=self.dtype, device=self.device,
                      remat=self.cfg.mesh.remat, mesh_ctx=self.ctx,
                      fsdp=self._fsdp, tp=self._tp)
            self._der_step_fn = make_der_replay_step(self.cfg, **kw) \
                if self._cache is None else \
                DC.make_cached_der_step(self.cfg, self._cache, **kw)
        return self._der_step_fn

    def _der_capture(self, task_idx: int) -> None:
        """Snapshot teacher-forced logits for the exemplars that just
        entered the buffer: the stored ``der_logits`` [T,V] f16, with the
        sampled target and score that produced them, become the replay
        distillation target for the rest of the run.

        Cost: T·V f16 per exemplar on the host (t5-base: ~0.64 MB, so
        M=5000 ≈ 3.2 GB of host RAM), and every replay batch ships its
        [B,T,V] f16 tensor to the device (51.5 MB at batch 80)."""
        # normal flow: only the just-inserted slot (task_idx-1) lacks
        # logits; on resume every rebuilt slot does, and those capture
        # with the loaded checkpoint's weights
        new_items = [d for g in self.buffer.sets
                     for slot in self.buffer.sets[g]
                     for d in slot if "der_logits" not in d]
        if not new_items:
            return
        if self._logits_step is None:
            kw = dict(dtype=self.dtype, device=self.device)
            self._logits_step = make_logits_step(self.cfg, **kw) \
                if self._cache is None else \
                DC.make_cached_logits_step(self.cfg, self._cache, **kw)
        ds = self._slotify(self.data.make_dataset(new_items, mode="train",
                                                  task_idx=task_idx - 1))
        bs = self.cfg.train.batch_size
        loader = BatchLoader(ds, np.arange(len(ds)), bs, shuffle=False,
                             with_targets=True, drop_last=False,
                             collate_kw=self._ck())
        off = 0
        params = self._full_params()
        for batch in loader:
            with self._call("capture_batches"):
                logits = self._logits_step(
                    params, self.state.proto,
                    shard_batch(self.ctx, batch["tensors"]))
            # f32 → f16 rounds to nearest even on the device as numpy
            # does on the host; half the bytes cross to the host. Each
            # rank captured its rows: every rank's buffer gets them all
            arr = self.ctx.gather_rows(
                logits.to(torch.float16)).cpu().numpy()
            tgt = batch["tensors"]["target_ids"]
            sc = batch["tensors"]["scores"]
            n = batch["meta"]["n_real"]
            for i in range(n):
                d = new_items[off + i]
                d["der_logits"] = arr[i]
                d["der_target_ids"] = tgt[i].tolist()
                d["der_score"] = float(sc[i])
            off += n
        mb = off * arr.shape[1] * arr.shape[2] * 2 / 1e6
        self._log(f"   DER capture: {off} exemplars ({mb:.1f} MB logits)")

    def _reset_optimizer(self, total_train_num: int) -> None:
        """Fresh AdamW per group with the reference's t_total accounting
        (trainer_base.py:137-145)."""
        bs = self.cfg.train.batch_size
        batch_per_epoch = max(int(total_train_num / bs), 1)
        t_total = batch_per_epoch * self.cfg.train.epochs
        # int(t_total*ratio) with NO floor: warmup 0 -> full lr from step
        # one, matching HF get_constant_schedule_with_warmup semantics
        warmup = int(t_total * self.cfg.train.warmup_ratio)
        self.state = self.state.reset_optimizer(self._tx, warmup, t_total)

    def _load(self, task: str):
        """(params, proto) of ``{task}_LAST`` on the trainer's device,
        rank 0's broadcast, the params in this rank's layout."""
        params, proto, _ = load_checkpoint(
            os.path.join(self.cfg.output, f"{task}_LAST"),
            device=self.device, mesh_ctx=self.ctx, layout=self._layout)
        return params, proto

    def _save(self, saver, suffix: str, task: str) -> None:
        """Every rank calls it (tp and FSDP slices are gathered); only the
        main process writes."""
        saver(os.path.join(self.cfg.output, f"{task}_{suffix}"),
              self.state.params, self.state.proto, int(self.state.step),
              layout=self._layout)

    # ------------------------------------------------------------------
    def train(self, resume_task: Optional[str] = None) -> Dict:
        start_idx = 0
        if resume_task is not None:
            start_idx = self.tasks.index(resume_task) + 1
            params, proto = self._load(resume_task)
            self.state = self.state._replace(params=params, proto=proto)
            # rebuild the exemplar-buffer history so the first resumed
            # task sees the same replay quota a continuous run would
            if self.cfg.train.memory:
                for k in range(1, start_idx):
                    self.buffer.update(k,
                                       self.data.train_items(self.tasks[k - 1]),
                                       self.data.cate_map, self.py_rng)
                if self._der and start_idx > 0:
                    self._der_capture(start_idx)

        for task_idx in range(start_idx, len(self.tasks)):
            task = self.tasks[task_idx]
            self._log(f"======== task {task} ({task_idx}) ========")
            t_task = time.perf_counter()
            try:
                self.train_task(task_idx,
                                first_trained=(task_idx == start_idx))
                # inside the recovery scope: save() re-raises a PREVIOUS
                # task's failed background write, and the just-trained
                # params must still reach {task}_EMERGENCY in that case
                t0 = time.perf_counter()
                self._save(self._ckpt_writer.save, "LAST", task)
                dt = time.perf_counter() - t0
                self.wall_s["checkpoint"] += dt
                self.times_ms["saves"].append(dt * 1e3)
            except BaseException:
                # keep the state: --checkpoint <prev task> plus this
                # emergency file lose at most the current task
                try:
                    self._ckpt_writer.wait()
                except BaseException as werr:
                    self._log(f"!! pending checkpoint write failed: {werr}")
                self._save(save_checkpoint, "EMERGENCY", task)
                self._log(f"!! saved {task}_EMERGENCY before re-raising")
                raise

            self.test(task)
            self._write_log()
            # task-boundary sync of the ranks (identity in one process)
            barrier(f"task_{task}")
            self.task_wall_s[task] = time.perf_counter() - t_task

        # drain the last background checkpoint write (and surface any
        # writer error) before declaring the run complete
        t0 = time.perf_counter()
        self._ckpt_writer.wait()
        self.wall_s["checkpoint"] += time.perf_counter() - t0
        self._read_spans()

        # prototype export for reference parity (vqacl.py:420-426)
        metrics = evaluate_metric(self.result_matrix.to_dict())
        if is_main_process():
            os.makedirs(self.cfg.output, exist_ok=True)
            np.save(os.path.join(self.cfg.output, "Q_prototype.npy"),
                    self.state.proto.q_proto.cpu().numpy())
            np.save(os.path.join(self.cfg.output, "V_prototype.npy"),
                    self.state.proto.v_proto.cpu().numpy())
            with open(os.path.join(self.cfg.output, "metrics.json"),
                      "w") as f:
                json.dump({k: v for k, v in metrics.items()}, f, indent=2,
                          default=float)
        self._log(self.result_matrix.show())
        self._log(f"Avg_acc {metrics['Avg_acc']:.2f} "
                  f"Avg_forget {metrics['Avg_forget']:.2f}")
        return metrics

    # ------------------------------------------------------------------
    def train_task(self, task_idx: int, first_trained: bool = False) -> None:
        cfg = self.cfg
        task = self.tasks[task_idx]

        # -- exemplar rebuild from previous task (vqacl.py:170-203) --
        mem_items: List[dict] = []
        if cfg.train.memory and task_idx > 0:
            prev = self.data.train_items(self.tasks[task_idx - 1])
            self.buffer.update(task_idx, prev, self.data.cate_map, self.py_rng)
            mem_items = self.buffer.all_examplars()
            self._log(f"# memory size: {len(mem_items)}")
            if self._der:
                self._der_capture(task_idx)

        train_ds = self._slotify(self.data.dataset(task, "train",
                                                    task_idx=task_idx))
        val_ds = self._slotify(self.data.dataset(task, "val",
                                                 task_idx=task_idx))
        test_ds_all = self._slotify(self.data.dataset(task, "test",
                                                      task_idx=task_idx))
        self.task_total_num[task_idx] = len(train_ds)

        bs = cfg.train.batch_size
        vbs = cfg.train.valid_batch_size
        nw = int(cfg.data.n_workers)
        train_loaders = group_loaders(train_ds, bs, shuffle=True,
                                      seed=cfg.train.seed,
                                      collate_kw=self._ck(),
                                      splits=self.splits, num_workers=nw)
        val_loaders = group_loaders(val_ds, vbs, shuffle=False,
                                    with_targets=True, collate_kw=self._ck(),
                                    splits=self.splits, num_workers=nw)
        mem_ds = self._slotify(self.data.make_dataset(mem_items,
                                                      mode="train",
                                                      task_idx=task_idx))
        mem_loaders = group_loaders(mem_ds, bs, shuffle=True,
                                    seed=cfg.train.seed + 7,
                                    collate_kw=self._ck(),
                                    splits=self.splits, num_workers=nw)
        self.test_loader_dict_all[task] = all_loader(
            test_ds_all, vbs, with_targets=False, collate_kw=self._ck(),
            num_workers=nw)

        self.state = self.state._replace(
            proto=self.state.proto.start_task(task_idx))

        group_order = random_dic({g: None for g in train_loaders},
                                 self.py_rng)
        use_mem_loss = cfg.train.use_memory_loss and cfg.train.memory \
            and task_idx > 0 and cfg.model.use_prototype

        for group in group_order:
            tl, vl, ml = train_loaders[group], val_loaders[group], \
                mem_loaders[group]
            if tl.num_examples == 0:
                continue
            total = 2 * tl.num_examples if ml.num_examples > 0 \
                else tl.num_examples
            self._reset_optimizer(total)

            # comp split: hold the comp group out except on the first
            # trained task (vqacl.py:337-339)
            if group == cfg.train.comp_cate and not first_trained:
                self._log(f"-- skip group {group} (composition holdout)")
                continue
            self._log(f"-- group {group}: {tl.num_examples} train, "
                      f"{ml.num_examples} memory")

            step_fn = self._train_step(use_mem_loss)
            # DER replay distills against stored logits; ER (the
            # reference's replay) is a second CE step
            mem_fn = self._der_replay_step() if self._der else step_fn
            # each rank's rows of every microbatch (train/step.py)
            accum = int(cfg.train.grad_accum)
            mem_accum = 1 if self._der else accum
            meter, meter_mem = LossMeter(), LossMeter()
            for epoch in range(cfg.train.epochs):
                it = zip(tl, itertools.cycle(ml)) if ml.num_examples > 0 \
                    else ((b, None) for b in tl)
                # losses stay on the device during the epoch (a float()
                # per step would wait for the card); they drain at its end
                pend, pend_mem = [], []
                while True:
                    t0 = time.perf_counter()
                    nxt = next(it, None)
                    t1 = time.perf_counter()
                    self.wall_s["loader"] += t1 - t0
                    if nxt is None:
                        break
                    batch, mem_batch = nxt
                    with self._call("train_steps"):
                        self.state, m = step_fn(self.state, shard_batch(
                            self.ctx, batch["tensors"], accum))
                    pend.append(m["loss"])
                    if mem_batch is not None:
                        with self._call("replay_steps"):
                            self.state, mm = mem_fn(self.state, shard_batch(
                                self.ctx, mem_batch["tensors"], mem_accum))
                        pend_mem.append(mm["loss"])
                    self.wall_s["train"] += time.perf_counter() - t1
                t0 = time.perf_counter()
                for kind, vals, mtr in (("train", pend, meter),
                                        ("replay", pend_mem, meter_mem)):
                    vals = torch.stack(vals).float().tolist() if vals else []
                    self.step_losses[kind] += vals
                    for v in vals[-mtr.maxlen:]:
                        mtr.update(v)
                self.wall_s["train"] += time.perf_counter() - t0
                if vl.num_examples > 0:
                    score = self.evaluate(vl, task)
                    self._log(f"   {group} epoch {epoch}: loss {meter.val:.4f}"
                              f" mem {meter_mem.val:.4f}"
                              f" val {score.get('overall', 0):.2f}")
            self.metrics_log.append({"task": task, "group": group,
                                     "loss": meter.val})

        if self._reg is not None:
            self._consolidate_reg(train_ds)

    # ------------------------------------------------------------------
    def _consolidate_reg(self, train_ds) -> None:
        """End-of-task EWC/MAS consolidation: estimate parameter
        importance over (up to ``fisher_batches``) task batches, then
        fold it into the running omega and re-anchor at the just-trained
        params."""
        cfg = self.cfg
        if self._imp_step is None:
            self._imp_step = R.make_importance_step(
                cfg, cfg.train.cl_reg, dtype=self.dtype, device=self.device,
                mesh_ctx=self.ctx)
        bs = cfg.train.batch_size
        loader = BatchLoader(train_ds, np.arange(len(train_ds)), bs,
                             shuffle=True, seed=cfg.train.seed + 13,
                             with_targets=True,
                             drop_last=(len(train_ds) >= bs),
                             collate_kw=self._ck())
        acc = tree_map(torch.zeros_like, self._reg.omega)
        params = self._full_params()
        n = 0
        for batch in loader:
            t = shard_batch(self.ctx, batch["tensors"])
            with self._call("importance_batches"):
                if self._cache is not None:
                    t = DC.with_features(self._cache, t)
                acc = self._imp_step(acc, params, self.state.proto, t)
            n += 1
            if n >= cfg.train.fisher_batches:
                break
        self._reg = R.consolidate(self._reg, params, acc, n)
        self._log(f"   {cfg.train.cl_reg} consolidated over {n} batches")

    # ------------------------------------------------------------------
    def predict(self, loader: BatchLoader) -> Dict[Any, str]:
        """Greedy generation over a loader → {question_id: answer string}
        (vqacl.py:586-624). Each rank answers its rows of every batch;
        the ranks' dicts are then merged (``merge_quesid2ans``, the
        reference's pickled all_gather at :613).

        Batch i+1 is dispatched before batch i's tokens are copied to the
        host. The parameters are cast to the compute dtype once per call
        (``cast_params_for_inference``): they do not change across the
        loader, and the eval step would otherwise cast every weight at
        each use. The outputs are the same."""
        t_start = time.perf_counter()
        params = self._full_params()
        if self.dtype == torch.bfloat16:
            params = cast_params_for_inference(params, self.dtype)
        quesid2ans: Dict[Any, str] = {}
        pending = None  # (device tokens, meta)

        def drain(item):
            tokens, meta = item
            tokens = tokens.cpu().numpy()
            # this rank's rows of the global batch, the real ones only
            off = self.ctx.dp_index * len(tokens) if self.ctx.dp > 1 else 0
            n_real = min(max(meta["n_real"] - off, 0), len(tokens))
            for qid, ans in zip(meta["question_ids"][off:off + n_real],
                                self.tok.batch_decode(tokens[:n_real])):
                quesid2ans[qid] = ans

        for batch in loader:
            with self._call("predict_batches"):
                tokens = self.eval_step(
                    params, self.state.proto,
                    shard_batch(self.ctx, batch["tensors"]))
            if pending is not None:
                drain(pending)
            pending = (tokens, batch["meta"])
        if pending is not None:
            drain(pending)
        # the last copy waited for the card: every span so far has ended
        self._read_spans()
        if process_count() > 1:
            quesid2ans = merge_quesid2ans(quesid2ans)
        self.wall_s["predict"] += time.perf_counter() - t_start
        return quesid2ans

    def evaluate(self, loader: BatchLoader, task: str) -> Dict[str, float]:
        quesid2ans = self.predict(loader)
        evaluator = self.data.evaluator(task, loader)
        return evaluator(quesid2ans)

    # ------------------------------------------------------------------
    def test(self, task: str, load: bool = False) -> None:
        """Evaluate on all previously trained tasks → result matrix row
        (vqacl.py:533-584)."""
        if load:
            params, proto = self._load(task)
            proto = self._maybe_load_reference_protos(proto)
            self.state = self.state._replace(params=params, proto=proto)
        trained_upto = self.tasks.index(task)
        for j in range(trained_upto + 1):
            test_task = self.tasks[j]
            loader = self.test_loader_dict_all.get(test_task)
            if loader is None:
                test_ds = self._slotify(
                    self.data.dataset(test_task, "test", task_idx=j))
                loader = all_loader(test_ds, self.cfg.train.valid_batch_size,
                                    with_targets=False, collate_kw=self._ck())
                self.test_loader_dict_all[test_task] = loader
            score = self.evaluate(loader, test_task)
            acc = score.get("overall", 0.0)
            self.result_matrix.record(task, test_task, acc)
            self._log(f"   test[{task}→{test_task}] = {acc:.2f}")
            # per-question/answer-type breakdown (vqacl.py:565-577)
            for key in ("perQuestionType", "perAnswerType"):
                if score.get(key):
                    self._log(f"     {key}: {score[key]}")

    def _maybe_load_reference_protos(self, proto: ProtoState) -> ProtoState:
        """Eval-only prototype ingest (vqacl.py:540-542): a reference run
        saves its banks as ``Q_prototype.pt``/``V_prototype.pt`` next to
        the ``{task}_LAST`` checkpoints, since its prototypes never enter
        the state dict. When both files are in ``cfg.output`` they
        override the checkpoint's banks. This package's checkpoints carry
        the banks inline, so their absence is the normal case."""
        qp = os.path.join(self.cfg.output, "Q_prototype.pt")
        vp = os.path.join(self.cfg.output, "V_prototype.pt")
        if os.path.exists(qp) and os.path.exists(vp):
            proto = load_reference_prototypes(proto, qp, vp)
            self._log(f"loaded reference prototype banks from {qp}, {vp}")
        return proto

    def Test(self) -> Dict:
        """Eval-only over the full sequence from saved per-task
        checkpoints (vqacl.py:511-531)."""
        for task in self.tasks:
            path = os.path.join(self.cfg.output, f"{task}_LAST.npz")
            if not os.path.exists(path):
                break
            self.test(task, load=True)
        return evaluate_metric(self.result_matrix.to_dict())

    # ------------------------------------------------------------------
    def _write_log(self) -> None:
        """Structured jsonl training log (the main process's)."""
        if not is_main_process():
            return
        os.makedirs(self.cfg.output, exist_ok=True)
        path = os.path.join(self.cfg.output, "train_log.jsonl")
        with open(path, "w") as f:
            for entry in self.metrics_log:
                f.write(json.dumps(entry, default=float) + "\n")
            f.write(json.dumps(
                {"result_matrix": self.result_matrix.to_dict()},
                default=float) + "\n")

    def _ck(self) -> Dict:
        m = self.cfg.model
        return dict(max_text_length=m.max_text_length, n_boxes=m.n_boxes,
                    target_max_length=m.target_max_length,
                    n_ques_types=m.n_ques_types, n_categories=m.n_categories,
                    feat_dim=m.feat_dim)

    def _log(self, msg: str) -> None:
        if self.verbose and is_main_process():
            print(msg, flush=True)
