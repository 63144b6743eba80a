#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
(an H100) and check them.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --base DIR   # phases 1-2, timed against DIR

Phases, each of which exits non-zero on failure:

1. Build every CUDA kernel of the paths from ``vqacl_tpu_torch/csrc``,
   one nvcc per source, all started together.
2. Kernel check: each kernel against its plain PyTorch version on the
   same inputs, with the tolerance printed beside the error, and a
   second launch on the same inputs equal bit for bit. K1 (the
   inference forward) at the eval shape and at rectangular and odd
   shapes; K1′ (training forward) and K2 (backward) at the train shape,
   rectangular and odd f32 shapes and the decoder shapes, at dropout 0
   and 0.1 (the plain version draws the kernels' own Philox mask, which
   is also compared bit for bit), timed also at the fused decoder's
   shapes; K1, K1′ and K2 at the edges of the bf16 tensor-core routes
   (Tq not a multiple of 16 with odd Sk, Sk = 128, Sk = 300, dk = 128),
   NExT-QA's encoder (23 text + 16 clip positions, a [12,23,23] bias: K1
   at the eval batch, timed; K1′ and K2 at the train batch, rates 0 and
   0.1, timed at 0.1; each also on merged q|k|v views, bit-equal to dense),
   and a bf16 call at dk = 8 refused with ValueError before any launch;
   each K1/K1′/K2 check names its route (``mma.sync bf16`` or ``scalar
   f32``); K5 (``dw_splitk``, xᵀ·g) on a ladder of shapes from the
   smallest up (``DW_LADDER``: one k-step and one tile, a K tail, D = F =
   768), the probe's shape (timed against the plain version and cuBLAS
   with f32 and with bf16 output), ``DW_ODD`` (one on the wgmma route,
   one on the mma route, each also in f32) and the f32 probe, each line
   naming its route (``wgmma``, ``mma``, ``f32``) and, on the wgmma
   route, its stream-K plan; N1 (``greedy_nms``, the greedy NMS of the
   RPN and the 36-box sweep) at the RPN's shape (6000 score-sorted boxes at IoU 0.7, a tail
   of invalid rows), the sweep's (300 boxes x 5 thresholds), all rows
   invalid and a scarce sweep, every keep mask bit-equal to its plain
   version and a second launch bit-equal. CUDA-event times of each kernel, its plain version and one
   library call (a yardstick only), queued behind a spin kernel so that
   they time the card's work and not the host's launch rate; K1 and K1′
   also with the host's enqueue included (``call_ms``). A bf16 training
   call that K2 cannot take (Sk = 512) is refused before K1′ launches.
3. The eval slice: random-init t5-base (seeded), cast for inference,
   bf16, ``make_eval_step`` at batch 100 on a synthetic batch; the
   launch counts over the timed steps; the encoder through the kernel
   against the unfused encoder; f32 tokens on the card against the CPU
   plain path on a tiny config.
4. The training slice: random-init t5-base, f32 master weights, bf16
   compute, dropout 0.1, ``make_train_step`` at batch 80 on one
   synthetic batch; ``train_step_ms``, the launch counts per step, every
   metric finite and the loss falling; at dropout 0 the parameter
   gradients through the kernels against the unfused encoder's; three
   f32 train steps on a tiny config on the card against the CPU plain
   path.
   4b. The same with the fused decoder (``fused_decoder``): the decoder's
   causal self-attention and cross-attention through K1′/K2 too (36
   launches of each per step), gradients against the unfused decoder,
   three tiny f32 steps on the card against the CPU, and
   ``make_loss_eval_step`` through K1 (36 launches per step) against the
   unfused decoder's loss.
   4c. Block recompute: one step from one state and one generator seed
   with ``remat`` False, "full" and "dots" gives the same loss,
   gradients and generator state; K1′ replays in the backward pass
   (72 launches per step); the peak device memory of each mode.
5. Serving: ``VQAServer`` over a ``VQAPredictor`` answers concurrent
   ``submit()`` calls with no errors.
6. ``vqacl_tpu_torch.mm_bench``: the probe's matrix products and the K5
   weight-gradient kernel ``dw_splitk`` at the probe's shapes, which must
   launch K5's wgmma route (the wrapper counts launches per route).
7. The continual-learning loop: ``VQACLTrainer`` on the random-init
   t5-base of phase 3 (bf16 compute, f32 master weights, dropout 0.1,
   train batch 80, eval batch 100) over two tasks of
   ``SyntheticDataModule`` data (feat_dim 2048, 36 boxes, a pool of 256
   images; 400 train, 100 val and 100 test items per task), one epoch,
   replay memory of 200; then the same with ``cl_reg`` "ewc" (two
   importance batches per task) and "derpp" at 160 train items per task.
   Each run is the loop as a user calls it and prints, from the
   trainer's own records, its wall time per task, the median train step
   and predict batch (CUDA events recorded around each call, no sync per
   call), the checkpoint save time, the host-time shares and K1/K1′/K2
   launches, which must equal what its steps and batches imply (K1 also
   at the DER capture's train batch, checked in phase 2); then a tiny f32
   ``CompVQACLTrainer`` run (comp_cate G5) on the card against the same
   run on the CPU: equal result matrices and answers, per-step losses
   within ``CL_LOSS_RTOL``.
8. The serving extras at t5-base (``serving_extras``): ``make_eval_step``
   with beam search (``BEAM`` beams, eval batch 100, 500 decoder rows,
   bf16; 12 K1 launches per step, CUDA-event times beside greedy's, the
   kernel launches per decode step from ``torch.profiler``), each row's
   beam sum log-prob (length penalty 0) at least greedy's in f32, and a
   tiny f32 config's beam (3, 5), ``max_length`` and ``early_stop=False``
   tokens on the card equal to the CPU's. A ``DeviceFeatureCache`` over
   ``CACHE_IMAGES`` random images (36 × 2048): the bf16 table equal bit for
   bit to the features rounded to bf16, the int8 table within half a
   row's scale, slot −1 and out-of-range slots zero; the cached bf16 eval
   step's tokens equal to the host path's on the same items, the cached
   train step's loss (batch 80, dropout 0) equal to the host path's
   within ``CACHED_LOSS_RTOL``, the host→device bytes per batch of both.
   An ER run of phase 7's loop with ``data.device_cache`` (bf16), then
   the same without the cache, each one's launches against its steps and
   batches, the first step's loss of the two within ``CACHED_LOSS_RTOL``;
   a tiny f32 run with an int8 cache on the card against the CPU. ``cli/serve_http.py`` on 127.0.0.1,
   port 0, over ``VQAServer(VQAPredictor(num_beams=BEAM, device_cache=…))``:
   ``HTTP_CLIENTS`` concurrent clients × ``HTTP_PER_CLIENT`` requests and
   one batched request answer as ``predictor.answer``; ``/healthz``,
   ``/stats``, ``/metrics``. A feature pack of ``PACK_IMAGES`` images
   written under ``build/``: ``PackedFeatureStore`` gives the source back
   and a predictor over it answers as one over the memory store.
9. The model extensions at t5-base (``model_extensions``): K1, K1′ and K2
   on strided views of the merged projection layouts (q|k|v [B,S,3·768],
   cross k|v [B,Sk,2·768], a 12-layer cross-K/V fold) at the eval, train
   and decoder shapes, rates 0 and 0.1, bf16 and f32, each bit-equal to
   the same kernel on dense copies, K2 also into one merged gradient
   buffer, and each strided launch counted; strided beside dense times;
   a bf16 row stride that is not a multiple of 8 refused with ValueError
   before any launch. ``make_train_step`` with ``merged_qkv`` (and with
   the fused decoder and ``folded_cross_kv``) at batch 80, bf16, dropout
   0.1, timed in turns with the separate path (``MERGED_ROUNDS`` rounds
   of separate, merged, merged, separate), 12 (36) strided K1′ and K2
   per step, loss and gradients at dropout 0 within phase 4's bound of
   the separate path's; greedy and beam tokens with merged and folded
   projections equal to the separate path's at batch 100; tiny f32
   merged + folded runs on the card equal to the CPU. The classifier
   head (``CLS_ANSWERS`` answers, batch 80, bf16): ``CLS_STEPS`` HF-AdamW
   steps over (params, head) on soft targets, the loss falling, 12 K1′
   and K2 per step; ``classifier_logits`` at batch 100 through K1, timed.
   Weights: t5-base through ``.pth``, ``model.safetensors`` (written by
   the port's own writer, read by ``load_t5_base``), ``export_pth`` on
   phase 7's ER checkpoint and the DCP directory checkpoint, each
   bit-equal, with seconds and bytes, and the eval step's tokens on the
   re-imported weights equal. VL-BART at bart-base's widths
   (``BART_CFG``): encode + decode forward at batch 80, bf16, finite and
   timed; a tiny f32 run on the card equal to the CPU within
   ``F32_CARD_RTOL``. Phase 7's loop resolves ``merged_qkv`` to True (as
   JAX's trainer does), so its launch checks also require every launch
   strided.
10. The training entry points at t5-base (``training_entry_points``). A
   reference-format VQA v2 root under ``build/`` (``P10_ITEMS`` questions
   per task of all ten tasks over ``P10_IMAGES`` images, the id maps, the
   v2 annotation file, the features as an LXMERT tsv converted by
   ``tsv_to_pack`` into ``coco_obj36.vfpack``), then
   ``cli/vqacl_train.py``'s ``main`` as a user runs it (``--from_scratch``,
   batch 80, eval batch 100, one epoch, memory 200, ``--device_cache``,
   bf16): the files JAX's CLI leaves, wall per task, host-time shares and
   K1/K1′/K2 launches against its steps and batches (all strided); the
   same argv without ``--now_train``: ``Test()`` over the ten checkpoints
   reproduces the training run's matrix, K1 only, 12 per predict batch.
   ``make_trainer`` without ``--from_scratch``, ``--backbone`` a
   directory with phase 3's weights as ``model.safetensors``: its starting
   parameters bit-equal to the file (and the scratch start not). NExT-QA
   (``NQ_TASKS`` over tables, ``NQ_ITEMS`` per task, 16 × 2048 motion
   features) through ``cli/nextqa_train.py``'s geometry and
   ``make_trainer``: K1/K1′/K2 at the 39-position encoder against its steps
   and batches, the WUPS score, backend and vocabulary coverage. Tiny f32
   runs of both CLIs through ``make_trainer`` at dropout 0 with
   ``--platform auto`` (the card) and ``--platform cpu``: equal result
   matrices, answers and metrics files, per-step losses within
   ``CL_LOSS_RTOL``. Everything written under ``build/`` is removed.
11. Region and video extraction at full width from seeded random weights
   (``extraction``; no detector or Kinetics weights are in the
   repository). ``extract_image`` (ResNet-101-C4, RPN with N1, RoIAlign,
   res5 and the heads, the 36-box N1 sweep) on ``P11_IMAGES`` synthetic
   BGR images of COCO sizes over three pad buckets, at torch's default
   TF32 flags: per image the CUDA-event ms of each stage, records of
   36 x 2048 finite features, boxes on the image, classes in 1..1600, two
   N1 launches per image, the peak device memory; ``extract_regions_batch``
   over four images of one bucket against the single-image calls in f32;
   ``extract_given_boxes`` at 36 boxes; the CLI's record generator
   (``cli/extract_features.py``) into a ``--pack`` under ``build/`` read
   back bit-equal by ``PackedFeatureStore``, and a t5-base ``VQAPredictor``
   over that pack answering one batch through K1 (12 launches); in f32
   (TF32 off for this check only), each detector stage on the card
   against the CPU on one small padded image, N1's ``select_proposals``
   and ``max_nms_fixed`` bit-equal on the CPU's inputs; ``extract_videos``
   on ``P11_VIDEOS`` ``.npy`` videos of 224² frames with the RGB-difference
   motion half and with the 3D-ResNeXt-101 (16 clips x 16 x 112²): feat
   [16, 4096], finite, ms per video, peak memory.
12. Data parallelism (``data_parallel``). (a) A one-rank NCCL mesh
   (``make_mesh`` over a file store): ``P12_STEPS`` t5-base train steps
   at batch 80, bf16, dropout 0.1 through the trainer's step path
   (``shard_batch``, ``make_train_step(mesh_ctx=...)``) give the meshless
   step's losses and parameters bit for bit, 12 K1′ + 12 K2 per step. (b)
   ``P12_RANKS`` ranks on the one card over gloo (NCCL refuses two ranks
   on one device), each this script in rank mode (``rank_main``): global
   batch 80 (40 per rank), bf16, ``P12_STEPS`` steps from the same state
   at dropout 0 (the ranks' parameters bit-equal, within phase 4's bound
   of a one-process run from the same state) and 0.1; 12 K1′ + 12 K2 per
   step per rank, the second rank's at its Philox row offset; the
   all_reduce bytes per step and one gradient bucket's all_reduce ms
   (staged through the host by gloo: a record, not a scaling number);
   on the second rank K1′ and K2 at its offset equal bit for bit to the
   same rows of one launch over the whole batch, the keep mask to the
   plain version's and to the one launch's rows, the outputs to the plain
   versions within the phase 2 tolerance. (c) The same steps under FSDP:
   parameters within phase 4's bound of (b)'s, parameter + moment bytes
   per rank half of (b)'s. (d) A tiny f32 ``VQACLTrainer`` ER run on the
   two ranks with the row-sharded device cache, on the card and on the
   CPU (the same gloo group): equal result matrices and answers, losses
   within ``CL_LOSS_RTOL``, the lookups' all_reduce bytes. Nothing here
   runs on more than one card.
13. Tensor and pipeline parallelism (``tensor_pipeline``), each part a
   group of ranks of this script on the one card over gloo, against the
   same steps run in one process from the same init and batch (global
   batch 80, bf16, f32 master weights): (a) tp = 2 with the "tp" layout
   (6 heads and d_ff 1536 per rank), ``P13_TP_STEPS`` steps at dropout 0
   and 0.1; (b) pp = 2 over ``P13_PP_MICRO`` microbatches of 20,
   replicated, ``P13_PP_STEPS`` steps at dropout 0; (c) tp = 2 x pp = 2
   on four ranks, "tp" layout, dropout 0. Each: losses within
   ``P13_LOSS_RTOL`` and parameters within phase 4's bound of one
   process's, bit-equal across the ranks; K1′ and K2 per step per rank
   (a stage's layers once per microbatch), the second tp rank's over its
   heads (``head_offset_launches``); the all_reduce bytes per step per
   group, step ms beside one process's; (a) parameter + moment bytes per
   rank against one process's (the tp-sliced leaves by half); (b) ticks
   per stack, hand-off bytes per tick and the dp x pp gradient bucket's
   bytes and ms. (d) A tiny f32 ER run of two tasks at tp = 2 and at pp
   = 2, on the card and on the CPU, with the one-process run's result
   matrix and answers, and rank 0's checkpoint loaded by the one-process
   trainer with the mesh run's parameters. (e) In phase 2: K1′ and K2
   over heads 6-11 with ``(Hc = 12, h0 = 6)`` at the train shape equal
   bit for bit to those heads of one launch over all 12 (o, p, dq, dk,
   dv, the dbias panel, the keep mask) and within the phase 2 tolerance
   of the plain versions.
14. The protocol scripts (``protocol_runs``), as a user runs them:
   (a) the Table-1 surrogate's ``P14_ROWS`` (vanilla, er, ours) at seed 0
   through ``vqacl_tpu_torch.ablation.run_row`` with the JAX script's
   defaults (5 tasks x 1000 train QA, 3 epochs, M = 100, 500 test QA, f32
   at tiny widths), each row a process of this script in rank mode, the
   three side by side with (b): each row's Avg_acc, Avg_forget,
   diag_acc and wall, its K1/K1′/K2 launches equal to what its train,
   replay, importance and predict counts imply, every one on the
   ``scalar f32`` route (the wrappers' ``route_launches``; phase 2 checks
   the surrogate's encoder shape, 4 heads of 8 over 10 positions, in
   f32), and the orderings ``P14_ORDERINGS`` (ours AP >= vanilla AP + 20,
   vanilla Forget >= ours Forget + 25, er AP >= vanilla AP + 10). (b) The
   "ours" row cut to ``P14_CUT_ARGV`` (two tasks x 64 train QA, one
   epoch) from one init at dropout 0, on the card and on the CPU, at the
   surrogate's lr (1e-2) and at ``P14_CUT_LR`` (1e-3): equal result
   matrices, answers and metrics at both, per-step losses within
   ``CL_LOSS_RTOL`` at 1e-3 (at 1e-2 the training amplifies f32 rounding
   past it: the losses' error is recorded). (c) The small soak at t5-base
   through ``vqacl_tpu_torch.soak.run`` (ten tasks x 1000 train QA, M =
   1000, the bf16 device cache), alone: the 55-cell matrix complete,
   finite metrics, launches equal to its counts, every one on the
   ``mma.sync bf16`` route; the card's busy share over three train
   steps (the soak's ``torch.profiler`` window).

The second-to-last lines are a JSON object of per-kernel numbers and the
card's name and power limit; the last line is the run's verdict as JSON.
Without a CUDA device, or outside a checkout, it prints no result and
exits non-zero.

``--base DIR`` compares this checkout's kernels with another's on the
same card in one run: DIR holds that checkout (for example ``git archive
<commit> | tar -x -C build/base``), whose ``vqacl_tpu_torch/csrc`` is
built beside this one's (the kernels whose source it has: N1 is left out
when it has no ``nms.cu``). Phases 1 and 2 run; every timed K1, K1′, K2,
N1 and K5 (at the probe's shape: a library from before the wgmma route
takes its own route) is timed through the same wrappers and inputs with
DIR's libraries too,
in the order base, this, this, base, on both measures (device and
``call_ms``). The C signatures must be the same in both. The run then
prints an ``ab`` JSON line and stops.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
# cycles per second a spin kernel is sized with: above the H100's boost
# clock (1.98 GHz), so a spin lasts at least as long as asked
SPIN_HZ = 2.0e9
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output
# rounding (2^-8 relative) and a p rounded to bf16 on either side of a
# tie give up to ~2 ulps; f32 differs only in summation order. K1′'s p
# and K2's dbias are f32 whatever the inputs' dtype.
TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}
EVAL_BATCH = 100
EVAL_STEPS = 3
TRAIN_BATCH = 80
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
DROPOUT = 0.1
# parameter gradients through the kernels vs the unfused encoder, as
# ‖g_kernel − g_plain‖ / ‖g_plain‖ over all parameters: in bf16 the two
# backward passes round at different points (autograd of the plain path
# takes the bf16-rounded probabilities, K2 works in f32), in f32 only the
# summation order differs
GRAD_REL_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
SMALL_PARAM_TOL = 3e-5
# the loss-eval step through the fused decoder vs the unfused decoder,
# relative: bf16 rounds p before p·v in the kernel and after the f32
# softmax in the plain path; f32 differs only in summation order
LOSS_EVAL_RTOL = {"bfloat16": 5e-3, "float32": 1e-5}
# remat replays the block's own arithmetic on the same inputs, so the
# gradients agree to the last bit; the bound leaves room for nothing else
REMAT_GRAD_RTOL = 1e-6
# K5 (xᵀ·g) at the probe's shape (K = batch x sequence rows of the MLP
# input, D = d_model, F = d_ff), after a ladder from the smallest shape up
# (one k-step and one tile, one k-block, a K tail, F = D), and at odd
# shapes (the wgmma and the mma route); both sides sum in f32 in other
# orders: |kernel - plain| <= DW_RTOL * Σ_k|x_kd g_kf| + 1e-6
DW_LADDER = ((16, 64, 128), (64, 128, 256), (1000, 768, 3072),
             (4480, 768, 768))
DW_PROBE = (4480, 768, 3072)
DW_ODD = ((100, 40, 72), (97, 131, 257))
DW_RTOL = 1e-5
MM_BENCH_SHAPES = None       # None: the probe's own
MM_BENCH_REPS = 5
# (name, B, Tq, Sk, H, dk, L): the edges of the bf16 tensor-core routes
# of K1/K1′ and K2 -- Tq not a multiple of 16 with odd Sk, one full
# 128-key tile (two 64-key tiles in K2), 300 keys (the two-sweep softmax;
# five key tiles, two sweeps, in K2), the widest head they take.
BF16_EDGES = (("ragged_bf16", 16, 33, 29, 12, 64, 5),
              ("keys128_bf16", 8, 56, 128, 12, 64, 20),
              ("keys300_bf16", 4, 40, 300, 12, 64, 20),
              ("dk128_bf16", 16, 56, 56, 6, 128, 20))
# a bf16 shape K1′ takes and K2 does not: its bf16 block holds the panels
# and the whole [Tq, Sk] ds and pd tiles, which 512 keys exceed
K2_REFUSED = ("keys512_bf16", 4, 40, 512, 12, 64, 20)
# set by --base: another checkout's kernel sources, timed beside these
BASE_CSRC = None
# phase 7, the continual-learning loop: two tasks of SyntheticDataModule
# data over a pool of CL_IMAGES images (t5-base: feat_dim 2048, 36 boxes),
# items per task (train, val, test); the EWC and DER++ runs train on
# CL_REG_TRAIN items per task; the tiny f32 run card vs CPU on CL_TINY
CL_TASKS = ("q_recognition", "q_location")
CL_ITEMS = (400, 100, 100)
CL_REG_TRAIN = 160
CL_IMAGES = 256
CL_M_SIZE = 200
CL_FISHER_BATCHES = 2
CL_TINY = (48, 16, 16)
CL_TINY_BATCH = 16
# per-step losses of the tiny f32 CL run, card vs CPU, relative
CL_LOSS_RTOL = 1e-5
# phase 8, the serving extras: beams, timed beam eval steps, images of the
# device cache (t5-base rows, 36 x 2048), HTTP clients x requests each,
# images in the feature pack
BEAM = 5
BEAM_STEPS = 3
CACHE_IMAGES = 4096
HTTP_CLIENTS, HTTP_PER_CLIENT = 16, 3
PACK_IMAGES = 256
# int8: |q*s - x| <= s/2 plus the f32 rounding of x/s and of q*s, each at
# most 127 * 2^-24 * s
INT8_SLACK = 2e-5
# the cached train step against the host path's, from one state at
# dropout 0 (the same bf16 features reach the encoder), relative
CACHED_LOSS_RTOL = 1e-6
# beam (length penalty 0) vs greedy: teacher-forced f32 sum log-probs of
# the two sequences; only the incremental and teacher-forced sums differ
BEAM_LOGP_TOL = 1e-3
# phase 9, the model extensions: rounds of train steps timed in turns
# (separate, merged, merged, separate); the classifier head's answers and
# optimizer steps; a misaligned row stride (not a multiple of 8 bf16
# elements) that the bf16 kernels must refuse
MERGED_ROUNDS = 3
CLS_ANSWERS = 3129
CLS_STEPS = 5
CLS_LR = 1e-4
BAD_STRIDE_PAD = 4
# VL-BART at bart-base's published widths (HF facebook/bart-base config:
# d_model 768, 6+6 layers, 12 heads, ffn 3072, vocab 50265, 1024
# positions), with VL-T5's region input (36 regions x 2048) and the
# text/answer lengths of the VQA configuration; random weights
BART_CFG = dict(vocab_size=50265, d_model=768, num_heads=12, d_ff=3072,
                num_layers=6, num_decoder_layers=6,
                max_position_embeddings=1024, pad_token_id=1,
                eos_token_id=2, decoder_start_token_id=2, dropout_rate=0.1,
                feat_dim=2048, pos_dim=4, n_images=2,
                use_vis_order_embedding=True, use_vis_layer_norm=True,
                individual_vis_layer_norm=True, layer_norm_epsilon=1e-5,
                use_vision=True, n_boxes=36, text_len=20, target_len=10)
BART_TINY = dict(BART_CFG, vocab_size=128, d_model=32, num_heads=4, d_ff=64,
                 num_layers=2, num_decoder_layers=2,
                 max_position_embeddings=64, dropout_rate=0.0, feat_dim=16,
                 n_boxes=4, text_len=6, target_len=5)
# f32 on the card vs the CPU: the same products summed in other orders
F32_CARD_RTOL = 1e-5
# phase 7's ER checkpoint, kept under the gitignored build/ for phase 9
P7_DIR = os.path.join(HERE, "build", "chip_smoke", "phase7")
P7_CKPT = os.path.join(P7_DIR, "er_LAST.npz")
# phase 10, the training entry points: a reference-format VQA v2 root
# of all ten tasks (train/val/test items per task over a pool of images,
# features as an LXMERT tsv converted into the pack), NExT-QA's two first
# tasks over tables (items per task, videos of 16 x 2048 motion
# features), the tiny f32 CLI runs' items per task and batch; all under
# the gitignored build/, removed at the end of the phase
P10_ITEMS = (200, 20, 20)
P10_IMAGES = 256
NQ_TASKS = ("CW", "TN")
NQ_ITEMS = (400, 100, 100)
NQ_VIDEOS = 256
P10_TINY = (24, 8, 8)
P10_TINY_BATCH = 16
P10_DIR = os.path.join(HERE, "build", "chip_smoke", "phase10")
# N1 as (boxes, thresholds, invalid rows at the end): the RPN's shape,
# the pre-NMS top 6000 boxes of an 800 x 1344 image at IoU 0.7 with a
# tail of invalid rows (the -inf scores of the RPN's top-k); the 36-box
# sweep, 300 proposals x 5 thresholds
NMS_RPN = (6000, (0.7,), 600)
NMS_SWEEP = (300, (0.5, 0.6, 0.7, 0.8, 0.9), 0)
NMS_IMAGE = (1344.0, 800.0)
# N1's plain version is a host loop over the boxes: few timed calls
NMS_PLAIN_ITERS = 3
# phase 11, region and video extraction: COCO image sizes (h, w) that
# reach three pad buckets; four sizes of one bucket for the batch; the
# f32 card-vs-CPU image (padded size, true size) and its proposals;
# videos of frames at the appearance side, the 3D backbone's clip side
P11_IMAGES = ((480, 640), (640, 480), (427, 640), (375, 500))
P11_BATCH_IMAGES = ((480, 640), (375, 500), (600, 800), (450, 600))
P11_F32_IMAGE = ((256, 320), (224, 300))
P11_F32_PROPOSALS = 64
P11_VIDEOS = 2
P11_VIDEO_FRAMES = 48
P11_VIDEO_SIDE = 224
P11_MOTION_SIDE = 112
# f32 on the card against the CPU (and a batch against single images):
# max|card - cpu| <= P11_F32_RTOL * max|cpu| per stage output, the same
# convolutions summed in other orders through 34 residual blocks
P11_F32_RTOL = 1e-4
# scores count as well separated when sorted neighbours differ by more
# than this, relative: then the whole pipeline's selections must agree
P11_SEPARATED = 1e-3
P11_DIR = os.path.join(HERE, "build", "chip_smoke", "phase11")
# NExT-QA answers: words the vendored WordNet taxonomy knows and two it
# does not, so WUPS scores real Wu-Palmer pairs and its coverage shows
NQ_ANSWERS = ("dog", "cat", "man", "woman", "baby", "ball", "car", "bike",
              "table", "chair", "grass", "water", "playing", "eating",
              "walking", "red", "blue")


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fns, iters=50, warmup=5, spin=True) -> float:
    """Mean CUDA-event time of one call, cycling through ``fns`` (one per
    input set, so each call finds its inputs out of L2 as the encoder's
    layer-to-layer traffic would). With ``spin`` the timed calls are
    queued behind a spin kernel that outlasts their enqueue on the host,
    so the events time the card's work back to back (the device time);
    without it, calls issued back to back from the host, whichever of
    host and card is slower (the time a caller sees per call)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(min(2.0 * host_s, 1.0) * SPIN_HZ))
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ab(fns, spin=True):
    """``time_ms(fns)`` → (ms, base_ms). With ``--base`` the same calls
    also run on the base checkout's libraries (the wrappers load them by
    name at each call), in the order base, this, this, base; each side's
    time is the mean of its two. Without it base_ms is None."""
    if BASE_CSRC is None:
        return time_ms(fns, spin=spin), None
    from vqacl_tpu_torch.ops import _build

    load = _build.load

    def on_base():
        _build.load = lambda name: load(name, BASE_CSRC)
        try:
            return time_ms(fns, spin=spin)
        finally:
            _build.load = load

    b1 = on_base()
    t1, t2 = time_ms(fns, spin=spin), time_ms(fns, spin=spin)
    b2 = on_base()
    log(f"  ab {'device' if spin else 'call'}: base {b1:.5f} this {t1:.5f} "
        f"this {t2:.5f} base {b2:.5f} ms")
    return (t1 + t2) / 2, (b1 + b2) / 2


def put_ab(row, key, times):
    """row[key] = this checkout's time; row["base_" + key] = the base's."""
    row[key], base = times
    if base is not None:
        row["base_" + key] = base


def _bound(nbytes, ops_s):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations' seconds at their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_inputs(B, Tq, Sk, H, dk, L, dtype, text_len, seed):
    """q/k/v [B,S,H·dk], bias [H,L,L] f32 or None, mask [B,Sk] f32 with a
    ragged text part (the first ``text_len`` keys) and visual keys on."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = (0.25 * torch.randn(B, Tq, H * dk, generator=g, device=dev)).to(dtype)
    k = (0.25 * torch.randn(B, Sk, H * dk, generator=g, device=dev)).to(dtype)
    v = torch.randn(B, Sk, H * dk, generator=g, device=dev).to(dtype)
    bias = torch.randn(H, L, L, generator=g, device=dev) if L else None
    mask = torch.ones(B, Sk, device=dev)
    n_text = torch.randint(1, text_len + 1, (B,), generator=g, device=dev)
    pos = torch.arange(Sk, device=dev)[None, :]
    mask[(pos < text_len) & (pos >= n_text[:, None])] = 0.0
    return q, k, v, bias, mask


def check_attention(fa, name, B, Tq, Sk, H, dk, L, dtype,
                    text_len=None, timed=False):
    """Kernel vs plain version; with ``timed`` also the times and bound."""
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len or Sk, seed=B + Tq + Sk)
    route = fa.ROUTE_NAMES[fa.fwd_route(dt, dk, Tq, Sk)]
    out = fa.fused_attention(q, k, v, bias, mask, H)
    again = fa.fused_attention(q, k, v, bias, mask, H)
    ref = fa.fused_attention_reference(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    if out.dtype != dt or out.shape != (B, Tq, H * dk):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    same = torch.equal(out, again)
    log(f"kernel_check {name}: route={route} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} max_abs_err={err:.3e} tol=atol {atol:g} + "
        f"rtol {rtol:g}; second launch equal: {same} -> "
        f"{'ok' if ok and same else 'MISMATCH'}")
    if not (ok and same):
        fail(f"{name}: kernel disagrees with its plain version or itself")
    row = {"max_abs_err": err}
    if not timed:
        return row
    sets = [(q, k, v, bias, mask)] + [
        attention_inputs(B, Tq, Sk, H, dk, L, dt, text_len or Sk,
                         seed=100 + i) for i in range(3)]
    F = torch.nn.functional

    def sdpa_args(q, k, v, bias, mask):
        heads = lambda x: x.view(B, -1, H, dk).transpose(1, 2)
        add = torch.zeros(B, H, Tq, Sk, device="cuda")
        if bias is not None:
            add[:, :, :L, :L] = bias
        add = add + ((1.0 - mask) * -1e9)[:, None, None, :]
        return heads(q), heads(k), heads(v), add.to(dt)

    lib_sets = [sdpa_args(*s) for s in sets]
    k1_calls = [lambda s=s: fa.fused_attention(*s, H) for s in sets]
    put_ab(row, "ms", time_ab(k1_calls))
    put_ab(row, "call_ms", time_ab(k1_calls, spin=False))
    row["plain_ms"] = time_ms([
        lambda s=s: fa.fused_attention_reference(*s, H) for s in sets])
    row["library_ms"] = time_ms([
        lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                   attn_mask=a[3], scale=1.0)
        for a in lib_sets])
    elem = q.element_size()
    nbytes = (2 * B * Tq + 2 * B * Sk) * H * dk * elem + B * Sk * 4 \
        + H * L * L * 4
    flops = 4 * B * H * Tq * Sk * dk
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS[dtype])
    log(f"kernel_time {name}: kernel_ms={row['ms']:.5f} "
        f"plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
        f"{flops} FLOP); call_ms={row['call_ms']:.5f} (host enqueue "
        f"included)")
    return row


def train_attention_inputs(B, Tq, Sk, H, dk, L, dtype, text_len, seed,
                           causal=False):
    """attention_inputs plus do [B,Tq,H·dk]; with ``causal`` the bias is
    the decoder's full [H,T,T] bias (−1e9 above the diagonal) and every
    key is on, as the decoder's self-attention has it."""
    q, k, v, bias, mask = attention_inputs(B, Tq, Sk, H, dk, L, dtype,
                                           text_len, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(B, Tq, H * dk, generator=g, device="cuda").to(dtype)
    if causal:
        up = torch.triu(torch.ones(L, L, device="cuda"), diagonal=1)
        bias = bias + up * -1e9
        mask = torch.ones_like(mask)
    return q, k, v, do, bias, mask


def _close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    return float(diff.max()), ok


def check_train_attention(fa, name, B, Tq, Sk, H, dk, L, dtype, rate,
                          text_len=None, causal=False, timed=False):
    """K1′ and K2 vs their plain versions (the plain version draws the
    kernels' Philox mask; that mask is checked against the kernels' own
    bit for bit), and each kernel's second launch against its first. With
    ``timed``: times, bounds and library yardsticks. → (K1′ row, K2
    row)."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len or Sk, seed=B + Tq + Sk,
        causal=causal)
    seed = torch.tensor([20260 + Tq], dtype=torch.int32, device="cuda")
    route = fa.ROUTE_NAMES[fa.fwd_route(dt, dk, Tq, Sk)]
    bwd_route = fa.bwd_route(dt, dk, Tq, Sk, rate)
    o, p = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H, rate)
    o2, p2 = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H,
                                          rate)
    ro, rp = fa.fused_attention_fwd_train_reference(q, k, v, bias, mask,
                                                    seed, H, rate)
    grads = fa.fused_attention_bwd(q, k, v, p, seed, do, H, L, rate)
    grads2 = fa.fused_attention_bwd(q, k, v, p, seed, do, H, L, rate)
    rgrads = fa.fused_attention_bwd_reference(q, k, v, rp, seed, do, H, L,
                                              rate)
    torch.cuda.synchronize()
    if o.dtype != dt or o.shape != (B, Tq, H * dk) \
            or p.shape != (B, H * Tq, Sk):
        fail(f"{name}: K1' output {o.dtype} {tuple(o.shape)} p "
             f"{tuple(p.shape)}")
    errs, oks = {}, []
    pairs = [("o", o, ro, dtype), ("p", p, rp, "float32"),
             ("dq", grads[0], rgrads[0], dtype),
             ("dk", grads[1], rgrads[1], dtype),
             ("dv", grads[2], rgrads[2], dtype)]
    if L:
        pairs.append(("dbias", grads[3], rgrads[3], "float32"))
    elif grads[3] is not None:
        fail(f"{name}: K2 wrote dbias with L = 0")
    for key, a, b, tol_dt in pairs:
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    kept = 1.0
    if rate:
        mine = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate)
        plain = fa.philox_keep_mask(seed, B, H, Tq, Sk, rate)
        kept = float(mine.float().mean())
        if not torch.equal(mine, plain):
            fail(f"{name}: the PyTorch Philox mask differs from the "
                 f"kernels'")
        if abs(kept - (1 - rate)) > 0.02:
            fail(f"{name}: kept share {kept:.4f} for rate {rate}")
    same = torch.equal(o, o2) and torch.equal(p, p2)
    same_bwd = all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(grads, grads2))
    oks += [same, same_bwd]
    atol, rtol = TOL[dtype]
    log(f"kernel_check {name}: route={route} K2 route="
        f"{fa.ROUTE_NAMES[bwd_route]} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} rate={rate} kept={kept:.4f} max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
        + f" tol=atol {atol:g} + rtol {rtol:g} (p, dbias: f32 tol); second "
        f"launch equal: K1' {same}, K2 {same_bwd} -> "
        f"{'ok' if all(oks) else 'MISMATCH'}")
    if not all(oks):
        fail(f"{name}: K1'/K2 disagree with their plain versions or with "
             f"themselves")
    fwd_row = {"max_abs_err": max(errs["o"], errs["p"])}
    bwd_row = {"max_abs_err": max(v for k, v in errs.items()
                                  if k not in ("o", "p"))}
    if not timed:
        return fwd_row, bwd_row

    sets = [(q, k, v, do, bias, mask)] + [
        train_attention_inputs(B, Tq, Sk, H, dk, L, dt, text_len or Sk,
                               seed=200 + i) for i in range(3)]
    ps = [fa.fused_attention_fwd_train(s[0], s[1], s[2], s[4], s[5], seed,
                                       H, rate)[1] for s in sets]
    k1p_calls = [lambda s=s: fa.fused_attention_fwd_train(
        s[0], s[1], s[2], s[4], s[5], seed, H, rate) for s in sets]
    put_ab(fwd_row, "ms", time_ab(k1p_calls))
    put_ab(fwd_row, "call_ms", time_ab(k1p_calls, spin=False))
    fwd_row["plain_ms"] = time_ms([
        lambda s=s: fa.fused_attention_fwd_train_reference(
            s[0], s[1], s[2], s[4], s[5], seed, H, rate) for s in sets])
    put_ab(bwd_row, "ms", time_ab([
        lambda s=s, p=p: fa.fused_attention_bwd(s[0], s[1], s[2], p, seed,
                                                s[3], H, L, rate)
        for s, p in zip(sets, ps)]))
    bwd_row["plain_ms"] = time_ms([
        lambda s=s, p=p: fa.fused_attention_bwd_reference(
            s[0], s[1], s[2], p, seed, s[3], H, L, rate)
        for s, p in zip(sets, ps)])
    lib = sdpa_times(sets, B, Tq, Sk, H, dk, L, dt, rate)
    fwd_row["library_ms"], bwd_row["library_ms"] = lib["fwd"], lib["bwd"]

    elem = q.element_size()
    panel = H * dk * elem
    p_bytes = B * H * Tq * Sk * 4
    small = B * Sk * 4 + H * L * L * 4 + 4
    prod = 2 * B * H * Tq * Sk * dk          # one [Tq,Sk]x[·,dk] product
    peak = PEAK_FLOPS[dtype]
    f32 = PEAK_FLOPS["float32"]
    # K1': q,k,v in, o and p out; q·k and p·v on the inputs' type
    fwd_bytes = (2 * B * Tq + 2 * B * Sk) * panel + p_bytes + small
    fwd_ops_s = 2 * prod / peak
    # K2: q,k,v,do,p in, dq,dk,dv out; on the tensor-core route all four
    # products on the bf16 tensor cores, on the scalar route do·vᵀ on the
    # inputs' type and the three with the f32 p or ds on f32
    bwd_bytes = ((2 * B * Tq + 2 * B * Sk) * panel + p_bytes
                 + (B * Tq + 2 * B * Sk) * panel + H * L * L * 4 + 4)
    bwd_ops_s = (4 * prod / peak if bwd_route == "mma"
                 else prod / peak + 3 * prod / f32)
    for row, nbytes, ops_s, flops in ((fwd_row, fwd_bytes, fwd_ops_s,
                                       2 * prod),
                                      (bwd_row, bwd_bytes, bwd_ops_s,
                                       4 * prod)):
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops_s)
        row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name} K1': kernel_ms={fwd_row['ms']:.5f} "
        f"plain_ms={fwd_row['plain_ms']:.5f} "
        f"library_ms={fwd_row['library_ms']:.5f} ({lib['backend']} fwd) "
        f"bound_ms={fwd_row['bound_ms']:.5f} ({fwd_row['bound_by']}: "
        f"{fwd_bytes} B, {2 * prod} FLOP); call_ms={fwd_row['call_ms']:.5f} "
        f"(host enqueue included)")
    log(f"kernel_time {name} K2 ({fa.ROUTE_NAMES[bwd_route]}): "
        f"kernel_ms={bwd_row['ms']:.5f} "
        f"plain_ms={bwd_row['plain_ms']:.5f} "
        f"library_ms={bwd_row['library_ms']:.5f} ({lib['backend']} "
        f"fwd+bwd {lib['fwd_bwd']:.5f} - fwd) "
        f"bound_ms={bwd_row['bound_ms']:.5f} ({bwd_row['bound_by']}: "
        f"{bwd_bytes} B, {4 * prod} FLOP)")
    return fwd_row, bwd_row


def sdpa_times(sets, B, Tq, Sk, H, dk, L, dt, rate):
    """PyTorch SDPA with the same additive bias and dropout: forward
    time, and its backward as forward+backward minus forward, on the
    first backend that takes the inputs. Yardsticks only."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    heads = lambda x: x.view(B, -1, H, dk).transpose(1, 2)

    def args(q, k, v, do, bias, mask):
        add = torch.zeros(B, H, Tq, Sk, device="cuda")
        if bias is not None:
            add[:, :, :L, :L] = bias
        add = add + ((1.0 - mask) * -1e9)[:, None, None, :]
        return ([heads(x).detach().requires_grad_() for x in (q, k, v)],
                heads(do), add.to(dt))

    lib_sets = [args(*s) for s in sets]
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                def fwd(a):
                    with torch.no_grad():
                        F.scaled_dot_product_attention(
                            *a[0], attn_mask=a[2], dropout_p=rate, scale=1.0)

                def fwd_bwd(a):
                    out = F.scaled_dot_product_attention(
                        *a[0], attn_mask=a[2], dropout_p=rate, scale=1.0)
                    out.backward(a[1])

                fwd_bwd(lib_sets[0])
                t_fwd = time_ms([lambda a=a: fwd(a) for a in lib_sets])
                t_all = time_ms([lambda a=a: fwd_bwd(a) for a in lib_sets])
        except RuntimeError as e:
            log(f"sdpa {backend.name}: not usable here ({e})")
            continue
        return {"backend": backend.name, "fwd": t_fwd, "fwd_bwd": t_all,
                "bwd": t_all - t_fwd}
    fail("no SDPA backend takes the attention inputs")


def check_refused(fa):
    """A bf16 call at dk = 8 (the tiny config's head width) is refused by
    K1's and K1′'s wrappers with ValueError, before any launch; so is a
    differentiable call at 512 keys, which K1′ takes and K2 does not."""
    q, k, v, bias, mask = attention_inputs(2, 8, 8, 4, 8, 0, torch.bfloat16,
                                           8, seed=1)
    seed = torch.zeros((1,), dtype=torch.int32, device="cuda")
    counts = lambda: (fa.fused_attention.launches,
                      fa.fused_attention_fwd_train.launches)
    before = counts()
    msgs = []
    for call in (lambda: fa.fused_attention(q, k, v, bias, mask, 4),
                 lambda: fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                      seed, 4, DROPOUT)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
            continue
        fail("a bf16 call at dk = 8 was not refused")
    if counts() != before:
        fail(f"a refused bf16 call launched a kernel: {before} -> {counts()}")
    log(f"kernel_check refused_bf16_dk8: K1 and K1' raise ValueError before "
        f"any launch ({msgs[0]})")
    name, B, Tq, Sk, H, dk, L = K2_REFUSED
    q, k, v, bias, mask = attention_inputs(B, Tq, Sk, H, dk, L,
                                           torch.bfloat16, L, seed=2)
    counts = lambda: (fa.fused_attention_fwd_train.launches,
                      fa.fused_attention_bwd.launches)
    before = counts()
    try:
        fa.fused_attention(q.requires_grad_(), k, v, bias, mask, H, DROPOUT,
                           seed)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"a differentiable call at {name}'s shape was not refused")
    if counts() != before:
        fail(f"a refused training call launched K1'/K2: {before} -> "
             f"{counts()}")
    log(f"kernel_check refused_bwd_{name}: a training call raises "
        f"ValueError before K1' launches ({msg})")


def dw_inputs(K, D, F, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(K, D, generator=g, device="cuda").to(dtype)
    dy = torch.randn(K, F, generator=g, device="cuda").to(dtype)
    return x, dy


def dw_sms():
    """The card's SM count (the plan the wgmma route runs is printed for
    it)."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def mm_f32_out(a, b):
    """One cuBLAS product of bf16 operands with f32 output, as K5 writes:
    K5's library yardstick."""
    return torch.mm(a, b, out_dtype=torch.float32)


def check_dw(dw, name, K, D, F, dtype, timed=False):
    """K5 vs its plain version (and a second launch bit for bit) on the
    route ``dw.dw_route`` picks; with ``timed`` also the times, bound and
    library yardsticks."""
    dt = getattr(torch, dtype)
    x, dy = dw_inputs(K, D, F, dt, seed=K + D + F)
    route = dw.dw_route(K, D, F, dt, x, dy)
    ref = dw.dw_splitk_reference(x, dy)
    scale = x.float().abs().t() @ dy.float().abs()
    tol = DW_RTOL * scale + 1e-6
    out = dw.dw_splitk(x, dy)
    again = dw.dw_splitk(x, dy)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (D, F):
        fail(f"{name}: output {out.dtype} {tuple(out.shape)}")
    diff = (out - ref).abs()
    err = float(diff.max())
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(out).all())
    same = torch.equal(out, again)
    plan = ""
    if route == "wgmma":
        p = dw.dw_plan(K, D, F, dw_sms())
        plan = (f" N={dw.TILE_N} (plan: {p.tiles} tiles x {p.k_blocks} "
                f"k-blocks on {p.units} clusters of {dw.CLUSTER}, "
                f"{len(p.splits())} split)")
    log(f"kernel_check {name}: route={route}{plan} K={K} D={D} F={F} "
        f"{dtype} max_abs_err={err:.3e} max err/tol="
        f"{float((diff / tol).max()):.3e} tol={DW_RTOL:g}*sum|x*g| + "
        f"1e-6; second launch equal: {same} -> "
        f"{'ok' if ok and same else 'MISMATCH'}")
    if not (ok and same):
        fail(f"{name}: dw_splitk disagrees with its plain version or "
             f"with itself")
    row = {"route": route, "max_abs_err": err}
    if not timed:
        return row
    sets = [(x, dy)] + [dw_inputs(K, D, F, dt, seed=300 + i)
                        for i in range(3)]
    put_ab(row, "ms", time_ab([lambda s=s: dw.dw_splitk(*s) for s in sets]))
    row["plain_ms"] = time_ms([lambda s=s: dw.dw_splitk_reference(*s)
                               for s in sets])
    # cuBLAS with bf16 out (it sums in f32 and rounds the result) and with
    # f32 out as K5 writes: the yardstick
    row["library_bf16_ms"] = time_ms([lambda s=s: torch.matmul(s[0].t(), s[1])
                                      for s in sets])
    row["library_ms"] = time_ms([lambda s=s: mm_f32_out(s[0].t(), s[1])
                                 for s in sets])
    elem = x.element_size()
    nbytes = (K * D + K * F) * elem + D * F * 4
    flops = 2 * K * D * F
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS[dtype])
    row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name} ({route}): kernel_ms={row['ms']:.5f} "
        f"plain_ms={row['plain_ms']:.5f} library_ms: cuBLAS f32 out "
        f"{row['library_ms']:.5f}, bf16 out {row['library_bf16_ms']:.5f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
        f"{flops} FLOP)")
    return row


def nms_inputs(N, n_invalid, seed, clusters=0):
    """N boxes on an ``NMS_IMAGE`` image (anchor-like sizes 16..512 px),
    the last ``n_invalid`` rows invalid; with ``clusters``, N copies of
    that many boxes of 64..512 px jittered by ±0.25 px (IoU > 0.9 within
    a cluster), so that even IoU 0.9 keeps few."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W, H = NMS_IMAGE
    n = clusters or N
    lo = 64.0 if clusters else 16.0
    xy = torch.rand(n, 2, generator=g, device="cuda") * torch.tensor(
        [W, H], device="cuda")
    wh = lo + (512.0 - lo) * torch.rand(n, 2, generator=g,
                                        device="cuda") ** 2
    boxes = torch.cat([xy, xy + wh], dim=1)
    if clusters:
        boxes = boxes[torch.arange(N, device="cuda") % clusters] + 0.25 * (
            2.0 * torch.rand(N, 4, generator=g, device="cuda") - 1.0)
    valid = torch.arange(N, device="cuda") < N - n_invalid
    return boxes.contiguous(), valid


def check_nms(nms, name, N, thresholds, n_invalid=0, clusters=0,
              timed=False, seed=0):
    """N1 vs its plain version: every keep mask bit-equal, a second
    launch bit-equal; with ``timed`` also the times and the bound."""
    boxes, valid = nms_inputs(N, n_invalid, seed, clusters)
    thr = torch.tensor(thresholds, dtype=torch.float32, device="cuda")
    before = nms.greedy_nms.launches
    keep = nms.greedy_nms(boxes, valid, thr)
    again = nms.greedy_nms(boxes, valid, thr)
    ref = nms.greedy_nms_reference(boxes, valid, thr)
    torch.cuda.synchronize()
    nms.greedy_nms.launches = before      # check launches are not counted
    diff = int((keep != ref).sum())
    same = torch.equal(keep, again)
    kept = keep.sum(dim=1).tolist()
    log(f"kernel_check {name}: N1 N={N} T={len(thresholds)} thresholds "
        f"{list(thresholds)} invalid={n_invalid} kept={kept} keep bits "
        f"differing from plain={diff} (tol 0); second launch equal: {same} "
        f"-> {'ok' if diff == 0 and same else 'MISMATCH'}")
    if diff or not same:
        fail(f"{name}: N1 disagrees with its plain version")
    row = {"max_abs_err": float(diff), "kept": kept}
    if not timed:
        return row
    sets = [(boxes, valid, thr)] + [
        nms_inputs(N, n_invalid, 400 + i, clusters) + (thr,)
        for i in range(3)]
    fns = [lambda s=s: nms.greedy_nms(*s) for s in sets]
    if BASE_CSRC is not None and not os.path.exists(
            os.path.join(BASE_CSRC, "nms.cu")):
        row["ms"] = time_ms(fns)
    else:
        put_ab(row, "ms", time_ab(fns))
    nms.greedy_nms.launches = before
    plain = [lambda s=s: nms.greedy_nms_reference(*s) for s in sets]
    row["plain_ms"] = time_ms(plain, iters=NMS_PLAIN_ITERS, warmup=1)
    row["plain_call_ms"] = time_ms(plain, iters=NMS_PLAIN_ITERS, warmup=1,
                                   spin=False)
    # PyTorch has no NMS of its own (torchvision's is a library apart)
    row["library_ms"] = None
    T = len(thresholds)
    # each input read once, the keep masks written once; every pair of
    # boxes once: 2 max, 2 min, 2 sub, 2 clamps, 1 mul, 1 add, 1 sub,
    # 1 div and T compares (f32, off the tensor cores), plus N areas
    nbytes = N * 16 + N + 4 * T + T * N
    flops = N * (N - 1) // 2 * (12 + T) + 5 * N
    row["bound_ms"], row["bound_by"] = _bound(nbytes,
                                              flops / PEAK_FLOPS["float32"])
    row["bytes"], row["flops"] = nbytes, flops
    log(f"kernel_time {name}: kernel_ms={row['ms']:.5f} plain_ms="
        f"{row['plain_ms']:.5f} plain_call_ms={row['plain_call_ms']:.5f} "
        f"library_ms=None (no NMS in PyTorch) bound_ms={row['bound_ms']:.6f} "
        f"({row['bound_by']}: {nbytes} B, {flops} FLOP; the {N} decisions "
        f"are a dependent chain the bound does not see)")
    return row


def _grads(vlt5, tree_leaves, tree_map, params, mcfg, batch, proto, dtype,
           generator=None, remat=False, peak=None):
    """(loss, flat f32 gradient) of the training forward (deterministic
    without a ``generator``). With a ``peak`` dict, its "bytes" get the
    device memory peak of the forward and backward above their start
    (the gradients included, their flat copy not)."""
    if peak is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = vlt5.forward_train(live, mcfg, batch, proto, 0.5, 0.3,
                             generator=generator, dtype=dtype, remat=remat)
    leaves = tree_leaves(live)
    gs = torch.autograd.grad(out.loss, leaves, allow_unused=True)
    if peak is not None:
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated() - start
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).float()
                      .reshape(-1) for p, g in zip(leaves, gs)])
    return float(out.loss.detach()), flat


def strided_counts():
    """K1, K1′ and K2 launches on strided q/k/v (merged projections),
    counted by the wrappers beside their totals."""
    from vqacl_tpu_torch.ops import fused_attention as fa

    return tuple(w.strided_launches for w in (
        fa.fused_attention, fa.fused_attention_fwd_train,
        fa.fused_attention_bwd))


def drive_cl(trainer, label, counters=None, train=None):
    """Run ``trainer.train()`` (or ``train()``, a caller that runs it,
    such as a CLI's ``run``) as a user calls it, then read the
    trainer's own records: ``wall_s`` and ``task_wall_s`` (host clock),
    ``times_ms`` (each step and batch between CUDA events recorded around
    it without a sync; each save's host copy) and ``step_losses``. With
    ``counters`` (zero_counts, read_counts, encoder layers) the kernel
    counts are read around the run and checked against its steps and
    batches: K1′ and K2 once per encoder layer in every train, replay and
    importance step, K1 once per layer in every predict and DER capture
    batch, each above zero; with ``merged_qkv`` (the trainer resolves
    "auto" to it) every one of them on strided q/k/v. Checks finite
    losses and a finite result matrix → record."""
    import numpy as np

    zero_counts, read_counts, num_layers = counters or (
        lambda: None, lambda: (0, 0, 0), 0)
    zero_counts()
    t0 = time.perf_counter()
    metrics = (train or trainer.train)()
    wall = time.perf_counter() - t0
    k1, k1p, k2 = read_counts()
    strided = list(strided_counts()) if counters else [0, 0, 0]
    merged = trainer.cfg.model.merged_qkv is True
    c, times = trainer.counts, trainer.times_ms
    losses = trainer.step_losses["train"] + trainer.step_losses["replay"]
    steps = c["train_steps"] + c["replay_steps"]
    want_k1p = num_layers * (steps + c["importance_batches"])
    want_k1 = num_layers * (c["predict_batches"] + c["capture_batches"])
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
    ms = lambda x: "-" if x is None else f"{x:.3f}"
    train_ms = times["train_steps"] + times["replay_steps"]
    clock = "between CUDA events, no sync per call" \
        if trainer.device.type == "cuda" else "on the host clock"
    w = trainer.wall_s
    matrix = trainer.result_matrix.matrix().tolist()
    rec = {"wall_s": wall, "task_wall_s": dict(trainer.task_wall_s),
           "counts": dict(c), "launches": [k1, k1p, k2],
           "strided_launches": strided, "merged_qkv": merged,
           "expected_launches": [want_k1, want_k1p, want_k1p],
           "train_step_ms_median": med(train_ms),
           "replay_step_ms_median": med(times["replay_steps"]),
           "predict_batch_ms_median": med(times["predict_batches"]),
           "steps_per_s": steps / max(w["train"], 1e-9),
           "wall_share": {k: w[k] / wall for k in
                          ("train", "predict", "loader", "checkpoint")},
           "checkpoint_s": w["checkpoint"],
           "checkpoint_save_ms": times["saves"],
           "importance_batch_ms": times["importance_batches"],
           "capture_batch_ms": times["capture_batches"],
           "checkpoint_write_s": trainer._ckpt_writer.write_s,
           "losses": losses, "result_matrix": matrix,
           "Avg_acc": metrics.get("Avg_acc",
                                  metrics.get("standard", {}).get("Avg_acc")),
           "metrics": metrics}
    log(f"{label}: wall {wall:.3f} s, per task "
        + ", ".join(f"{t} {s:.3f} s" for t, s in trainer.task_wall_s.items())
        + f"; {steps} train+replay steps ({c['train_steps']} + "
        f"{c['replay_steps']}), median {ms(rec['train_step_ms_median'])} ms "
        f"(replay steps alone {ms(rec['replay_step_ms_median'])} ms), "
        f"{rec['steps_per_s']:.3f} steps/s of train time; "
        f"{c['predict_batches']} predict batches, median "
        f"{ms(rec['predict_batch_ms_median'])} ms (steps and batches "
        f"{clock}); importance batches "
        f"{c['importance_batches']} ("
        f"{', '.join(f'{t:.3f}' for t in times['importance_batches']) or '-'}"
        f" ms), DER capture batches {c['capture_batches']} ("
        f"{', '.join(f'{t:.3f}' for t in times['capture_batches']) or '-'}"
        f" ms)")
    log(f"{label}: wall shares " + json.dumps(rec["wall_share"])
        + f"; checkpoint {w['checkpoint']:.3f} s (saves, each the host copy: "
        f"{', '.join(f'{t:.3f}' for t in times['saves'])} ms; the rest the "
        f"final drain), background writes {rec['checkpoint_write_s']:.3f} s; "
        f"launches K1={k1} "
        f"K1'={k1p} K2={k2} (expected {want_k1}/{want_k1p}/{want_k1p}), "
        f"merged_qkv={merged}: strided {strided[0]}/{strided[1]}/"
        f"{strided[2]}")
    log(f"{label}: result matrix {matrix} Avg_acc {rec['Avg_acc']}")
    if counters and ((k1, k1p, k2) != (want_k1, want_k1p, want_k1p)
                     or min(k1, k1p, k2) <= 0):
        fail(f"{label}: launches K1/K1'/K2 {k1}/{k1p}/{k2}, expected "
             f"{want_k1}/{want_k1p}/{want_k1p}, each above zero")
    if counters and merged and strided != [k1, k1p, k2]:
        fail(f"{label}: merged_qkv, but strided launches {strided} of "
             f"{[k1, k1p, k2]}")
    if not losses or not all(np.isfinite(losses)):
        fail(f"{label}: a loss is not finite: {losses}")
    if not np.isfinite(np.asarray(matrix)).all() \
            or not np.isfinite(rec["Avg_acc"]):
        fail(f"{label}: the result matrix is not finite: {matrix}")
    return rec


def _tokens_ok(tok, m, rows):
    """int32 tokens [rows, T] inside the vocabulary, pad after each EOS."""
    import numpy as np

    if tok.shape != (rows, m.gen_max_length - 1) or tok.dtype != np.int32 \
            or tok.min() < 0 or tok.max() >= m.vocab_size:
        return False
    for row in tok:
        hit = np.flatnonzero(row == m.eos_token_id)
        if hit.size and (row[hit[0] + 1:] != m.pad_token_id).any():
            return False
    return True


def _events_ms(fn, n):
    """``fn()`` n times between CUDA events, one sync at the end →
    (last output, [ms])."""
    spans = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in spans]


def _launches_per_step(fn, marker):
    """Device kernels (and copies) of one ``fn()`` under torch.profiler,
    and how often the CPU op ``marker`` ran (once per decode step). A
    PyTorch built without CUDA traces the host only."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.backends.cuda.is_built():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    steps = launches = 0
    for avg in prof.key_averages():
        if avg.key == marker:
            steps += avg.count
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            launches += avg.count
    return launches, steps


def serving_extras(params, proto, counters, greedy_step_ms, tok):
    """Phase 8 (see the module's docstring) on the random-init t5-base
    ``params`` and prototype banks ``proto`` of phase 3. ``counters``:
    (zero_counts, read_counts). → (summary dict, K1/K1′/K2 launches of
    the phase's main-path runs)."""
    import numpy as np
    import urllib.request

    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.cli.serve_http import (make_http_server,
                                                serve_forever_in_thread)
    from vqacl_tpu_torch.data import device_cache as DC
    from vqacl_tpu_torch.data.collate import collate
    from vqacl_tpu_torch.data.features import MemoryFeatureStore
    from vqacl_tpu_torch.data.packed_cache import (PackedFeatureStore,
                                                   write_pack)
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.models.generate import beam_search, greedy_decode
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
    from vqacl_tpu_torch.train.optim import make_transform
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_eval_step, make_train_step
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    zero_counts, read_counts = counters
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = Config()
    m = cfg.model
    L = m.num_layers
    out = {}
    k_total = [0, 0, 0]

    def counted(fn):
        """``fn()`` with the kernel counts read around it, added to the
        phase's totals → (output, (K1, K1′, K2))."""
        torch.cuda.synchronize()
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        k = read_counts()
        for i in range(3):
            k_total[i] += k[i]
        return res, k

    # ---- 8a. beam search -------------------------------------------------
    cast = vlt5.cast_params_for_inference(params, bf16)
    pool = SyntheticVQA(EVAL_BATCH, seed=0)
    batch = collate(pool.examples, with_targets=False)["tensors"]
    greedy = make_eval_step(cfg, dtype=bf16, device="cuda")
    beam = make_eval_step(cfg, dtype=bf16, device="cuda", num_beams=BEAM)
    beam(cast, proto, batch)                     # warm-up
    greedy(cast, proto, batch)
    (tok_b, beam_ms), k = counted(
        lambda: _events_ms(lambda: beam(cast, proto, batch), BEAM_STEPS))
    _, greedy_ms = _events_ms(lambda: greedy(cast, proto, batch), BEAM_STEPS)
    # the host's state after phases 1-7: objects the collector tracks and
    # threads alive, and greedy again with every such object frozen
    n_objects, n_threads = len(gc.get_objects()), threading.active_count()
    gc.collect()
    gc.freeze()
    _, frozen_ms = _events_ms(lambda: greedy(cast, proto, batch), BEAM_STEPS)
    gc.unfreeze()
    tok_b = tok_b.cpu().numpy()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    log(f"beam: bs {EVAL_BATCH} x {BEAM} beams bf16 eval_step_ms="
        f"{med(beam_ms):.3f} (all {', '.join(f'{t:.3f}' for t in beam_ms)}; "
        f"CUDA events) vs greedy {med(greedy_ms):.3f} (all "
        f"{', '.join(f'{t:.3f}' for t in greedy_ms)}; phase 3, host clock: "
        f"{greedy_step_ms:.3f}); launches over {BEAM_STEPS} steps: "
        f"K1={k[0]} K1'={k[1]} K2={k[2]}")
    log(f"host state: {n_objects} objects tracked by gc, {n_threads} threads "
        f"alive; greedy with them frozen {med(frozen_ms):.3f} ms (all "
        f"{', '.join(f'{t:.3f}' for t in frozen_ms)})")
    if k != (L * BEAM_STEPS, 0, 0):
        fail(f"beam eval steps launched K1/K1'/K2 {k}, expected "
             f"{L * BEAM_STEPS}/0/0")
    if not _tokens_ok(tok_b, m, EVAL_BATCH):
        fail(f"beam tokens {tok_b.dtype} {tok_b.shape} out of range or not "
             f"pad after EOS")

    dev_batch = {k_: torch.from_numpy(batch[k_]).cuda()
                 for k_ in ("input_ids", "vis_feats", "boxes")}
    with torch.inference_mode():
        hidden, mask = vlt5.encode(cast, m, **dev_batch, dtype=bf16)
        hidden, mask, _, _ = vlt5.augment(m, hidden, mask, proto)
        lb, beam_steps = _launches_per_step(
            lambda: beam_search(cast, m, hidden, mask, num_beams=BEAM,
                                dtype=bf16), "aten::log_softmax")
        lg, greedy_steps = _launches_per_step(
            lambda: greedy_decode(cast, m, hidden, mask, dtype=bf16),
            "aten::argmax")
    per_beam = lb / max(beam_steps, 1)
    per_greedy = lg / max(greedy_steps, 1)
    log(f"beam: {lb} device launches over {beam_steps} decode steps "
        f"({per_beam:.1f} per step, set-up included); greedy {lg} over "
        f"{greedy_steps} ({per_greedy:.1f} per step) (torch.profiler)")

    # each row's beam sum log-prob (length penalty 0) >= greedy's, in f32
    with torch.inference_mode():
        hidden, mask = vlt5.encode(params, m, **dev_batch, dtype=f32)
        hidden, mask, _, _ = vlt5.augment(m, hidden, mask, proto)
        g_tok = greedy_decode(params, m, hidden, mask, dtype=f32,
                              early_stop=False)
        b_tok = beam_search(params, m, hidden, mask, num_beams=BEAM,
                            length_penalty=0.0, dtype=f32)

        def seq_logp(tokens):
            logits = vlt5.decode_train(params, m, hidden, mask, tokens,
                                       dtype=f32)
            lp = torch.log_softmax(logits, -1).gather(
                -1, tokens.long()[..., None])[..., 0]
            eos = (tokens == m.eos_token_id).int()
            # positions up to and including the first EOS
            upto = (torch.cumsum(eos, 1) - eos) == 0
            return (lp * upto).sum(1)

        gap = (seq_logp(b_tok) - seq_logp(g_tok)).cpu().numpy()
    log(f"beam vs greedy (f32, length penalty 0): min(beam - greedy sum "
        f"log-prob) {gap.min():.4e} (tol -{BEAM_LOGP_TOL:g}), rows beam "
        f"higher {int((gap > BEAM_LOGP_TOL).sum())}/{EVAL_BATCH}, rows "
        f"equal {int((b_tok == g_tok).all(1).sum())}")
    if not gap.min() >= -BEAM_LOGP_TOL:
        fail("a beam hypothesis scores below greedy's")
    out["beam"] = {"eval_step_ms": beam_ms, "greedy_eval_step_ms": greedy_ms,
                   "greedy_gc_frozen_ms": frozen_ms,
                   "gc_objects": n_objects, "threads": n_threads,
                   "launches_per_decode_step": per_beam,
                   "greedy_launches_per_decode_step": per_greedy,
                   "decode_steps": [beam_steps, greedy_steps],
                   "min_logp_gap": float(gap.min())}

    # a tiny f32 config: card tokens == the CPU plain path's
    tiny = Config()
    tiny.model = tiny_model_config(vocab_size=32200)
    tm = tiny.model
    tp_cpu = vlt5.init_vlt5_params(3, tm, device="cpu")
    tp_cpu["shared"][tm.pad_token_id] = 0.0
    tproto = ProtoState.create(tm.n_ques_types, tm.n_categories, tm.d_model,
                               device="cpu")
    tb = collate(SyntheticVQA(8, seed=2, feat_dim=tm.feat_dim,
                              n_boxes=tm.n_boxes,
                              text_len=tm.max_text_length).examples,
                 max_text_length=tm.max_text_length, n_boxes=tm.n_boxes,
                 feat_dim=tm.feat_dim, with_targets=False)["tensors"]
    tp_gpu, tproto_gpu = to_device(tp_cpu, "cuda"), tproto.to("cuda")
    same = {}
    for kw in ({"num_beams": 3}, {"num_beams": 5},
               {"num_beams": 3, "max_length": 5}, {"max_length": 4}):
        a = make_eval_step(tiny, dtype=f32, device="cpu", **kw)(
            tp_cpu, tproto, tb).numpy()
        b = make_eval_step(tiny, dtype=f32, device="cuda", **kw)(
            tp_gpu, tproto_gpu, tb).cpu().numpy()
        same[json.dumps(kw)] = bool((a == b).all())
    with torch.inference_mode():
        enc = {}
        for dev, p_, pr in (("cpu", tp_cpu, tproto),
                            ("cuda", tp_gpu, tproto_gpu)):
            h, mk = vlt5.encode(p_, tm, **{k_: torch.from_numpy(tb[k_]).to(dev)
                                           for k_ in ("input_ids", "vis_feats",
                                                      "boxes")}, dtype=f32)
            h, mk, _, _ = vlt5.augment(tm, h, mk, pr)
            enc[dev] = greedy_decode(p_, tm, h, mk, max_length=5, dtype=f32,
                                     early_stop=False).cpu().numpy()
    same['{"early_stop": false, "max_length": 5}'] = bool(
        (enc["cpu"] == enc["cuda"]).all())
    log(f"beam/greedy options, tiny f32 card == CPU: {json.dumps(same)}")
    if not all(same.values()):
        fail("tiny f32 decoding options differ between the card and the CPU")
    out["tiny_card_equals_cpu"] = same
    del hidden, mask, g_tok, b_tok
    torch.cuda.empty_cache()

    # ---- 8b. the device feature cache ------------------------------------
    N = CACHE_IMAGES
    g = torch.Generator(device="cuda").manual_seed(8)
    feats_dev = torch.randn((N, m.n_boxes, m.feat_dim), generator=g,
                            device="cuda")
    boxes_dev = torch.rand((N, m.n_boxes, 4), generator=g, device="cuda")
    host_f, host_b = feats_dev.cpu().numpy(), boxes_dev.cpu().numpy()
    ids = [f"img{i}" for i in range(N)]
    store = MemoryFeatureStore({img: (host_f[i], host_b[i])
                                for i, img in enumerate(ids)})
    caches = {}
    for name in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        caches[name] = DC.DeviceFeatureCache.from_store(
            store, ids, device="cuda", feat_dtype=DC.DTYPES[name])
        torch.cuda.synchronize()
        log(f"device cache {name}: {N} images x {m.n_boxes} x {m.feat_dim}, "
            f"{caches[name][0].nbytes / 1e6:.1f} MB on the card, built in "
            f"{time.perf_counter() - t0:.3f} s")
    cache, slot_of = caches["bfloat16"]
    cache8 = caches["int8"][0]
    bits_equal = torch.equal(cache.feats.view(torch.int16),
                             feats_dev.to(bf16).view(torch.int16)) \
        and torch.equal(cache.boxes, boxes_dev)
    probe = np.asarray([5, -1, N - 1, N, 0, 10 * N], np.int32)
    zeros_ok = True
    for c in (cache, cache8):
        f_, b_ = c.lookup(probe)
        zeros_ok &= not (f_[[1, 3, 5]].any() or b_[[1, 3, 5]].any())
        zeros_ok &= torch.equal(b_[[0, 2, 4]], boxes_dev[[5, N - 1, 0]])
    f_, _ = cache.lookup(probe)
    bits_equal &= torch.equal(f_[[0, 2, 4]],
                              feats_dev[[5, N - 1, 0]].to(bf16).float())
    worst, int8_ok = 0.0, True
    for s0 in range(0, N, 512):
        sc = cache8.scales[s0:s0 + 512, :, None]
        err = (cache8.feats[s0:s0 + 512].float() * sc
               - feats_dev[s0:s0 + 512]).abs()
        worst = max(worst, float((err / sc).max()))
        int8_ok &= bool((err <= sc * (0.5 + INT8_SLACK)).all())
    log(f"device cache: bf16 table == features rounded to bf16, bit for bit: "
        f"{bits_equal}; int8 max |error| / row scale {worst:.6f} (bound "
        f"{0.5 + INT8_SLACK:g}); slot -1 and out of range give zeros: "
        f"{zeros_ok}")
    if not (bits_equal and int8_ok and zeros_ok):
        fail("the device cache's tables or lookups are wrong")
    del cache8, caches
    torch.cuda.empty_cache()

    # the cached bf16 eval step == the host path on the same items
    slots = (np.arange(EVAL_BATCH) * (N // EVAL_BATCH) + 7).astype(np.int32)
    host_eval = {"input_ids": batch["input_ids"], "vis_feats": host_f[slots],
                 "boxes": host_b[slots]}
    slot_eval = {"input_ids": batch["input_ids"], "slots": slots}
    cached_ev = DC.make_cached_eval_step(cfg, cache, dtype=bf16,
                                         device="cuda")
    tok_c, kc = counted(lambda: cached_ev(cast, proto, slot_eval))
    tok_h = greedy(cast, proto, host_eval)
    eval_equal = torch.equal(tok_c, tok_h)

    # the cached train step == the host path's, from one state
    tcfg = Config()
    tcfg.model.dropout_rate = 0.0
    tx = make_transform(tcfg.train)
    tbatch = next(SyntheticVQA(TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    tslots = np.random.default_rng(3).choice(N, TRAIN_BATCH,
                                             replace=False).astype(np.int32)
    host_train = dict(tbatch, vis_feats=host_f[tslots], boxes=host_b[tslots])
    slot_train = {k_: v for k_, v in tbatch.items()
                  if k_ not in ("vis_feats", "boxes")}
    slot_train["slots"] = tslots
    proto0 = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                               device="cuda")
    cstep = DC.make_cached_train_step(tcfg, cache, dtype=bf16, device="cuda")
    hstep = make_train_step(tcfg, dtype=bf16, device="cuda")
    (_, mc), kt = counted(lambda: cstep(
        TrainState.create(params, tx, proto0, seed=1), slot_train))
    _, mh = hstep(TrainState.create(params, tx, proto0, seed=1), host_train)
    loss_c, loss_h = float(mc["loss"]), float(mh["loss"])
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    nbytes = lambda b: sum(np.asarray(v).nbytes for v in b.values())
    train_keys = ("input_ids", "target_ids", "scores", "ques_labels",
                  "cate_labels")
    h2d = {"eval_host": nbytes(host_eval), "eval_cached": nbytes(slot_eval),
           "train_host": nbytes({k_: host_train[k_] for k_ in
                                 train_keys + ("vis_feats", "boxes")}),
           "train_cached": nbytes({k_: slot_train[k_] for k_ in
                                   train_keys + ("slots",)})}
    log(f"device cache: cached bf16 eval tokens == host path: {eval_equal} "
        f"(K1={kc[0]}); cached train step loss {loss_c!r} vs host {loss_h!r}, "
        f"rel {loss_rel:.3e} (tol {CACHED_LOSS_RTOL:g}; K1'={kt[1]} "
        f"K2={kt[2]}); host->device bytes per batch: eval {h2d['eval_host']} "
        f"-> {h2d['eval_cached']}, train {h2d['train_host']} -> "
        f"{h2d['train_cached']}")
    if not eval_equal or kc != (L, 0, 0):
        fail("the cached eval step differs from the host path")
    if not loss_rel <= CACHED_LOSS_RTOL or kt != (0, L, L) \
            or not np.isfinite(loss_c):
        fail("the cached train step differs from the host path")
    out["cache"] = {"eval_tokens_equal": eval_equal, "train_loss_rel":
                    loss_rel, "int8_worst_err_over_scale": worst,
                    "h2d_bytes": h2d, "table_bytes": cache.nbytes}
    del mc, mh
    torch.cuda.empty_cache()

    # ---- 8c. the CL loop with the device cache ---------------------------
    n_tr, n_va, n_te = CL_ITEMS
    ccfg = Config()
    ccfg.train.batch_size = TRAIN_BATCH
    ccfg.train.valid_batch_size = EVAL_BATCH
    ccfg.train.epochs = 1
    ccfg.train.memory = True
    ccfg.train.m_size = CL_M_SIZE
    cm = ccfg.model
    er = {}
    # the cached run, then the host path's beside it in the same phase
    for name, cached in (("cl_er_cached", True), ("cl_er_host", False)):
        ccfg.data.device_cache = cached
        cdata = SyntheticDataModule(
            tok, tasks=CL_TASKS, n_train_per_task=n_tr, n_val_per_task=n_va,
            n_test_per_task=n_te, feat_dim=cm.feat_dim, n_boxes=cm.n_boxes,
            n_images=CL_IMAGES, seed=0)
        with tempfile.TemporaryDirectory() as outdir:
            ccfg.output = outdir
            t0 = time.time()
            trainer = VQACLTrainer(ccfg, cdata, tok, verbose=False,
                                   device="cuda", init_params=params,
                                   dtype=bf16)
            log(f"{name}: phase 7's ER run, data.device_cache={cached}"
                + (f" (bf16, {trainer._cache.n} images, "
                   f"{trainer._cache.nbytes / 1e6:.1f} MB)" if cached else "")
                + f"; set-up {time.time() - t0:.1f} s")
            er[name] = drive_cl(trainer, name,
                                (zero_counts, read_counts, cm.num_layers))
        for i in range(3):
            k_total[i] += er[name]["launches"][i]
        out[name] = {k_: v for k_, v in er[name].items() if k_ != "metrics"}
        del trainer
        torch.cuda.empty_cache()
    lc, lh = er["cl_er_cached"]["losses"], er["cl_er_host"]["losses"]
    er_rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
    er_same = er["cl_er_cached"]["result_matrix"] == \
        er["cl_er_host"]["result_matrix"]
    log(f"cl_er cached vs host: {len(lc)} / {len(lh)} steps, first loss rel "
        f"{er_rel[0]:.3e} (tol {CACHED_LOSS_RTOL:g}), max rel over the run "
        f"{max(er_rel):.3e}; result matrices equal {er_same}; wall "
        f"{er['cl_er_cached']['wall_s']:.3f} vs "
        f"{er['cl_er_host']['wall_s']:.3f} s; median step "
        f"{er['cl_er_cached']['train_step_ms_median']:.3f} vs "
        f"{er['cl_er_host']['train_step_ms_median']:.3f} ms")
    if len(lc) != len(lh) or not er_rel[0] <= CACHED_LOSS_RTOL:
        fail("the cached ER run's first step differs from the host path's")

    # a tiny f32 run with an int8 cache on the card == the same on the CPU
    tcl = Config()
    tcl.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0)
    tcl.train.lr = 1e-3
    tcl.train.batch_size = tcl.train.valid_batch_size = CL_TINY_BATCH
    tcl.train.epochs = 1
    tcl.train.m_size = 16
    tcl.data.device_cache = True
    tcl.data.device_cache_dtype = "int8"
    tinit = vlt5.init_vlt5_params(4, tcl.model, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        tdata = SyntheticDataModule(
            tok, tasks=CL_TASKS, n_train_per_task=CL_TINY[0],
            n_val_per_task=CL_TINY[1], n_test_per_task=CL_TINY[2],
            feat_dim=tcl.model.feat_dim, n_boxes=tcl.model.n_boxes,
            answer_vocab=4, seed=0)
        with tempfile.TemporaryDirectory() as outdir:
            tcl.output = outdir
            trainer = VQACLTrainer(tcl, tdata, tok, verbose=False, device=dev,
                                   init_params=tinit, dtype=f32)
            answers = []

            def predict(loader, predict=trainer.predict):
                answers.append(predict(loader))
                return answers[-1]

            trainer.predict = predict
            r = drive_cl(trainer, f"cl_tiny_int8_cache_{dev}",
                         (zero_counts, read_counts, tcl.model.num_layers)
                         if dev == "cuda" else None)
            r["answers"] = answers
            runs[dev] = r
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                        cpu_run["losses"]))
    same = {k_: card_run[k_] == cpu_run[k_]
            for k_ in ("result_matrix", "answers")}
    log(f"cl tiny f32 int8 cache, card vs CPU: {len(card_run['losses'])} / "
        f"{len(cpu_run['losses'])} steps, loss max rel err {tiny_err:.3e} "
        f"(tol {CL_LOSS_RTOL:g}); equal: {json.dumps(same)}")
    if len(card_run["losses"]) != len(cpu_run["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same.values()):
        fail("the tiny f32 int8-cache CL run on the card differs from the CPU")
    for i in range(3):
        k_total[i] += card_run["launches"][i]
    out["cl_tiny_int8_cache"] = {"loss_rel_err": tiny_err, "equal": same,
                                 "launches": card_run["launches"]}

    # ---- 8d. the HTTP front end ------------------------------------------
    pred = VQAPredictor(cfg, params, proto, tok, None, batch_size=16,
                        num_beams=BEAM, dtype=bf16, device="cuda",
                        device_cache=cache, slot_of=slot_of)
    n_req = HTTP_CLIENTS * HTTP_PER_CLIENT
    qs = [f"what is in image {i}?" for i in range(n_req + 8)]
    imgs = [ids[(37 * i) % N] for i in range(n_req + 8)]
    want = pred.answer(qs, imgs)
    answers, errors = [None] * (n_req + 8), []

    def post(base, payload):
        req = urllib.request.Request(
            base + "/v1/vqa", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.load(r)

    def get(base, path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read().decode()

    with VQAServer(pred, max_wait_ms=5.0) as srv:
        httpd = make_http_server(srv, host="127.0.0.1", port=0)
        thread = serve_forever_in_thread(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            post(base, {"question": "warm up?", "img_id": ids[0]})
            warm = srv.stats()
            start = threading.Barrier(HTTP_CLIENTS)

            def client(c):
                start.wait()
                for r in range(HTTP_PER_CLIENT):
                    i = c * HTTP_PER_CLIENT + r
                    try:
                        answers[i] = post(base, {"question": qs[i],
                                                 "img_id": imgs[i]})["answer"]
                    except Exception as e:   # recorded, fails the run
                        errors.append(repr(e))

            def drive():
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(HTTP_CLIENTS)]
                for t in threads:
                    t.start()
                answers[n_req:] = post(base, {"items": [
                    {"question": q, "img_id": i}
                    for q, i in zip(qs[n_req:], imgs[n_req:])]})["answers"]
                for t in threads:
                    t.join(timeout=600)
                return any(t.is_alive() for t in threads)

            t0 = time.perf_counter()
            stuck, kh = counted(drive)
            wall = time.perf_counter() - t0
            health = json.loads(get(base, "/healthz"))
            st = json.loads(get(base, "/stats"))
            metrics = get(base, "/metrics")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
    batches = st["batches"] - warm["batches"]
    log(f"http: {n_req} POST /v1/vqa from {HTTP_CLIENTS} clients x "
        f"{HTTP_PER_CLIENT} + one of 8 items in {wall:.3f} s over {batches} "
        f"batches of <= 16 ({BEAM} beams, device cache); latency p50 "
        f"{st['latency_p50_ms']} ms p99 {st['latency_p99_ms']} ms; stats "
        f"{json.dumps(st)}; K1={kh[0]}; answers == predictor.answer: "
        f"{answers == want}")
    if stuck or errors or st["errors"] or health != {"ok": True}:
        fail(f"http serving errors: {errors[:3]} stats {st}")
    if answers != want:
        fail("answers over HTTP differ from predictor.answer")
    if kh != (L * batches, 0, 0):
        fail(f"http serving launched K1/K1'/K2 {kh} over {batches} batches")
    if f"vqa_requests {st['requests']}" not in metrics \
            or "# TYPE vqa_requests counter" not in metrics:
        fail(f"/metrics: {metrics[:300]}")
    out["http"] = {"stats": st, "wall_s": wall, "batches": batches}
    del pred
    torch.cuda.empty_cache()

    # ---- 8e. the packed feature store ------------------------------------
    pack_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(pack_dir, exist_ok=True)
    path = os.path.join(pack_dir, "phase8.vfpack")
    n = PACK_IMAGES
    t0 = time.perf_counter()
    # boxes are already in [0,1]: a 1 x 1 image keeps them as they are
    write_pack(path, ((ids[i], host_f[i], host_b[i], 1.0, 1.0)
                      for i in range(n)),
               n_boxes=m.n_boxes, feat_dim=m.feat_dim)
    write_s = time.perf_counter() - t0
    packed = PackedFeatureStore(path)
    try:
        pf, pb = packed.get_batch(ids[:n])
        pack_equal = bool(np.array_equal(pf, host_f[:n])
                          and np.array_equal(pb, host_b[:n]))
        qs_p = [f"what is in image {i}?" for i in range(32)]
        imgs_p = [ids[(5 * i) % n] for i in range(32)]
        by_pack = VQAPredictor(cfg, params, proto, tok, packed,
                               batch_size=16, dtype=bf16, device="cuda")
        by_mem = VQAPredictor(cfg, params, proto, tok, store, batch_size=16,
                              dtype=bf16, device="cuda")
        a_pack, kp = counted(lambda: by_pack.answer(qs_p, imgs_p))
        a_mem = by_mem.answer(qs_p, imgs_p)
    finally:
        packed.close()
        os.remove(path)
    log(f"pack: {n} images, {os.path.basename(path)} written in "
        f"{write_s:.3f} s; get_batch == source: {pack_equal}; predictor over "
        f"the pack answers as over the memory store: {a_pack == a_mem} "
        f"(K1={kp[0]})")
    if not pack_equal or a_pack != a_mem or kp != (L * 2, 0, 0):
        fail("the packed store differs from its source")
    out["pack"] = {"images": n, "write_s": write_s}
    log(f"phase 8 launches K1={k_total[0]} K1'={k_total[1]} K2={k_total[2]}")
    return out, k_total


def strided_inputs(B, Tq, Sk, H, dk, L, dt, layout, seed, causal=False,
                   fold_layers=12):
    """Phase 2's training inputs packed as the merged projections lay them
    out → (views (q, k, v), packed buffers, their dense copies, do, bias,
    mask). ``layout``: "self" (q|k|v in one [B,S,3W] buffer), "cross" (q
    dense, k|v in [B,Sk,2W]) or "folded" (q dense, k and v the slices of
    one layer in the middle of a [B,Sk,2·fold_layers·W] fold)."""
    W = H * dk
    q0, k0, v0, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, L or Sk, seed, causal=causal)
    if layout == "self":
        buf = torch.cat([q0, k0, v0], dim=-1)
        views, packed = (buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:]), \
            (buf, None)
    elif layout == "cross":
        kv = torch.cat([k0, v0], dim=-1)
        views, packed = (q0, kv[..., :W], kv[..., W:]), (q0, kv)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed + 2)
        fold = torch.randn(B, Sk, 2 * fold_layers * W, generator=g,
                           device="cuda").to(dt)
        o = 2 * (fold_layers // 2) * W
        fold[..., o:o + W] = k0
        fold[..., o + W:o + 2 * W] = v0
        views, packed = (q0, fold[..., o:o + W],
                         fold[..., o + W:o + 2 * W]), (q0, fold)
    return views, packed, (q0, k0, v0), do, bias, mask


def check_strided(fa, name, B, Tq, Sk, H, dk, L, dtype, rate, layout,
                  causal=False, timed=False):
    """K1 (at rate 0), K1′ and K2 on strided views of the merged
    projection layouts against the same kernels on dense copies, bit for
    bit (the stride changes addresses, not arithmetic); K2 also writing
    into one gradient buffer of the packed layout, bit-equal to the dense
    dq, dk, dv side by side; each strided call counted once in its
    wrapper's ``strided_launches`` and each dense call not at all. With
    ``timed``: strided and dense times (K1 at rate 0, else K1′ and K2) in
    the order dense, strided, strided, dense, beside the bound → row."""
    dt = getattr(torch, dtype)
    W = H * dk
    (q, k, v), packed, (qc, kc, vc), do, bias, mask = strided_inputs(
        B, Tq, Sk, H, dk, L, dt, layout, seed=B + Tq + Sk + 7,
        causal=causal)
    seed = torch.tensor([4242 + Tq], dtype=torch.int32, device="cuda")
    wrappers = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)
    counts = lambda: [w.strided_launches for w in wrappers]
    before = counts()
    eq = {}
    if rate == 0.0:
        eq["K1"] = torch.equal(fa.fused_attention(q, k, v, bias, mask, H),
                               fa.fused_attention(qc, kc, vc, bias, mask, H))
    o_s, p_s = fa.fused_attention_fwd_train(q, k, v, bias, mask, seed, H,
                                            rate)
    o_c, p_c = fa.fused_attention_fwd_train(qc, kc, vc, bias, mask, seed, H,
                                            rate)
    eq["K1'"] = torch.equal(o_s, o_c) and torch.equal(p_s, p_c)
    g_s = fa.fused_attention_bwd(q, k, v, p_s, seed, do, H, L, rate)
    g_c = fa.fused_attention_bwd(qc, kc, vc, p_c, seed, do, H, L, rate)
    eq["K2"] = all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(g_s, g_c))
    # K2 into the merged gradient buffer, as _FusedAttentionPacked runs it
    x, kv = packed
    dx = torch.full_like(x, float("nan"))
    dkv = None if kv is None else torch.full_like(kv, float("nan"))
    if layout == "self":
        out = (dx[..., :W], dx[..., W:2 * W], dx[..., 2 * W:])
        want = [(dx, torch.cat(g_c[:3], dim=-1))]
    else:
        o = 0 if layout == "cross" else (kv.shape[-1] // 2 // W // 2) * 2 * W
        out = (dx, dkv[..., o:o + W], dkv[..., o + W:o + 2 * W])
        want = [(dx, g_c[0]), (dkv[..., o:o + 2 * W],
                               torch.cat(g_c[1:3], dim=-1))]
    fa.fused_attention_bwd(q, k, v, p_s, seed, do, H, L, rate, out=out)
    torch.cuda.synchronize()
    eq["K2 merged buffer"] = all(torch.equal(a, b) for a, b in want)
    # K1 (rate 0), K1′, K2 and the merged-buffer K2: once each, strided
    launched = [a - b for a, b in zip(counts(), before)]
    want_counts = [int(rate == 0.0), 1, 2]
    log(f"strided_check {name}: layout={layout} row strides "
        f"{list(fa._qkv_strides(q, k, v))} B={B} Tq={Tq} Sk={Sk} H={H} "
        f"dk={dk} L={L} {dtype} rate={rate}; bit-equal to dense: "
        f"{json.dumps(eq)}; strided launches K1/K1'/K2 {launched} "
        f"(expected {want_counts})")
    if not all(eq.values()) or launched != want_counts:
        fail(f"{name}: a strided launch differs from the dense one")
    if not timed:
        return {}
    sets = [strided_inputs(B, Tq, Sk, H, dk, L, dt, layout, seed=500 + i,
                           causal=causal) for i in range(4)]
    ps = [fa.fused_attention_fwd_train(*s[2], s[4], s[5], seed, H, rate)[1]
          for s in sets]
    calls = {
        "K1": lambda qkv, s, p: fa.fused_attention(*qkv, s[4], s[5], H),
        "K1'": lambda qkv, s, p: fa.fused_attention_fwd_train(
            *qkv, s[4], s[5], seed, H, rate),
        "K2": lambda qkv, s, p: fa.fused_attention_bwd(*qkv, p, seed, s[3],
                                                       H, L, rate)}
    elem = q.element_size()
    p_bytes = B * H * Tq * Sk * 4
    io = (2 * B * Tq + 2 * B * Sk) * W * elem
    small = B * Sk * 4 + H * L * L * 4
    prod = 2 * B * H * Tq * Sk * dk
    peak = PEAK_FLOPS[dtype]
    bounds = {"K1": _bound(io + small, 2 * prod / peak),
              "K1'": _bound(io + p_bytes + small + 4, 2 * prod / peak),
              "K2": _bound(io + p_bytes + (B * Tq + 2 * B * Sk) * W * elem
                           + H * L * L * 4 + 4, 4 * prod / peak)}
    row = {}
    for kind in ("K1",) if rate == 0.0 else ("K1'", "K2"):
        fn = calls[kind]
        dense = [lambda s=s, p=p: fn(s[2], s, p) for s, p in zip(sets, ps)]
        strided = [lambda s=s, p=p: fn(s[0], s, p) for s, p in zip(sets, ps)]
        d1, s1, s2, d2 = (time_ms(dense), time_ms(strided),
                          time_ms(strided), time_ms(dense))
        b_ms, b_by = bounds[kind]
        row[kind] = {"strided_ms": (s1 + s2) / 2, "dense_ms": (d1 + d2) / 2,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"strided_time {name} {kind}: strided_ms={(s1 + s2) / 2:.5f} "
            f"dense_ms={(d1 + d2) / 2:.5f} (dense {d1:.5f}, strided "
            f"{s1:.5f}, {s2:.5f}, dense {d2:.5f}) bound_ms={b_ms:.5f} "
            f"({b_by})")
    return row


def check_stride_refused(fa):
    """A bf16 q/k/v view whose row stride is not a multiple of 8 elements
    (so its rows do not start on 16 bytes) is refused by K1's, K1′'s and
    K2's wrappers with ValueError before any launch."""
    B, S, H, dk = 4, 16, 4, 64
    W = H * dk
    buf = torch.zeros(B, S, 3 * W + BAD_STRIDE_PAD, dtype=torch.bfloat16,
                      device="cuda")
    q, k, v = buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:3 * W]
    mask = torch.ones(B, S, device="cuda")
    seed = torch.zeros((1,), dtype=torch.int32, device="cuda")
    p = torch.zeros(B, H * S, S, device="cuda")
    do = torch.zeros(B, S, W, dtype=torch.bfloat16, device="cuda")
    wrappers = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)
    before = [w.launches for w in wrappers]
    msgs = []
    for call in (lambda: fa.fused_attention(q, k, v, None, mask, H),
                 lambda: fa.fused_attention_fwd_train(q, k, v, None, mask,
                                                      seed, H, 0.0),
                 lambda: fa.fused_attention_bwd(q, k, v, p, seed, do, H, 0,
                                                0.0)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
            continue
        fail(f"a bf16 row stride of {3 * W + BAD_STRIDE_PAD} was not "
             f"refused")
    if [w.launches for w in wrappers] != before:
        fail("a refused strided call launched a kernel")
    log(f"strided_check refused_stride_{3 * W + BAD_STRIDE_PAD}: K1, K1' "
        f"and K2 raise ValueError before any launch ({msgs[0]})")


def _bart_inputs(c, B, seed):
    """(input_ids with ragged pad, attention mask, region feats, boxes,
    labels with -100 pad) on the card for a BART config namespace."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, c.vocab_size, (B, c.text_len), generator=g,
                        device="cuda")
    n = torch.randint(2, c.text_len + 1, (B,), generator=g, device="cuda")
    pos = torch.arange(c.text_len, device="cuda")[None]
    ids = torch.where(pos < n[:, None], ids, c.pad_token_id)
    feats = torch.randn(B, c.n_boxes, c.feat_dim, generator=g, device="cuda")
    x1y1 = 0.5 * torch.rand(B, c.n_boxes, 2, generator=g, device="cuda")
    boxes = torch.cat([x1y1, x1y1 + 0.4 * torch.rand(
        B, c.n_boxes, 2, generator=g, device="cuda")], dim=-1).clamp(0, 1)
    labels = torch.randint(3, c.vocab_size, (B, c.target_len), generator=g,
                           device="cuda")
    labels[:, c.target_len // 2:] = -100
    return ids, (ids != c.pad_token_id).float(), feats, boxes, labels


def model_extensions(params, proto, counters, tok, phase7_ckpt):
    """Phase 9 (see the module's docstring) on the random-init t5-base
    ``params`` and prototype banks ``proto`` of phase 3. ``counters``:
    (zero_counts, read_counts, read_strided); ``phase7_ckpt``: the ER
    run's last checkpoint. → (summary dict, K1/K1′/K2 launches of the
    phase's main-path runs)."""
    from types import SimpleNamespace

    import numpy as np

    from vqacl_tpu_torch.cli import export_pth
    from vqacl_tpu_torch.data.collate import collate
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.models import bart, hf_import, vlt5
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.train import checkpoint as ckpt
    from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves,
                                             tree_map, tree_unflatten)
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_eval_step, make_train_step
    from vqacl_tpu_torch.utils.config import (Config, resolve_merged_qkv,
                                              tiny_model_config)

    zero_counts, read_counts, read_strided = counters
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    k_total = [0, 0, 0]

    def counted(fn):
        """``fn()`` with the kernel counts read around it, added to the
        phase's totals → (output, (K1, K1′, K2), strided (K1, K1′, K2))."""
        torch.cuda.synchronize()
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        k, ks = read_counts(), read_strided()
        for i in range(3):
            k_total[i] += k[i]
        return res, k, ks

    def config(merged, folded=False, fused_decoder=False, model=None):
        c = Config()
        if model is not None:
            c.model = model
        c.model.merged_qkv = merged
        c.model.folded_cross_kv = folded
        c.model.fused_decoder = fused_decoder
        return c

    base = Config().model
    H, dk, S, T = base.num_heads, base.d_kv, base.encoder_len, \
        base.target_max_length
    Lt = base.max_text_length
    n_dec = base.num_decoder_layers

    # ---- 9a. K1, K1′ and K2 on strided views ----------------------------
    strided_rows = {}
    for rate in (0.0, DROPOUT):
        timed = rate == DROPOUT
        strided_rows[f"train_{rate}"] = check_strided(
            fa, "train_shape", TRAIN_BATCH, S, S, H, dk, Lt, "bfloat16", rate,
            "self", timed=timed)
        strided_rows[f"decoder_self_{rate}"] = check_strided(
            fa, "decoder_self", TRAIN_BATCH, T, T, H, dk, T, "bfloat16", rate,
            "self", causal=True, timed=timed)
        strided_rows[f"decoder_cross_{rate}"] = check_strided(
            fa, "decoder_cross", TRAIN_BATCH, T, S + 2, H, dk, 0, "bfloat16",
            rate, "cross", timed=timed)
        check_strided(fa, "decoder_cross_folded", TRAIN_BATCH, T, S + 2, H,
                      dk, 0, "bfloat16", rate, "folded")
        check_strided(fa, "odd_width_f32", 3, 13, 13, 4, 8, 5, "float32",
                      rate, "self")
        check_strided(fa, "rect_f32", 8, 10, 58, H, dk, 0, "float32", rate,
                      "cross")
    strided_rows["eval_timed"] = check_strided(
        fa, "eval_shape", EVAL_BATCH, S, S, H, dk, Lt, "bfloat16", 0.0,
        "self", timed=True)
    for kind, shape in (("decoder_self_eval", (T, T, T, "self", True)),
                        ("decoder_cross_eval", (T, S + 2, 0, "cross",
                                                False))):
        Tq, Sk, L_, layout, causal = shape
        strided_rows[kind] = check_strided(
            fa, kind, TRAIN_BATCH, Tq, Sk, H, dk, L_, "bfloat16", 0.0,
            layout, causal=causal, timed=True)
    check_stride_refused(fa)
    out["strided"] = {k: v for k, v in strided_rows.items() if v}

    # ---- 9b. merged and folded train steps at t5-base --------------------
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    gb = {k: torch.from_numpy(v).cuda() for k, v in tbatch.items()}
    sep_cfg, mer_cfg = config(False), config(True)
    fd_sep, fd_mer = config(False, fused_decoder=True), \
        config(True, folded=True, fused_decoder=True)
    tx = make_transform(sep_cfg.train)
    proto0 = ProtoState.create(base.n_ques_types, base.n_categories,
                               base.d_model, device="cuda")
    train = {}
    for label, c_sep, c_mer, per_step in (
            ("encoder", sep_cfg, mer_cfg, base.num_layers),
            ("fused_decoder", fd_sep, fd_mer, base.num_layers + 2 * n_dec)):
        steps = {"separate": make_train_step(c_sep, dtype=bf16,
                                             device="cuda"),
                 "merged": make_train_step(c_mer, dtype=bf16, device="cuda")}
        states = {n: TrainState.create(params, tx, proto0, seed=0,
                                       warmup_iters=1.0, t_total=1000.0)
                  for n in steps}
        ms = {n: [] for n in steps}
        losses = {n: [] for n in steps}
        merged_counts = []
        for r in range(MERGED_ROUNDS + 1):       # round 0 warms up
            for n in ("separate", "merged", "merged", "separate"):
                t0 = time.perf_counter()
                (states[n], met), k, ks = counted(
                    lambda n=n: steps[n](states[n], tbatch))
                if r:
                    ms[n].append((time.perf_counter() - t0) * 1e3)
                losses[n].append(float(met["loss"]))
                if n == "merged":
                    merged_counts.append((k, ks))
        want = ((0, per_step, per_step), (0, per_step, per_step))
        med = lambda xs: sorted(xs)[len(xs) // 2]
        rec = {"train_step_ms": {n: med(v) for n, v in ms.items()},
               "train_step_ms_all": ms, "losses": losses,
               "launches_per_merged_step": merged_counts[-1]}
        log(f"merged_qkv {label}: bs {TRAIN_BATCH} bf16 dropout "
            f"{base.dropout_rate} train_step_ms separate "
            f"{rec['train_step_ms']['separate']:.3f} merged "
            f"{rec['train_step_ms']['merged']:.3f} (in turns: separate "
            f"{', '.join(f'{t:.3f}' for t in ms['separate'])}; merged "
            f"{', '.join(f'{t:.3f}' for t in ms['merged'])}); launches per "
            f"merged step K1/K1'/K2 {list(merged_counts[-1][0])}, strided "
            f"{list(merged_counts[-1][1])} (expected {list(want[1])}); "
            f"losses separate {', '.join(f'{x:.4f}' for x in losses['separate'])}"
            f"; merged {', '.join(f'{x:.4f}' for x in losses['merged'])}")
        if any(tuple(map(tuple, c)) != want for c in merged_counts):
            fail(f"merged_qkv {label}: launches per step {merged_counts}, "
                 f"expected {want}")
        if not all(np.isfinite(v).all() for v in losses.values()) \
                or not np.mean(losses["merged"][-3:]) < np.mean(
                    losses["merged"][:3]):
            fail(f"merged_qkv {label}: losses not finite or not falling: "
                 f"{losses}")
        # at dropout 0: the merged path against the separate one
        lu, gu = _grads(vlt5, tree_leaves, tree_map, params, c_sep.model, gb,
                        proto0, bf16)
        lm, gm = _grads(vlt5, tree_leaves, tree_map, params, c_mer.model, gb,
                        proto0, bf16)
        rec["loss_rel"] = abs(lm - lu) / abs(lu)
        rec["grad_rel"] = float((gm - gu).norm() / gu.norm())
        tol = GRAD_REL_TOL["bfloat16"]
        log(f"merged_qkv {label} vs separate at dropout 0, bf16 bs "
            f"{TRAIN_BATCH}: loss {lm:.6f} vs {lu:.6f} (rel "
            f"{rec['loss_rel']:.3e}), |g_merged - g_separate| / "
            f"|g_separate| = {rec['grad_rel']:.3e} (tol {tol:g})")
        if not (rec["loss_rel"] <= tol and rec["grad_rel"] <= tol):
            fail(f"merged_qkv {label}: loss or gradients off the separate "
                 f"path's")
        del gu, gm, states
        train[label] = rec
    out["train"] = train
    torch.cuda.empty_cache()

    # greedy and beam tokens: merged and folded cross-K/V precompute vs
    # separate, bf16 at the eval batch
    cast = vlt5.cast_params_for_inference(params, bf16)
    ebatch = collate(SyntheticVQA(EVAL_BATCH, seed=0).examples,
                     with_targets=False)["tensors"]
    decode = {}
    for beams in (1, BEAM):
        toks = {}
        for n, c in (("separate", config(False)), ("merged", config(True)),
                     ("folded", config(True, folded=True))):
            step = make_eval_step(c, dtype=bf16, device="cuda",
                                  num_beams=beams)
            tk, k, ks = counted(lambda: step(cast, proto, ebatch))
            toks[n] = tk.cpu().numpy()
            if k != (base.num_layers, 0, 0) or ks != (
                    base.num_layers if c.model.merged_qkv else 0, 0, 0):
                fail(f"decode {n}: launches {k}, strided {ks}")
        eq = {n: bool((toks[n] == toks["separate"]).all())
              for n in ("merged", "folded")}
        decode["greedy" if beams == 1 else f"beam{beams}"] = eq
        log(f"decode {'greedy' if beams == 1 else f'beam {beams}'} bs "
            f"{EVAL_BATCH} bf16: tokens equal to the separate path's: "
            f"{json.dumps(eq)}; rows equal merged "
            f"{float((toks['merged'] == toks['separate']).all(1).mean()):.3f}"
            f", folded "
            f"{float((toks['folded'] == toks['separate']).all(1).mean()):.3f}")
        if not all(eq.values()):
            fail("merged or folded decode tokens differ from the separate "
                 "path's")
    out["decode_tokens_equal"] = decode

    # tiny f32: merged + folded card == CPU (three train steps, tokens)
    tiny = {}
    for fused_decoder in (False, True):
        small = config(True, folded=True, fused_decoder=fused_decoder,
                       model=tiny_model_config(vocab_size=32200,
                                               dropout_rate=0.0))
        small.train.lr = 1e-3
        sm = small.model
        sp = vlt5.init_vlt5_params(5, sm, device="cpu")
        spro = ProtoState.create(sm.n_ques_types, sm.n_categories,
                                 sm.d_model, device="cpu")
        sb = [b["tensors"] for b in SyntheticVQA(
            24, seed=6, feat_dim=sm.feat_dim, n_boxes=sm.n_boxes,
            text_len=sm.max_text_length, vocab_size=sm.vocab_size,
            answer_vocab=8).batches(8, seed=1)]
        stx = make_transform(small.train)
        runs = {}
        for dev in ("cuda", "cpu"):
            st = TrainState.create(to_device(sp, dev), stx, spro.to(dev),
                                   seed=0, warmup_iters=1.0, t_total=40.0)
            step = make_train_step(small, dtype=f32, device=dev)
            ls = []
            for b in sb:
                st, met = step(st, b)
                ls.append(float(met["loss"]))
            ev = {nb: make_eval_step(small, dtype=f32, device=dev,
                                     num_beams=nb)(
                st.params, st.proto, sb[0]).cpu().numpy()
                for nb in (1, 3)}
            runs[dev] = (ls, tree_leaves(st.params), ev)
        (lg, pg, eg), (lc, pc, ec) = runs["cuda"], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        param_err = max(float((a.cpu() - b).abs().max())
                        for a, b in zip(pg, pc))
        same = all((eg[nb] == ec[nb]).all() for nb in eg)
        tiny[f"fused_decoder={fused_decoder}"] = {
            "loss_rel_err": loss_err, "param_err": param_err,
            "tokens_equal": bool(same)}
        log(f"small f32 merged+folded (fused_decoder={fused_decoder}): 3 "
            f"steps card vs CPU: loss rel err {loss_err:.3e} (tol 1e-5), "
            f"param max abs err {param_err:.3e} (tol {SMALL_PARAM_TOL:g}); "
            f"greedy and beam-3 tokens equal {same}")
        if not (loss_err <= 1e-5 and param_err <= SMALL_PARAM_TOL and same):
            fail("merged+folded f32 on the card differs from the CPU")
    out["tiny_merged_folded"] = tiny

    # ---- 9c. the classifier head ----------------------------------------
    ccfg = Config()
    resolve_merged_qkv(ccfg.model)
    cm = ccfg.model
    head = vlt5.init_classifier_head(1, cm, CLS_ANSWERS, device="cuda")
    tree = {"params": params, "head": head}
    ctx = make_transform(ccfg.train)
    opt = ctx.init(tree)
    rng = np.random.default_rng(9)
    tgt = np.zeros((TRAIN_BATCH, CLS_ANSWERS), np.float32)
    for r in range(TRAIN_BATCH):       # VQA soft scores on 1-3 answers
        n = int(rng.integers(1, 4))
        tgt[r, rng.choice(CLS_ANSWERS, n, replace=False)] = rng.choice(
            [0.3, 0.6, 0.9, 1.0], n)
    tgt = torch.from_numpy(tgt).cuda()

    def cls_step(tree, opt):
        live = tree_map(lambda p: p.detach().requires_grad_(), tree)
        hidden, mask = vlt5.encode(live["params"], cm, gb["input_ids"],
                                   gb["vis_feats"], gb["boxes"], dtype=bf16)
        logits = vlt5.classifier_logits(live["head"], cm, live["params"],
                                        hidden, mask, dtype=bf16)
        loss = vlt5.classifier_bce_loss(logits, tgt)
        leaves = tree_leaves(live)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = tree_unflatten(tree, [torch.zeros_like(p) if x is None else x
                                  for p, x in zip(leaves, gs)])
        with torch.no_grad():
            upd, opt = ctx.update(g, opt, tree)
            tree = tree_map(lambda p, u: p - CLS_LR * u, tree, upd)
        return tree, opt, float(loss.detach())

    cls_losses, cls_counts, cls_ms = [], [], []
    for _ in range(CLS_STEPS):
        t0 = time.perf_counter()
        (tree, opt, loss), k, ks = counted(lambda: cls_step(tree, opt))
        cls_ms.append((time.perf_counter() - t0) * 1e3)
        cls_losses.append(loss)
        cls_counts.append((k, ks))
    L = cm.num_layers
    with torch.no_grad():
        ccast = vlt5.cast_params_for_inference(tree["params"], bf16)
        eb = {k: torch.from_numpy(ebatch[k]).cuda()
              for k in ("input_ids", "vis_feats", "boxes")}

        def cls_eval():
            hidden, mask = vlt5.encode(ccast, cm, **eb, dtype=bf16)
            return vlt5.classifier_logits(tree["head"], cm, ccast, hidden,
                                          mask, dtype=bf16)

        cls_eval()
        (logits, eval_ms), k_eval, ks_eval = counted(
            lambda: _events_ms(cls_eval, 3))
    out["classifier"] = {"losses": cls_losses, "step_ms": cls_ms,
                         "eval_ms": eval_ms, "launches_per_step": cls_counts,
                         "eval_launches": [k_eval, ks_eval]}
    log(f"classifier head: {CLS_ANSWERS} answers, bs {TRAIN_BATCH} bf16, "
        f"HF-AdamW lr {CLS_LR:g} over (params, head): BCE "
        f"{', '.join(f'{x:.5f}' for x in cls_losses)}; step ms (host clock) "
        f"{', '.join(f'{t:.3f}' for t in cls_ms)}; launches per step "
        f"K1/K1'/K2 {list(cls_counts[-1][0])} strided "
        f"{list(cls_counts[-1][1])}; eval bs {EVAL_BATCH}: classifier_logits "
        f"{tuple(logits.shape)} in {', '.join(f'{t:.3f}' for t in eval_ms)} "
        f"ms (CUDA events), launches {list(k_eval)} strided {list(ks_eval)}")
    if any(c != ((0, L, L), (0, L, L)) for c in cls_counts) \
            or k_eval != (3 * L, 0, 0) or ks_eval != (3 * L, 0, 0):
        fail("classifier head: unexpected kernel launches")
    if not (np.isfinite(cls_losses).all() and cls_losses[-1] < cls_losses[0]
            and bool(torch.isfinite(logits).all())):
        fail(f"classifier head: loss did not fall: {cls_losses}")
    del tree, opt, ccast
    torch.cuda.empty_cache()

    # ---- 9d. weight import and export, the directory checkpoint ---------
    work = os.path.join(HERE, "build", "chip_smoke", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ref_leaves = {k: v.cpu() for k, v in ckpt._flat_tensors(params).items()}

    def bit_equal(tree):
        flat = ckpt._flat_tensors(tree)
        return set(flat) == set(ref_leaves) and all(
            torch.equal(flat[k].cpu(), ref_leaves[k]) for k in flat)

    def du(path):
        if os.path.isfile(path):
            return os.path.getsize(path)
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)

    io = {}

    def timed_io(name, save, load, path):
        t0 = time.perf_counter()
        save()
        t1 = time.perf_counter()
        got = load()
        t2 = time.perf_counter()
        io[name] = {"save_s": t1 - t0, "load_s": t2 - t1, "bytes": du(path)}
        return got

    pth = os.path.join(work, "t5_base.pth")
    back = timed_io("pth", lambda: hf_import.save_reference_pth(
        params, pth, base), lambda: hf_import.load_reference_pth(pth, base),
        pth)
    eq_pth = bit_equal(back)
    st_dir = os.path.join(work, "t5_base_safetensors")
    os.makedirs(st_dir)
    back_st = timed_io("safetensors", lambda: hf_import.write_safetensors(
        hf_import.to_state_dict(params, base),
        os.path.join(st_dir, "model.safetensors")),
        lambda: hf_import.load_t5_base(base, st_dir), st_dir)
    eq_st = bit_equal(back_st)
    # the eval step's tokens with the re-imported weights
    ev = make_eval_step(Config(), dtype=bf16, device="cuda")
    tok_orig = ev(cast, proto, ebatch).cpu().numpy()
    tok_back = ev(vlt5.cast_params_for_inference(to_device(back_st, "cuda"),
                                                 bf16), proto,
                  ebatch).cpu().numpy()
    same_tok = bool((tok_orig == tok_back).all())
    del back, back_st
    # export_pth on phase 7's checkpoint: the .pth holds its parameters
    exp = os.path.join(work, "phase7_export.pth")
    t0 = time.perf_counter()
    export_pth.main([phase7_ckpt, exp])
    export_s = time.perf_counter() - t0
    p7, _, _ = ckpt.load_checkpoint(phase7_ckpt)
    e7 = hf_import.load_reference_pth(exp, base)
    f7, fe = ckpt._flat_tensors(p7), ckpt._flat_tensors(e7)
    eq_export = set(f7) == set(fe) and all(torch.equal(f7[k], fe[k])
                                           for k in f7)
    io["export_pth"] = {"save_s": export_s, "bytes": du(exp)}
    del p7, e7, f7, fe
    # the directory checkpoint (torch.distributed.checkpoint)
    dcp_dir = os.path.join(work, "dcp")
    dp, dproto, dstep = timed_io(
        "dcp", lambda: ckpt.save_checkpoint_dcp(dcp_dir, params, proto, 7),
        lambda: ckpt.load_checkpoint_dcp(dcp_dir), dcp_dir)
    eq_dcp = bit_equal(dp) and dstep == 7 and all(
        torch.equal(a.cpu(), b) for a, b in zip(proto, dproto))
    del dp, dproto
    shutil.rmtree(work, ignore_errors=True)
    out["io"] = io
    out["io_equal"] = {"pth": eq_pth, "safetensors": eq_st,
                       "eval_tokens": same_tok, "export_pth": eq_export,
                       "dcp": eq_dcp}
    log("weights: " + "; ".join(
        f"{n} {r['bytes']} bytes, save {r['save_s']:.3f} s"
        + (f", load {r['load_s']:.3f} s" if "load_s" in r else "")
        for n, r in io.items())
        + f"; bit-equal / equal: {json.dumps(out['io_equal'])}")
    if not all(out["io_equal"].values()):
        fail("weights changed through import, export or the directory "
             "checkpoint")

    # ---- 9e. VL-BART at bart-base widths --------------------------------
    bc = SimpleNamespace(**BART_CFG)
    bp = bart.init_bart_params(0, bc, device="cuda")
    ids, am, feats, boxes, labels = _bart_inputs(bc, TRAIN_BATCH, seed=3)

    def bart_fwd():
        with torch.no_grad():
            enc, mask = bart.bart_encode(bp, bc, ids, am, feats, boxes,
                                         dtype=bf16)
            return bart.bart_decode_train(bp, bc, enc, mask, labels,
                                          dtype=bf16)

    bart_fwd()
    logits, bart_ms = _events_ms(bart_fwd, 3)
    ok_shape = tuple(logits.shape) == (TRAIN_BATCH, bc.target_len,
                                       bc.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    del bp, logits
    tc = SimpleNamespace(**BART_TINY)
    tp = bart.init_bart_params(1, tc, device="cpu")
    t_in = _bart_inputs(tc, 4, seed=4)
    bart_err = 0.0
    for regions in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            i, a, f_, b_, lab = (x.to(dev) for x in t_in)
            pd = to_device(tp, dev)
            enc, mask = bart.bart_encode(pd, tc, i, a,
                                         f_ if regions else None,
                                         b_ if regions else None)
            res[dev] = bart.bart_decode_train(pd, tc, enc, mask,
                                              lab).cpu()
        diff = (res["cuda"] - res["cpu"]).abs()
        bart_err = max(bart_err, float((diff / (F32_CARD_RTOL * (
            1.0 + res["cpu"].abs()))).max()))
    out["bart"] = {"forward_ms": bart_ms, "finite": finite,
                   "shape_ok": ok_shape, "tiny_f32_err_over_tol": bart_err}
    log(f"vl_bart: bart-base widths ({bc.num_layers}+{bc.num_decoder_layers}"
        f" layers, d_model {bc.d_model}, vocab {bc.vocab_size}), bs "
        f"{TRAIN_BATCH} bf16, {bc.text_len} text + {bc.n_boxes} regions, "
        f"{bc.target_len} answer tokens: encode + decode_train "
        f"{', '.join(f'{t:.3f}' for t in bart_ms)} ms (CUDA events), finite "
        f"{finite}, shape ok {ok_shape}; tiny f32 card vs CPU with and "
        f"without regions: max err / (1e-5 (1 + |cpu|)) = {bart_err:.3e}")
    if not (finite and ok_shape and bart_err <= 1.0):
        fail("VL-BART: not finite, wrong shape or the card differs from "
             "the CPU")
    log(f"phase 9 launches K1={k_total[0]} K1'={k_total[1]} K2={k_total[2]}")
    return out, k_total


def write_obj_tsv(path, rows):
    """LXMERT-format tsv (the layout of the public COCO region features,
    ``data/tsv_convert.py::FIELDNAMES``): one image per line, its arrays
    base64-encoded. ``rows``: (img_id, features [n,2048], boxes [n,4] in
    pixels, img_h, img_w)."""
    import base64
    import csv

    import numpy as np

    b64 = lambda a: base64.b64encode(np.ascontiguousarray(a).tobytes()
                                     ).decode()
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        for img_id, feats, boxes, h, w_ in rows:
            n = feats.shape[0]
            w.writerow([img_id, h, w_, b64(np.arange(n, dtype=np.int64)),
                        b64(np.ones(n, np.float32)),
                        b64(np.zeros(n, np.int64)),
                        b64(np.ones(n, np.float32)), n,
                        b64(boxes.astype(np.float32)),
                        b64(feats.astype(np.float32))])


def write_vqa_root(root, tasks, items, n_images, seed=0):
    """A reference-format VQA v2 root (the layout ``VQADataModule``
    reads): ``vqa/Partition_Q/karpathy_{train,val,test}_{task}.json`` with
    ``items`` (train, val, test) questions per task over ``n_images``
    COCO images, ``QuesId_task_map.json``, ``ImgId_cate_map.json``,
    ``vqa/v2_mscoco_val2014_annotations.json`` and the region features
    (36 × 2048) as an LXMERT tsv converted by ``tsv_to_pack`` into
    ``COCO/features/coco_obj36.vfpack`` → the number of images packed."""
    import numpy as np

    from vqacl_tpu_torch.data.tsv_convert import tsv_to_pack

    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, "COCO", "features")
    os.makedirs(os.path.join(root, "vqa", "Partition_Q"))
    os.makedirs(feat_dir)
    imgs = [f"COCO_val2014_{i:012d}" for i in range(1, n_images + 1)]
    cate = {img: int(rng.integers(0, 80)) for img in imgs}
    words = ("yes", "no", "two", "red", "dog", "table", "man", "car")
    ques_map, anns, qid = {}, [], 1
    for t_idx, task in enumerate(tasks):
        for split, n in zip(("karpathy_train", "karpathy_val",
                             "karpathy_test"), items):
            rows = []
            for _ in range(n):
                img = imgs[int(rng.integers(0, n_images))]
                ans = [words[int(a)] for a in rng.integers(0, len(words), 10)]
                vals, cnt = np.unique(ans, return_counts=True)
                rows.append({
                    "img_id": img, "question_id": qid,
                    "sent": f"what is the {words[cate[img] % 8]} in the "
                            f"picture {qid % 7}?",
                    "label": {str(a): min(1.0, c / 3) for a, c in
                              zip(vals, cnt)},
                    "answers": [{"answer": a} for a in ans],
                    "question_type": "what is", "answer_type": "other"})
                anns.append({"question_id": qid,
                             "answers": [{"answer": a} for a in ans],
                             "question_type": "what is",
                             "answer_type": "other"})
                ques_map[str(qid)] = t_idx
                qid += 1
            with open(os.path.join(root, "vqa", "Partition_Q",
                                   f"{split}_{task}.json"), "w") as f:
                json.dump(rows, f)
    with open(os.path.join(root, "QuesId_task_map.json"), "w") as f:
        json.dump(ques_map, f)
    with open(os.path.join(root, "ImgId_cate_map.json"), "w") as f:
        json.dump(cate, f)
    with open(os.path.join(root, "vqa",
                           "v2_mscoco_val2014_annotations.json"), "w") as f:
        json.dump({"annotations": anns}, f)

    def tsv_rows():
        for img in imgs:
            xy = rng.uniform(0, 400, (36, 2)).astype(np.float32)
            wh = rng.uniform(20, 200, (36, 2)).astype(np.float32)
            yield (img, rng.normal(size=(36, 2048)).astype(np.float32),
                   np.concatenate([xy, xy + wh], axis=1), 480, 640)

    tsv = os.path.join(root, "coco_obj36.tsv")
    write_obj_tsv(tsv, tsv_rows())
    n = tsv_to_pack([tsv], os.path.join(feat_dir, "coco_obj36.vfpack"))
    os.remove(tsv)
    return n


def nextqa_tables(tok, tasks, items, n_videos, seed=0):
    """NExT-QA over tables (``NextQADataModule``'s direct constructor):
    CSV-like rows through ``items_from_rows`` for each task and split
    (question ids ``"{video}_{qid}"``), answers from ``NQ_ANSWERS``, and
    16 × 2048 motion features per video (one table for every split)."""
    import numpy as np

    from vqacl_tpu_torch.nextqa.data import (NextQADataModule,
                                             VideoFeatureStore,
                                             items_from_rows)

    rng = np.random.default_rng(seed)
    videos = [str(4000 + i) for i in range(n_videos)]
    table = {v: rng.normal(size=(16, 2048)).astype(np.float32)
             for v in videos}
    rows, qid = {}, 0
    for task in tasks:
        rows[task] = {}
        for mode, n in zip(("train", "val", "test"), items):
            raw = []
            for _ in range(n):
                video = videos[int(rng.integers(0, n_videos))]
                raw.append({"video": video, "qid": str(qid),
                            "question": f"what does the {NQ_ANSWERS[qid % 9]}"
                                        f" do after {qid % 5}",
                            "answer": NQ_ANSWERS[int(rng.integers(
                                0, len(NQ_ANSWERS)))],
                            "type": task, "bigCate": int(rng.integers(1, 81))})
                qid += 1
            rows[task][mode] = items_from_rows(raw)
    features = {m: VideoFeatureStore(table=table)
                for m in ("train", "val", "test")}
    return NextQADataModule(tok, rows, features, tasks=tasks)


def cli_run(module, argv, label, counters):
    """``module.main(argv)`` as a user runs it. The trainer that main
    makes is read through ``module.run``: with ``--now_train`` through
    ``drive_cl``; without it ``Test()``, whose K1 launches must equal
    the encoder layers × its predict batches (all strided with merged
    projections) and K1′ and K2 none → (trainer, record)."""
    import numpy as np

    zero_counts, read_counts, num_layers = counters
    orig = module.run
    got = {}

    def run(trainer, cli):
        got["trainer"] = trainer
        if cli.now_train:
            got["rec"] = drive_cl(trainer, label, counters,
                                  train=lambda: orig(trainer, cli))
            return got["rec"]["metrics"]
        zero_counts()
        t0 = time.perf_counter()
        metrics = orig(trainer, cli)
        wall = time.perf_counter() - t0
        k = list(read_counts())
        strided = list(strided_counts())
        n = trainer.counts["predict_batches"]
        matrix = trainer.result_matrix.matrix().tolist()
        got["rec"] = {"wall_s": wall, "launches": k,
                      "strided_launches": strided, "predict_batches": n,
                      "predict_batch_ms_median": sorted(
                          trainer.times_ms["predict_batches"])[n // 2],
                      "result_matrix": matrix, "metrics": metrics}
        log(f"{label}: Test() wall {wall:.3f} s, {n} predict batches, "
            f"launches K1={k[0]} K1'={k[1]} K2={k[2]} (expected "
            f"{num_layers * n}/0/0), strided {strided}")
        if k != [num_layers * n, 0, 0] or n == 0 \
                or (trainer.cfg.model.merged_qkv is True and strided != k):
            fail(f"{label}: Test() launches {k} (strided {strided}) for "
                 f"{n} predict batches")
        if not np.isfinite(np.asarray(matrix)).all():
            fail(f"{label}: the result matrix is not finite: {matrix}")
        return metrics

    module.run = run
    try:
        module.main(argv)
    finally:
        module.run = orig
    return got["trainer"], got["rec"]


def training_entry_points(params, counters, tok):
    """Phase 10: the training entry points at t5-base (``params``: phase
    3's random-init weights). ``counters``: (zero_counts, read_counts). →
    (summary, launches (K1, K1′, K2) of the phase's main-path runs)."""
    import numpy as np

    from vqacl_tpu_torch.cl.tasks import ALL_TASKS
    from vqacl_tpu_torch.cli import nextqa_train, vqacl_train
    from vqacl_tpu_torch.cli.args import parse_config
    from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
    from vqacl_tpu_torch.data.vqa_module import VQADataModule
    from vqacl_tpu_torch.models import hf_import
    from vqacl_tpu_torch.train import checkpoint as ckpt

    zero_counts, read_counts = counters
    base_layers = parse_config([]).model.num_layers
    cnt = (zero_counts, read_counts, base_layers)
    out = {}
    k_total = [0, 0, 0]

    def add(k):
        for i in range(3):
            k_total[i] += k[i]

    shutil.rmtree(P10_DIR, ignore_errors=True)
    os.makedirs(P10_DIR)
    try:
        # ---- 10b. the VQA CLI at t5-base over a reference-format root ----
        root = os.path.join(P10_DIR, "vqa")
        t0 = time.perf_counter()
        n_packed = write_vqa_root(root, ALL_TASKS, P10_ITEMS, P10_IMAGES)
        root_s = time.perf_counter() - t0
        snap = os.path.join(P10_DIR, "snap")
        argv = ["--dataset_root", root, "--output", snap, "--from_scratch",
                "--batch_size", str(TRAIN_BATCH), "--valid_batch_size",
                str(EVAL_BATCH), "--epochs", "1", "--memory", "--m_size",
                str(CL_M_SIZE), "--device_cache", "--now_train"]
        log(f"cli_vqa: root of {len(ALL_TASKS)} tasks x {P10_ITEMS} items, "
            f"{n_packed} images through tsv_to_pack, written in "
            f"{root_s:.3f} s; vqacl_train.main {' '.join(argv)}")
        trainer, rec = cli_run(vqacl_train, argv, "cli_vqa", cnt)
        packed = isinstance(trainer.data.features, PackedFeatureStore)
        files = sorted(os.listdir(snap))
        want = sorted([f"{t}_LAST.npz" for t in ALL_TASKS]
                      + ["Q_prototype.npy", "V_prototype.npy",
                         "metrics.json", "train_log.jsonl"])
        log(f"cli_vqa: {type(trainer).__name__}, feature store "
            f"{type(trainer.data.features).__name__}, dtype "
            f"{trainer.dtype}, merged_qkv {trainer.cfg.model.merged_qkv}; "
            f"files {files}")
        if not packed or files != want:
            fail(f"cli_vqa: the CLI left {files} (expected {want}) or read "
                 f"no pack")
        add(rec["launches"])
        del trainer
        torch.cuda.empty_cache()
        _, test_rec = cli_run(vqacl_train,
                              [a for a in argv if a != "--now_train"],
                              "cli_vqa_test", cnt)
        same = test_rec["result_matrix"] == rec["result_matrix"]
        log(f"cli_vqa: Test() matrix == the training run's: {same}")
        if not same:
            fail("cli_vqa: Test() over the saved checkpoints differs from "
                 "the training run's matrix")
        add(test_rec["launches"])
        out["vqa"] = {k: v for k, v in rec.items() if k != "metrics"}
        out["vqa"].update(tasks=len(ALL_TASKS), items=list(P10_ITEMS),
                          images=n_packed, root_s=root_s)
        out["vqa_test"] = {k: v for k, v in test_rec.items()
                           if k != "metrics"}
        out["vqa_test"]["equal_to_training"] = same
        for t in ALL_TASKS:
            os.remove(os.path.join(snap, f"{t}_LAST.npz"))
        torch.cuda.empty_cache()

        # ---- 10c. the backbone start ------------------------------------
        m = parse_config([]).model
        st_dir = os.path.join(P10_DIR, "backbone")
        os.makedirs(st_dir)
        hf_import.write_safetensors(hf_import.to_state_dict(params, m),
                                    os.path.join(st_dir, "model.safetensors"))
        bargv = [a for a in argv if a not in ("--from_scratch",
                                              "--now_train")]
        t0 = time.perf_counter()
        trainer = vqacl_train.make_trainer(
            parse_config(bargv + ["--backbone", st_dir]))
        start_s = time.perf_counter() - t0
        got = ckpt._flat_tensors(trainer.state.params)
        ref = ckpt._flat_tensors(params)
        bit_equal = set(got) == set(ref) and all(
            torch.equal(got[k], ref[k]) for k in ref)
        del trainer, got
        scratch = vqacl_train.make_trainer(parse_config(argv))
        differs = not torch.equal(scratch.state.params["shared"],
                                  params["shared"])
        del scratch
        torch.cuda.empty_cache()
        out["backbone"] = {"bit_equal": bit_equal,
                           "scratch_differs": differs, "start_s": start_s}
        log(f"cli_backbone: make_trainer without --from_scratch, "
            f"--backbone {st_dir} (model.safetensors of phase 3's weights): "
            f"starting parameters bit-equal to the file: {bit_equal}; "
            f"the scratch start differs: {differs}; {start_s:.3f} s")
        if not (bit_equal and differs):
            fail("cli_backbone: the trainer did not start from --backbone")

        # ---- 10d. NExT-QA at t5-base -------------------------------------
        nq_snap = os.path.join(P10_DIR, "nextqa")
        cfg = parse_config(
            ["--output", nq_snap, "--from_scratch", "--batch_size",
             str(TRAIN_BATCH), "--valid_batch_size", str(EVAL_BATCH),
             "--epochs", "1", "--memory", "--m_size", str(CL_M_SIZE),
             "--proto_alpha", "0.3", "--proto_beta", "0.5", "--now_train"])
        nextqa_train.nextqa_geometry(cfg)
        t0 = time.perf_counter()
        ndata = nextqa_tables(tok, NQ_TASKS, NQ_ITEMS, NQ_VIDEOS)
        trainer = nextqa_train.make_trainer(cfg, data=ndata)
        set_up = time.perf_counter() - t0
        scores = []

        def evaluate(loader, task, evaluate=trainer.evaluate):
            scores.append(evaluate(loader, task))
            return scores[-1]

        trainer.evaluate = evaluate
        nm = trainer.cfg.model
        log(f"cli_nextqa: {type(trainer).__name__}, tasks {list(NQ_TASKS)} "
            f"x {NQ_ITEMS} items, encoder {nm.max_text_length} text + "
            f"{nm.n_boxes} clips = {nm.encoder_len}, {nm.n_ques_types} "
            f"question types, schedule {trainer.cfg.train.schedule}, "
            f"lambda_Q/V {trainer.cfg.train.lambda_Q}/"
            f"{trainer.cfg.train.lambda_V}, proto alpha/beta "
            f"{trainer.cfg.train.proto_alpha}/{trainer.cfg.train.proto_beta}"
            f"; set-up {set_up:.3f} s")
        rec = drive_cl(trainer, "cli_nextqa", cnt)
        with open(os.path.join(nq_snap, "metrics.json")) as f:
            nq_metrics = json.load(f)
        backends = sorted({s["wups_backend"] for s in scores})
        cov = [s["wups_vocab_coverage"] for s in scores]
        wups = [s["overall"] for s in scores]
        log(f"cli_nextqa: metrics.json Avg_acc (WUPS-0) "
            f"{nq_metrics['Avg_acc']}, {len(scores)} evaluations: WUPS "
            f"{min(wups):.3f}-{max(wups):.3f}, wups_backend {backends}, "
            f"wups_vocab_coverage {min(cov):.3f}-{max(cov):.3f}")
        if nm.encoder_len != 39 or not scores or not all(
                0.0 <= c <= 1.0 for c in cov) or not set(backends) <= {
                "nltk-wordnet", "wndb-files", "vendored-taxonomy"}:
            fail("cli_nextqa: geometry or WUPS telemetry wrong")
        add(rec["launches"])
        out["nextqa"] = {k: v for k, v in rec.items() if k != "metrics"}
        out["nextqa"].update(
            encoder_len=nm.encoder_len, avg_acc_wups=nq_metrics["Avg_acc"],
            wups_backend=backends, wups_vocab_coverage=[min(cov), max(cov)],
            wups_range=[min(wups), max(wups)])
        del trainer, ndata
        torch.cuda.empty_cache()

        # ---- 10e. tiny f32 CLI runs, card vs CPU -------------------------
        # at the CLI's default lr (the reference's 1e-4). At 1e-3 the VQA
        # run's per-step losses left the CPU run's by more than
        # CL_LOSS_RTOL, with equal answers and matrices, and as much with
        # the unfused attention as with the kernels: Adam turns the card's
        # and the host's f32 sum orders over the 2048-wide features into
        # different updates of near-zero gradient entries
        out["tiny"] = {}
        for name, module in (("vqa", vqacl_train), ("nextqa", nextqa_train)):
            runs = {}
            for platform in ("auto", "cpu"):
                tsnap = os.path.join(P10_DIR, f"tiny_{name}_{platform}")
                targv = ["--tiny_model", "--platform", platform, "--output",
                         tsnap, "--from_scratch", "--batch_size",
                         str(P10_TINY_BATCH), "--valid_batch_size",
                         str(P10_TINY_BATCH), "--epochs", "1", "--memory",
                         "--m_size", "16", "--dtype", "float32",
                         "--now_train"]
                if name == "vqa":
                    targv += ["--comp_cate", "G5"]
                tcfg = parse_config(targv)
                tcfg.model.dropout_rate = 0.0
                if name == "vqa":
                    tdata = VQADataModule(root, tok, tasks=ALL_TASKS[:2],
                                          train_topk=P10_TINY[0],
                                          valid_topk=P10_TINY[1])
                else:
                    nextqa_train.nextqa_geometry(tcfg)
                    tdata = nextqa_tables(tok, NQ_TASKS, P10_TINY, 32,
                                          seed=1)
                trainer = module.make_trainer(tcfg, data=tdata)
                answers = []

                def predict(loader, predict=trainer.predict):
                    answers.append(predict(loader))
                    return answers[-1]

                trainer.predict = predict
                tm = trainer.cfg.model
                r = drive_cl(trainer, f"cli_tiny_{name}_{platform}",
                             (zero_counts, read_counts, tm.num_layers)
                             if platform == "auto" else None,
                             train=lambda t=trainer, c=tcfg._cli:
                             module.run(t, c))
                r["answers"] = answers
                r["device"] = trainer.device.type
                r["cls"] = type(trainer).__name__
                r["metrics_json"] = {}
                for fname in ("metrics.json", "metrics_comp.json"):
                    if os.path.exists(os.path.join(tsnap, fname)):
                        with open(os.path.join(tsnap, fname)) as f:
                            r["metrics_json"][fname] = json.load(f)
                runs[platform] = r
                del trainer
            card, cpu = runs["auto"], runs["cpu"]
            err = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                            cpu["losses"]))
            same = {k: card[k] == cpu[k] for k in (
                "result_matrix", "answers", "metrics_json")}
            log(f"cli tiny f32 {name} ({card['cls']}), --platform auto on "
                f"{card['device']} vs cpu on {cpu['device']}: "
                f"{len(card['losses'])} / {len(cpu['losses'])} steps, loss "
                f"max rel err {err:.3e} (tol {CL_LOSS_RTOL:g}); equal: "
                f"{json.dumps(same)}")
            if card["device"] != "cuda" or cpu["device"] != "cpu" \
                    or len(card["losses"]) != len(cpu["losses"]) \
                    or not err <= CL_LOSS_RTOL or not all(same.values()):
                fail(f"cli tiny f32 {name}: the card run differs from the "
                     f"CPU run")
            add(card["launches"])
            out["tiny"][name] = {"loss_rel_err": err, "equal": same,
                                 "cls": card["cls"],
                                 "launches": card["launches"]}
    finally:
        shutil.rmtree(P10_DIR, ignore_errors=True)
    log(f"phase 10 launches K1={k_total[0]} K1'={k_total[1]} "
        f"K2={k_total[2]}")
    return out, k_total


def p11_image(rng, h, w):
    """A synthetic BGR uint8 image with structure: 8-px blocks of random
    colour, a few solid rectangles, pixel noise."""
    import numpy as np

    img = np.repeat(np.repeat(rng.integers(0, 256, (-(-h // 8), -(-w // 8),
                                                    3)), 8, 0), 8, 1)[:h, :w]
    img = img.astype(np.int64)
    for _ in range(6):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + rng.integers(8, h // 2), x:x + rng.integers(8, w // 2)] = \
            rng.integers(0, 256, 3)
    img += rng.integers(-8, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def p11_detector(frcnn, resnet, device):
    """``init_frcnn(0)`` with each bottleneck's last folded-BN scale x0.2,
    the RPN's deltas x0.01 and the class head x0.02. The plain random
    init doubles the activations' variance in every residual block (C4
    near 1e7 after 26 blocks): every decoded box then leaves the image
    and no proposal is valid. Damped, C4 stays in the hundreds, proposals
    lie on the image and class scores spread over (1/1601, 0.6), as a
    trained detector's do."""
    det = frcnn.init_frcnn(0, device)
    for name, *_ in resnet.R101_STAGES + [resnet.RES5]:
        for blk in det["backbone"][name].values():
            blk["conv3"]["scale"] = blk["conv3"]["scale"] * 0.2
    det["rpn"]["delta_w"] = det["rpn"]["delta_w"] * 0.01
    det["heads"]["cls_w"] = det["heads"]["cls_w"] * 0.02
    return det


def p11_stages(frcnn, rpn, resnet, nms, det, image, hw, n_props):
    """The detector's stage outputs for one image [H,W,3] (the same
    functions ``_extract_regions_impl`` runs), in f32."""
    with torch.inference_mode():
        feat = resnet.backbone_c4(det["backbone"], frcnn._nchw(image[None]))
        logits, deltas = rpn.rpn_head(det["rpn"], feat)
        anchors = rpn.anchor_grid(feat.shape[2], feat.shape[3], feat.device)
        boxes = rpn.decode_deltas(anchors, deltas[0])
        props, pv = rpn.select_proposals(logits[0], boxes, hw,
                                         post_nms_topk=n_props)
        pooled = frcnn._pooled(det, feat, props)
        h = det["heads"]
        probs = torch.softmax(pooled @ h["cls_w"] + h["cls_b"], dim=-1)
        conf = torch.where(pv, probs[:, 1:].max(dim=1).values,
                           torch.tensor(-1.0, device=probs.device))
        idx, valid = nms.max_nms_fixed(props, conf, n_keep=36)
    return {"feat": feat, "logits": logits[0], "deltas": deltas[0],
            "boxes": boxes, "props": props, "prop_valid": pv,
            "pooled": pooled, "conf": conf, "idx": idx, "valid": valid}


def _rel_err(a, b):
    """max|a - b| / max|b| (b the reference)."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _min_gap(x):
    """The smallest relative gap between distinct sorted values of x."""
    x = torch.sort(x.float().cpu()).values
    d = x[1:] - x[:-1]
    pos = d > 0
    if not bool(pos.any()):
        return float("inf")
    return float((d[pos] / x[1:][pos].abs().clamp(min=1e-30)).min())


def extraction(params, proto, counters, tok):
    """Phase 11: region and video extraction at full width (``params``,
    ``proto``: phase 3's t5-base for the answer path; ``counters``:
    (zero_counts, read_counts)) → (summary, K1/K1′/K2 launches of the
    phase's main-path runs, N1 launches of the same)."""
    import numpy as np

    from vqacl_tpu_torch.cli import extract_features as ef
    from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.ops import nms
    from vqacl_tpu_torch.serve import VQAPredictor
    from vqacl_tpu_torch.utils.config import Config
    from vqacl_tpu_torch.vision import (frcnn, resnet, resnext3d, rpn,
                                        video)

    zero_counts, read_counts = counters
    cudnn, cuda_mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cuda_mm.allow_tf32)
    out = {}
    shutil.rmtree(P11_DIR, ignore_errors=True)
    os.makedirs(P11_DIR)
    try:
        # the timed runs at torch's defaults: TF32 in cuDNN's convolutions,
        # full f32 in matmuls
        cudnn.allow_tf32, cuda_mm.allow_tf32 = True, False
        log(f"phase 11: timed runs at torch's default TF32 flags (cudnn "
            f"{cudnn.allow_tf32}, matmul {cuda_mm.allow_tf32})")
        t0 = time.time()
        det = p11_detector(frcnn, resnet, "cuda")
        rng = np.random.default_rng(11)
        imgs = [p11_image(rng, h, w) for h, w in P11_IMAGES]
        log(f"phase 11: detector init (seed 0, damped) in "
            f"{time.time() - t0:.1f} s")
        n1_start = nms.greedy_nms.launches
        zero_counts()

        # ---- 11a. region extraction, one image at a time ----------------
        for img in imgs:            # warm-up: each bucket's first call
            frcnn.extract_image(det, img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()      # earlier phases' tensors
        stages, buckets, walls, recs, resize_ms = [], [], [], [], []
        before = nms.greedy_nms.launches
        for img in imgs:
            evs = []

            def mark(stage, evs=evs):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                evs.append((stage, e))

            t1 = time.perf_counter()
            rec = frcnn.extract_image(det, img, mark=mark)
            walls.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(evs, evs[1:])})
            t1 = time.perf_counter()          # the host's share of the wall
            resized, _ = frcnn.resize_shortest_edge(img.astype(np.float32))
            buckets.append(frcnn.pad_to_bucket(resized).shape[:2])
            resize_ms.append((time.perf_counter() - t1) * 1e3)
            recs.append(rec)
            f, b = rec["features"], rec["boxes"]
            h, w = img.shape[:2]
            ok = (f.shape == (36, 2048) and bool(np.isfinite(f).all())
                  and b.shape == (36, 4) and b.min() >= 0
                  and b[:, (0, 2)].max() <= w and b[:, (1, 3)].max() <= h
                  and rec["obj_id"].min() >= 1
                  and rec["obj_id"].max() <= frcnn.N_CLASSES)
            if not ok:
                fail(f"extract_image {img.shape}: features {f.shape} finite "
                     f"{np.isfinite(f).all()}, boxes [{b.min()}, {b.max()}], "
                     f"obj_id [{rec['obj_id'].min()}, {rec['obj_id'].max()}]")
        n1_per_image = (nms.greedy_nms.launches - before) / len(imgs)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        for (h, w), bk, st, wall, rz in zip(P11_IMAGES, buckets, stages,
                                            walls, resize_ms):
            log(f"extract_image {h}x{w} -> bucket {bk[0]}x{bk[1]}: stage ms "
                f"(CUDA events, launch gaps included) "
                + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
                + f"; wall {wall:.3f} ms, of which the host's resize and "
                f"pad {rz:.3f} ms")
        log(f"extract_image: N1 launches {n1_per_image:g} per image "
            f"(expected 2), peak device memory {peak:.1f} MiB above the "
            f"{held / 2 ** 20:.1f} MiB held before (weights included), "
            f"buckets {sorted(set(buckets))}")
        if n1_per_image != 2 or len(set(buckets)) < 2:
            fail("extract_image: N1 launches or pad buckets wrong")
        out["images"] = [{"hw": list(hw), "bucket": list(bk), "stage_ms": st,
                          "wall_ms": wall, "resize_ms": rz}
                         for hw, bk, st, wall, rz
                         in zip(P11_IMAGES, buckets, stages, walls,
                                resize_ms)]
        out["n1_per_image"] = n1_per_image
        out["peak_mib"] = peak

        # ---- 11b. given boxes --------------------------------------------
        resized, scale = frcnn.resize_shortest_edge(
            imgs[0].astype(np.float32))
        gimg = torch.from_numpy(frcnn.pad_to_bucket(resized)).cuda()
        gboxes = torch.from_numpy(recs[0]["boxes"] * scale).cuda()
        (gf, gi, gc), g_ms = _events_ms(
            lambda: frcnn.extract_given_boxes(det, gimg, gboxes), 3)
        if gf.shape != (36, 2048) or not bool(torch.isfinite(gf).all()) \
                or int(gi.min()) < 1 or int(gi.max()) > frcnn.N_CLASSES:
            fail("extract_given_boxes: bad output")
        log(f"extract_given_boxes: 36 boxes, ms {[round(x, 3) for x in g_ms]}")
        out["given_boxes_ms"] = g_ms

        # ---- 11c. the CLI's record generator into a pack, then answers -----
        pack = os.path.join(P11_DIR, "regions.vfpack")
        args = ef.parse_args(["--images", "-", "--out", pack, "--pack"])
        got = []

        def tee(records):
            for r in records:
                got.append(r)
                yield r

        t1 = time.perf_counter()
        ef.write(args, tee(ef.records(
            det, ((f"coco_{i}", img, None) for i, img in enumerate(imgs)),
            args.n_boxes, "cuda")))
        cli_s = time.perf_counter() - t1
        store = PackedFeatureStore(pack)
        try:
            equal = True
            for img_id, rec in got:
                f, b = store.get(img_id)
                inv = np.float32(1.0) / np.asarray(
                    [rec["img_w"], rec["img_h"]] * 2, np.float32)
                want_b = np.clip(rec["boxes"] * inv, 0.0, 1.0)
                equal &= bool(np.array_equal(f, rec["features"])
                              and np.array_equal(b, want_b))
            cfg = Config()
            qs = [f"what is in the {w} of the picture?" for w in
                  ("middle", "left", "right", "top")] * len(got)
            ids = [img_id for img_id, _ in got for _ in range(4)]
            pred = VQAPredictor(cfg, params, proto, tok, store,
                                batch_size=len(qs), dtype=torch.bfloat16,
                                device="cuda")
            zero_counts()
            answers = pred.answer(qs, ids)
            torch.cuda.synchronize()
            k1 = read_counts()
            del pred
        finally:
            store.close()
        log(f"cli pack: {len(got)} records via ef.records/ef.write in "
            f"{cli_s:.3f} s; PackedFeatureStore == records (features and "
            f"normalized boxes) bit for bit: {equal}; t5-base VQAPredictor "
            f"over the pack: {len(answers)} answers in one batch, launches "
            f"K1={k1[0]} K1'={k1[1]} K2={k1[2]}; first {answers[:4]}")
        if not equal or k1 != (cfg.model.num_layers, 0, 0) \
                or len(answers) != len(qs) \
                or not all(isinstance(a, str) for a in answers):
            fail("the extracted pack does not reach the answer path")
        out["cli"] = {"records": len(got), "write_s": cli_s,
                      "answers": len(answers), "k1": k1[0]}
        n1_main = nms.greedy_nms.launches - n1_start

        # ---- 11a'/11d. f32: a batch against single images, the card
        # against the CPU (TF32 off for these comparisons only) ------------
        cudnn.allow_tf32 = False
        log(f"phase 11: f32 comparisons with TF32 off (cudnn "
            f"{cudnn.allow_tf32}, matmul {cuda_mm.allow_tf32}); tolerance "
            f"max|x - ref| <= {P11_F32_RTOL:g} * max|ref|")
        bimgs, bhw = [], []
        for h, w in P11_BATCH_IMAGES:
            r, _ = frcnn.resize_shortest_edge(
                p11_image(rng, h, w).astype(np.float32))
            bimgs.append(frcnn.pad_to_bucket(r))
            bhw.append(r.shape[:2])
        if len({b.shape for b in bimgs}) != 1:
            fail(f"P11_BATCH_IMAGES span buckets {[b.shape for b in bimgs]}")
        bx = torch.from_numpy(np.stack(bimgs)).cuda()
        bh = torch.tensor(bhw, dtype=torch.float32, device="cuda")
        batch = frcnn.extract_regions_batch(det, bx, bh)
        with torch.inference_mode():
            c4_batch = resnet.backbone_c4(det["backbone"], frcnn._nchw(bx))
        c4_err, rows_equal, feat_err = 0.0, [], 0.0
        for i in range(len(bimgs)):
            single = frcnn.extract_regions(det, bx[i], bh[i])
            with torch.inference_mode():
                c4 = resnet.backbone_c4(det["backbone"],
                                        frcnn._nchw(bx[i:i + 1]))
            c4_err = max(c4_err, _rel_err(c4_batch[i:i + 1], c4))
            same = (batch.boxes[i] == single.boxes).all(dim=1) \
                & (batch.obj_id[i] == single.obj_id)
            rows_equal.append(int(same.sum()))
            if bool(same.any()):
                feat_err = max(feat_err, _rel_err(batch.features[i][same],
                                                  single.features[same]))
        log(f"extract_regions_batch: {len(bimgs)} images of bucket "
            f"{bimgs[0].shape[:2]}: C4 max rel err vs single {c4_err:.3e}; "
            f"selected rows equal to the single-image call {rows_equal} of "
            f"36, their features' max rel err {feat_err:.3e}")
        if not (c4_err <= P11_F32_RTOL and feat_err <= P11_F32_RTOL
                and batch.features.shape == (len(bimgs), 36, 2048)
                and bool(torch.isfinite(batch.features).all())):
            fail("extract_regions_batch differs from the single-image calls")
        out["batch"] = {"c4_rel_err": c4_err, "rows_equal": rows_equal,
                        "feat_rel_err": feat_err}

        (ph, pw), (th, tw) = P11_F32_IMAGE
        img = np.zeros((ph, pw, 3), np.float32)
        img[:th, :tw] = p11_image(rng, th, tw)
        hw = np.asarray([th, tw], np.float32)
        det_cpu = to_device(det, "cpu")
        t1 = time.time()
        cpu = p11_stages(frcnn, rpn, resnet, nms, det_cpu,
                         torch.from_numpy(img), torch.from_numpy(hw),
                         P11_F32_PROPOSALS)
        cpu_s = time.time() - t1
        gpu_img, gpu_hw = torch.from_numpy(img).cuda(), torch.from_numpy(
            hw).cuda()
        card = p11_stages(frcnn, rpn, resnet, nms, det, gpu_img, gpu_hw,
                          P11_F32_PROPOSALS)
        cu = lambda k: cpu[k].cuda()                       # noqa: E731
        with torch.inference_mode():
            lg, dl = rpn.rpn_head(det["rpn"], cu("feat"))
            sp, sv = rpn.select_proposals(cu("logits"), cu("boxes"), gpu_hw,
                                          post_nms_topk=P11_F32_PROPOSALS)
            pooled = frcnn._pooled(det, cu("feat"), cu("props"))
            idx, valid = nms.max_nms_fixed(cu("props"), cu("conf"), 36)
        errs = {"c4": _rel_err(card["feat"], cpu["feat"]),
                "rpn_logits": _rel_err(lg[0], cpu["logits"]),
                "rpn_deltas": _rel_err(dl[0], cpu["deltas"]),
                "pooled": _rel_err(pooled, cpu["pooled"])}
        bits = {"select_proposals": bool(
                    torch.equal(sp.cpu(), cpu["props"])
                    and torch.equal(sv.cpu(), cpu["prop_valid"])),
                "max_nms_fixed": bool(
                    torch.equal(idx.cpu(), cpu["idx"])
                    and torch.equal(valid.cpu(), cpu["valid"]))}
        top = cpu["logits"][torch.isfinite(cpu["logits"])]
        gaps = {"rpn_logits": _min_gap(top),
                "conf": _min_gap(cpu["conf"][cpu["prop_valid"]])}
        separated = min(gaps.values()) > P11_SEPARATED
        whole = int((card["props"][card["idx"]].cpu()
                     == cpu["props"][cpu["idx"]]).all(dim=1).sum())
        log(f"f32 card vs CPU, {ph}x{pw} image ({th}x{tw} true), "
            f"{P11_F32_PROPOSALS} proposals (CPU {cpu_s:.1f} s): stage max "
            f"rel err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {P11_F32_RTOL:g}; each stage on the CPU's inputs); "
            f"bit-equal on the CPU's inputs: {json.dumps(bits)}; whole "
            f"pipeline: {whole}/36 selected boxes equal, score gaps "
            f"{json.dumps(gaps)} -> "
            + ("held (well separated)" if separated else
               f"not held: gaps within {P11_SEPARATED:g} of f32 noise"))
        if max(errs.values()) > P11_F32_RTOL or not all(bits.values()) \
                or (separated and whole != 36):
            fail("the detector on the card differs from the CPU in f32")
        out["f32"] = {"rel_err": errs, "bit_equal": bits, "gaps": gaps,
                      "whole_equal": whole, "whole_held": separated}
        del det_cpu, cpu, card
        cudnn.allow_tf32 = True

        # ---- 11e. video: the RGB-difference and the 3D ResNeXt motion ----
        vdir = os.path.join(P11_DIR, "videos")
        os.makedirs(vdir)
        S = P11_VIDEO_SIDE
        for v in range(P11_VIDEOS):
            base = p11_image(rng, S, 2 * S)
            frames = np.stack([np.roll(base, 3 * t, axis=1)[:, :S]
                               for t in range(P11_VIDEO_FRAMES)])
            np.save(os.path.join(vdir, f"video{v}.npy"), frames)
        sources = video.enumerate_video_sources(vdir)
        vid = {}
        mp = resnext3d.init_resnext3d(0, device="cuda")
        for label, kw in (("rgb_diff", {}),
                          ("resnext3d", {"motion_params": mp,
                                         "motion_side": P11_MOTION_SIDE})):
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            ms = []
            tables = {}
            for name, src in sorted(sources.items()):
                t1 = time.perf_counter()
                tables.update(video.extract_videos(det, {name: src}, side=S,
                                                   **kw))
                ms.append((time.perf_counter() - t1) * 1e3)
            peak_v = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
            ok = all(t.shape == (16, 4096) and bool(np.isfinite(t).all())
                     for t in tables.values())
            log(f"extract_videos {label}: {len(tables)} videos of "
                f"{P11_VIDEO_FRAMES} x {S}x{S} frames, feat "
                f"{[list(t.shape) for t in tables.values()]} finite {ok}; "
                f"ms per video (host clock, synchronous) "
                f"{[round(x, 3) for x in ms]}; peak {peak_v:.1f} MiB above "
                f"the {held / 2 ** 20:.1f} MiB held before")
            if not ok:
                fail(f"extract_videos {label}: bad features")
            vid[label] = {"ms": ms, "peak_mib": peak_v}
        # one video's motion half by part: reading the clips, PIL's resize
        # to the clip side (host), the 3D backbone (CUDA events)
        src = sorted(sources.values())[0]
        t1 = time.perf_counter()
        clips = video.load_clips(src)
        t2 = time.perf_counter()
        sq = np.stack([video._resize_square(c, P11_MOTION_SIDE)
                       for c in clips])
        t3 = time.perf_counter()
        x = resnext3d.preprocess_clip(sq[..., ::-1])
        fn = video.make_motion_feature_fn(mp)
        _, net_ms = _events_ms(lambda: fn(x), 2)
        parts = {"load_clips_ms": (t2 - t1) * 1e3,
                 "resize_ms": (t3 - t2) * 1e3, "resnext3d_ms": net_ms}
        log(f"extract_videos resnext3d, one video by part: "
            f"{json.dumps(parts)}")
        vid["resnext3d"]["parts"] = parts
        out["video"] = vid
        del mp
    finally:
        cudnn.allow_tf32, cuda_mm.allow_tf32 = saved
        shutil.rmtree(P11_DIR, ignore_errors=True)
    log(f"phase 11: TF32 flags restored (cudnn {cudnn.allow_tf32}, matmul "
        f"{cuda_mm.allow_tf32})")
    log("phase11 " + json.dumps(out))
    del det
    torch.cuda.empty_cache()
    return out, k1, n1_main


# ---- 12. data parallelism ---------------------------------------------------

P12_RANKS = 2
P12_STEPS = 3
P12_TIMEOUT = 900
# (a)'s one-rank group; the ranks of (b)-(d) share the one card over gloo,
# since NCCL refuses two ranks on one device
P12_ONE_RANK_BACKEND = "nccl"
P12_TINY_LR = 1e-4
P12_TINY = CL_TINY           # (d)'s items per task and global batch
P12_TINY_BATCH = CL_TINY_BATCH
# the command that starts a rank of (b)-(d): this script in rank mode
RANK_CMD = None


def offset_counts():
    """K1′ and K2 launches with a Philox row offset bh0 ≠ 0 (a
    data-parallel rank past the first), counted by the wrappers."""
    from vqacl_tpu_torch.ops import fused_attention as fa

    return (fa.fused_attention_fwd_train.offset_launches,
            fa.fused_attention_bwd.offset_launches)


def _tree_diff(a, b, tree_leaves):
    """‖a − b‖ over two trees of tensors, in f32."""
    return float(sum(((x.float() - y.float()) ** 2).sum()
                     for x, y in zip(tree_leaves(a), tree_leaves(b))) ** 0.5)


def _digest(tree, tree_leaves):
    import hashlib

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def check_offset_attention(fa, B, Tq, Sk, H, dk, L, dtype, rate, text_len):
    """K1′ and K2 on the rows B … 2B − 1 of a batch of 2B with the row
    offset bh0 = B·H (a second rank's share): each output equal bit for
    bit to the same rows of one launch over all 2B rows at bh0 = 0, and
    to the plain versions at bh0 within the phase 2 tolerance; the keep
    mask the kernels draw at bh0 equal bit for bit to the plain version's
    and to rows B … of the one-launch mask. → max errors vs plain."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        2 * B, Tq, Sk, H, dk, L, dt, text_len, seed=7 + B)
    seed = torch.tensor([31337], dtype=torch.int32, device="cuda")
    bh0 = B * H
    whole_o, whole_p = fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                    seed, H, rate)
    whole_g = fa.fused_attention_bwd(q, k, v, whole_p, seed, do, H, L, rate)
    part = [t[B:] for t in (q, k, v, do, mask)]
    qp, kp, vp, dop, mp = (t.contiguous() for t in part)
    o, p = fa.fused_attention_fwd_train(qp, kp, vp, bias, mp, seed, H, rate,
                                        bh0)
    g = fa.fused_attention_bwd(qp, kp, vp, p, seed, dop, H, L, rate,
                               bh0=bh0)
    ro, rp = fa.fused_attention_fwd_train_reference(qp, kp, vp, bias, mp,
                                                    seed, H, rate, bh0)
    rg = fa.fused_attention_bwd_reference(qp, kp, vp, rp, seed, dop, H, L,
                                          rate, bh0)
    mine = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate, bh0)
    whole_mask = fa.fused_attention_keep_mask(seed, 2 * B, H, Tq, Sk, rate)
    plain = fa.philox_keep_mask(seed, B, H, Tq, Sk, rate, bh0)
    torch.cuda.synchronize()
    same = {"o": torch.equal(o, whole_o[B:]),
            "p": torch.equal(p, whole_p[B:]),
            "dq": torch.equal(g[0], whole_g[0][B:]),
            "dk": torch.equal(g[1], whole_g[1][B:]),
            "dv": torch.equal(g[2], whole_g[2][B:]),
            "mask_rows": torch.equal(mine, whole_mask[B:]),
            "mask_plain": torch.equal(mine, plain)}
    errs, oks = {}, []
    for key, a, b, tol_dt in (("o", o, ro, dtype), ("p", p, rp, "float32"),
                              ("dq", g[0], rg[0], dtype),
                              ("dk", g[1], rg[1], dtype),
                              ("dv", g[2], rg[2], dtype)):
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    log(f"offset_check: B={B} of {2 * B} Tq={Tq} Sk={Sk} H={H} dk={dk} "
        f"L={L} {dtype} rate={rate} bh0={bh0}: bit-equal to rows {B}.. of "
        f"the one launch {json.dumps(same)}; vs plain max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
    if not all(same.values()) or not all(oks):
        fail("K1'/K2 at a row offset differ from the one-launch rows or "
             "their plain versions")
    return {"same": same, "max_abs_err": errs, "kept": float(
        mine.float().mean())}


def check_head_offset_attention(fa, B, Tq, Sk, H, dk, L, dtype, rate,
                                text_len):
    """K1′ and K2 over heads H/2 … H − 1 with ``(Hc = H, h0 = H/2)`` (a
    second tensor-parallel rank's heads): o, p, dq, dk, dv, the dbias
    panel and the keep mask equal bit for bit to those heads of one launch
    over all H, and within the phase 2 tolerance of the plain versions at
    the same ``(Hc, h0)``; the mask also equal to the plain one. → the
    record (max errors vs plain)."""
    dt = getattr(torch, dtype)
    q, k, v, do, bias, mask = train_attention_inputs(
        B, Tq, Sk, H, dk, L, dt, text_len, seed=11 + B)
    seed = torch.tensor([271828], dtype=torch.int32, device="cuda")
    n = h0 = H // 2
    whole_o, whole_p = fa.fused_attention_fwd_train(q, k, v, bias, mask,
                                                    seed, H, rate)
    whole_g = fa.fused_attention_bwd(q, k, v, whole_p, seed, do, H, L, rate)
    cols = lambda t: t[..., h0 * dk:].contiguous()  # noqa: E731
    qp, kp, vp, dop = (cols(t) for t in (q, k, v, do))
    bp = bias[h0:].contiguous()
    o, p = fa.fused_attention_fwd_train(qp, kp, vp, bp, mask, seed, n, rate,
                                        Hc=H, h0=h0)
    g = fa.fused_attention_bwd(qp, kp, vp, p, seed, dop, n, L, rate, Hc=H,
                               h0=h0)
    ro, rp = fa.fused_attention_fwd_train_reference(qp, kp, vp, bp, mask,
                                                    seed, n, rate, Hc=H,
                                                    h0=h0)
    rg = fa.fused_attention_bwd_reference(qp, kp, vp, rp, seed, dop, n, L,
                                          rate, Hc=H, h0=h0)
    mine = fa.fused_attention_keep_mask(seed, B, n, Tq, Sk, rate, Hc=H,
                                        h0=h0)
    whole_mask = fa.fused_attention_keep_mask(seed, B, H, Tq, Sk, rate)
    plain = fa.philox_keep_mask(seed, B, n, Tq, Sk, rate, Hc=H, h0=h0)
    torch.cuda.synchronize()
    heads = lambda t: t.reshape(B, H, Tq, Sk)[:, h0:].reshape(  # noqa: E731
        B, n * Tq, Sk)
    same = {"o": torch.equal(o, cols(whole_o)),
            "p": torch.equal(p, heads(whole_p)),
            "dq": torch.equal(g[0], cols(whole_g[0])),
            "dk": torch.equal(g[1], cols(whole_g[1])),
            "dv": torch.equal(g[2], cols(whole_g[2])),
            "dbias": torch.equal(g[3], whole_g[3][h0:]),
            "mask_heads": torch.equal(mine, whole_mask[:, h0:]),
            "mask_plain": torch.equal(mine, plain)}
    errs, oks = {}, []
    for key, a, b, tol_dt in (("o", o, ro, dtype), ("p", p, rp, "float32"),
                              ("dq", g[0], rg[0], dtype),
                              ("dk", g[1], rg[1], dtype),
                              ("dv", g[2], rg[2], dtype),
                              ("dbias", g[3], rg[3], "float32")):
        errs[key], ok = _close(a, b, tol_dt)
        oks.append(ok)
    log(f"head_offset_check: heads {h0}..{H - 1} of {H} (Hc={H}, h0={h0}) "
        f"B={B} Tq={Tq} Sk={Sk} dk={dk} L={L} {dtype} rate={rate}: "
        f"bit-equal to those heads of the one launch {json.dumps(same)}; "
        f"vs plain max_abs_err "
        + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
    if not all(same.values()) or not all(oks):
        fail("K1'/K2 over a head slice differ from the one launch's heads "
             "or their plain versions")
    return {"same": same, "max_abs_err": errs, "heads": [h0, H],
            "kept": float(mine.float().mean())}


def p12_rank(ctx, spec):
    """The work of one rank of (b)-(d) (``rank_main``): t5-base train
    steps at the global batch over the mesh, replicated at dropout 0 and
    0.1 and under FSDP, each from the same state; on the last rank the
    kernels at its row offset; the tiny f32 CL run with the sharded device
    cache on the card and on the CPU. → a JSON-able record."""
    import numpy as np

    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vqacl_tpu_torch.parallel.multihost import barrier
    from vqacl_tpu_torch.parallel.sharding import FsdpLayout
    from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves,
                                             tree_map)
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_train_step
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    wrappers = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)

    def zero_counts():
        for w in wrappers:
            w.launches = w.strided_launches = 0
        for w in wrappers[1:]:
            w.offset_launches = 0

    def read_counts():
        return tuple(w.launches for w in wrappers)

    dev = ctx.device
    rec = {"rank": ctx.rank, "backend": ctx.backend}
    base = Config()
    m = base.model
    params0 = vlt5.init_vlt5_params(0, m, device=dev)
    proto0 = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                               device=dev)
    tx = make_transform(base.train)
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    nparams = sum(p.numel() for p in tree_leaves(params0))

    def steps(dropout, mesh, layout=None):
        cfg = Config()
        cfg.model.dropout_rate = dropout
        p = params0 if layout is None else layout.shard(params0)
        state = TrainState.create(p, tx, proto0, seed=0, warmup_iters=1.0,
                                  t_total=1000.0)
        step = make_train_step(cfg, dtype=torch.bfloat16, device=dev,
                               mesh_ctx=mesh, fsdp=layout)
        stats0 = dict(ctx.stats)
        zero_counts()
        losses, times = [], []
        for _ in range(P12_STEPS):
            b = tbatch
            if mesh is not None:
                b = shard_batch(mesh, tbatch)
                barrier("step")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        launches, offsets = read_counts(), offset_counts()
        full = state.params if layout is None else layout.gather(state.params)
        r = {"losses": losses, "step_ms": times, "launches": launches,
             "offset_launches": offsets,
             "all_reduce_bytes_per_step": (
                 ctx.stats["all_reduce_bytes"]
                 - stats0.get("all_reduce_bytes", 0)) / P12_STEPS,
             "all_reduce_calls_per_step": (
                 ctx.stats["all_reduce_calls"]
                 - stats0.get("all_reduce_calls", 0)) / P12_STEPS,
             "state_bytes": sum(x.numel() * x.element_size() for t in (
                 state.params, state.opt_state.mu, state.opt_state.nu)
                 for x in tree_leaves(t))}
        if not all(np.isfinite(losses)):
            fail(f"rank {ctx.rank}: a loss is not finite: {losses}")
        return full, r

    moved = lambda full: _tree_diff(full, params0, tree_leaves)  # noqa: E731
    # (b) dropout 0: equal across ranks, near the one-process run
    one, rec["one_process_d0"] = steps(0.0, None)
    full, rec["dp_d0"] = steps(0.0, ctx)
    rec["dp_d0"]["digest"] = _digest(full, tree_leaves)
    rec["dp_d0"]["rel_to_one"] = _tree_diff(full, one, tree_leaves) \
        / moved(one)
    del one, full
    # (b) dropout 0.1; its parameters are (c)'s reference
    ref, rec["dp_d01"] = steps(DROPOUT, ctx)
    rec["dp_d01"]["digest"] = _digest(ref, tree_leaves)
    # the gradient bucket's all_reduce alone (one flat f32 buffer)
    buf = torch.zeros(nparams, dtype=torch.float32, device=dev)
    ar = []
    for _ in range(3):
        barrier("all_reduce")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.all_reduce(buf)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    rec["all_reduce_ms"] = ar
    rec["all_reduce_buffer_bytes"] = nparams * 4
    del buf
    # (c) FSDP at dropout 0.1 from the same state
    layout = FsdpLayout(ctx, params0)
    full, rec["fsdp_d01"] = steps(DROPOUT, ctx, layout)
    rec["fsdp_d01"]["digest"] = _digest(full, tree_leaves)
    rec["fsdp_d01"]["rel_to_replicated"] = _tree_diff(full, ref,
                                                       tree_leaves) \
        / moved(ref)
    rec["fsdp_d01"]["sharded_leaves"] = sum(
        "dp" in s for s in tree_leaves(layout.specs))
    rec["fsdp_d01"]["leaves"] = len(tree_leaves(layout.specs))
    # the state bytes of the sharded leaves (f32 params, two moments)
    mom = 2 if base.train.adam_dtype in ("bfloat16", "bf16") else 4
    rec["fsdp_d01"]["sharded_state_bytes"] = sum(
        p.numel() * (4 + 2 * mom) for p, s in zip(
            tree_leaves(params0), tree_leaves(layout.specs)) if "dp" in s)
    del full, ref, layout
    torch.cuda.empty_cache()
    # the kernels at this rank's shapes and offset (comparison launches,
    # outside the counted runs)
    if ctx.rank == ctx.dp - 1 and ctx.rank > 0:
        B = TRAIN_BATCH // ctx.dp
        rec["offset_check"] = check_offset_attention(
            fa, B, m.encoder_len, m.encoder_len, m.num_heads, m.d_kv,
            m.max_text_length, "bfloat16", DROPOUT, m.max_text_length)
    # (d) the tiny f32 CL loop with the row-sharded device cache, on the
    # card and on the CPU (the same group: gloo takes both)
    tok = VLT5Tokenizer()
    tiny = {}
    for where, out in (("cuda", spec["tiny_out_cuda"]),
                       ("cpu", spec["tiny_out_cpu"])):
        mesh = ctx if where == "cuda" else make_mesh(device="cpu")
        tcl = Config()
        tcl.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0)
        tcl.train.lr = P12_TINY_LR
        tcl.train.batch_size = tcl.train.valid_batch_size = P12_TINY_BATCH
        tcl.train.epochs = 1
        tcl.train.m_size = 16
        tcl.data.device_cache = tcl.data.device_cache_sharded = True
        tcl.output = out
        tcm = tcl.model
        data = SyntheticDataModule(
            tok, tasks=CL_TASKS, n_train_per_task=P12_TINY[0],
            n_val_per_task=P12_TINY[1], n_test_per_task=P12_TINY[2],
            feat_dim=tcm.feat_dim, n_boxes=tcm.n_boxes, answer_vocab=4,
            seed=0)
        trainer = VQACLTrainer(tcl, data, tok, verbose=False,
                               init_params=vlt5.init_vlt5_params(
                                   4, tcm, device="cpu"),
                               dtype=torch.float32, mesh_ctx=mesh)
        answers = []

        def predict(loader, predict=trainer.predict):
            answers.append(predict(loader))
            return answers[-1]

        trainer.predict = predict
        r = drive_cl(trainer, f"dp_tiny_f32_{where}_rank{ctx.rank}",
                     (zero_counts, read_counts, tcm.num_layers)
                     if where == "cuda" else None)
        c = trainer._cache
        tiny[where] = {
            "result_matrix": r["result_matrix"], "losses": r["losses"],
            "answers": [{str(k): v for k, v in a.items()} for a in answers],
            "launches": r["launches"], "counts": r["counts"],
            "offset_launches": offset_counts() if where == "cuda"
            else None, "cache_rows": c.rows, "cache_n": c.n,
            "lookup_bytes": c.lookup_bytes, "lookups": c.lookups,
            "table_bytes": c.nbytes, "wall_s": r["wall_s"]}
        del trainer
    rec["tiny"] = tiny
    return rec


def rank_main(args) -> int:
    """Rank mode (``--rank``): join the group of ``--world`` ranks
    through the file store ``--store`` over gloo on the card (as the
    spec's mesh, phase 12's dp by default), run ``p12_rank`` or phase
    13's ``p13_rank`` and write its record to ``--out`` as JSON."""
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from vqacl_tpu_torch.parallel.mesh import make_mesh

    with open(args.spec) as f:
        spec = json.load(f)
    if spec.get("phase") == 14:       # a surrogate row: no group
        with open(args.out, "w") as f:
            json.dump(p14_row(spec, args.rank), f)
        return 0
    ctx = make_mesh(**spec.get("mesh", {"dp": args.world}),
                    device="cuda:0", backend="gloo",
                    init_method=f"file://{args.store}", rank=args.rank,
                    world_size=args.world, timeout_s=P12_TIMEOUT)
    rec = p13_rank(ctx, spec) if spec.get("phase") == 13 else \
        p12_rank(ctx, spec)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def run_ranks(work, tag, n, spec, echo=(), meanwhile=None):
    """Start ``n`` ranks of this script in rank mode (``RANK_CMD``) over
    one file store under ``work``, each with ``spec``; run
    ``meanwhile()`` in this process, if given (the ranks are killed if it
    fails); wait for them within ``P12_TIMEOUT`` (killing any still
    running), echo their log lines that start with ``echo`` (every log's
    tail when one failed) → (the ranks' records in rank order, seconds),
    and what ``meanwhile`` returned as a third item when given."""
    spec_path = os.path.join(work, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = RANK_CMD or [sys.executable, os.path.abspath(__file__)]
    procs, logs = [], []
    t0 = time.time()
    for r in range(n):
        logs.append(open(os.path.join(work, f"{tag}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            cmd + ["--rank", str(r), "--world", str(n), "--store",
                   os.path.join(work, f"{tag}_store"), "--spec", spec_path,
                   "--out", os.path.join(work, f"{tag}_rank{r}.json")],
            cwd=HERE, stdout=logs[-1], stderr=subprocess.STDOUT))
    if meanwhile is not None:
        try:
            extra = meanwhile()
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
    deadline = time.time() + P12_TIMEOUT
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    secs = time.time() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r, f in enumerate(logs):
        f.seek(0)
        text = f.read()
        f.close()
        if bad or hung:
            log(f"--- {tag} rank {r} (exit {procs[r].returncode}) ---\n"
                + text[-4000:])
        else:
            for line in text.splitlines():
                if line.startswith(tuple(echo)):
                    log(f"rank {r}: {line}")
    if hung:
        fail(f"{tag}: ranks {hung} still running after {P12_TIMEOUT} s")
    if bad:
        fail(f"{tag}: ranks {bad} failed")
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"{tag}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return (ranks, secs) if meanwhile is None else (ranks, secs, extra)


def data_parallel(counters):
    """Phase 12 → (record, [K1, K1′, K2] launches, [K1′, K2] offset
    launches) of its main-path runs: (a) in this process, (b)-(d) summed
    over the ranks."""
    import numpy as np
    import torch.distributed as dist

    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vqacl_tpu_torch.train.optim import make_transform, tree_leaves
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_train_step
    from vqacl_tpu_torch.utils.config import Config

    zero_counts, read_counts = counters
    rec = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    try:
        # (a) a one-rank mesh through the trainer's step path: the same
        # loss and parameters, bit for bit, as the meshless step
        ctx1 = make_mesh(dp=1, device="cuda:0",
                         backend=P12_ONE_RANK_BACKEND,
                         init_method=f"file://{work}/one", rank=0,
                         world_size=1, timeout_s=P12_TIMEOUT)
        cfg = Config()
        m = cfg.model
        params0 = vlt5.init_vlt5_params(0, m, device="cuda")
        proto0 = ProtoState.create(m.n_ques_types, m.n_categories,
                                   m.d_model, device="cuda")
        tx = make_transform(cfg.train)
        tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
            TRAIN_BATCH, seed=0))["tensors"]

        def three(mesh):
            state = TrainState.create(params0, tx, proto0, seed=0,
                                      warmup_iters=1.0, t_total=1000.0)
            step = make_train_step(cfg, dtype=torch.bfloat16,
                                   device="cuda", mesh_ctx=mesh)
            losses, times = [], []
            for _ in range(P12_STEPS):
                b = shard_batch(mesh, tbatch) if mesh is not None \
                    else tbatch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
            return state, losses, times

        zero_counts()
        s_mesh, l_mesh, t_mesh = three(ctx1)
        a_launches = list(read_counts())
        s_one, l_one, t_one = three(None)
        same = l_mesh == l_one and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(s_mesh.params),
                                              tree_leaves(s_one.params)))
        rec["one_rank"] = {"backend": ctx1.backend, "losses": l_mesh,
                           "step_ms": t_mesh, "meshless_step_ms": t_one,
                           "bit_equal": same, "launches": a_launches,
                           "all_reduce_calls": ctx1.stats[
                               "all_reduce_calls"]}
        log(f"dp_one_rank: {ctx1.backend} mesh of 1, bs {TRAIN_BATCH} bf16 "
            f"dropout {m.dropout_rate}, {P12_STEPS} steps: losses {l_mesh}, "
            f"step ms {[round(t, 3) for t in t_mesh]} (meshless "
            f"{[round(t, 3) for t in t_one]}); loss and parameters "
            f"bit-equal to the meshless step: {same}; launches "
            f"K1/K1'/K2 {a_launches}; all_reduce calls "
            f"{ctx1.stats['all_reduce_calls']}")
        if not same:
            fail("the one-rank mesh's steps differ from the meshless steps")
        want = [0, m.num_layers * P12_STEPS, m.num_layers * P12_STEPS]
        if a_launches != want:
            fail(f"dp_one_rank: launches {a_launches}, expected {want}")
        del s_mesh, s_one, params0
        dist.destroy_process_group()
        torch.cuda.empty_cache()

        # (b)-(d): the ranks, each a process of this script on the card
        spec = {"tiny_out_cuda": os.path.join(work, "tiny_cuda"),
                "tiny_out_cpu": os.path.join(work, "tiny_cpu")}
        ranks, ranks_s = run_ranks(work, "p12", P12_RANKS, spec,
                                   ("offset_check", "dp_tiny"))
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    r0, r1 = ranks[0], ranks[-1]
    L = m.num_layers
    per_rank = [0, L * P12_STEPS, L * P12_STEPS]
    # (b)
    for key in ("dp_d0", "dp_d01", "fsdp_d01"):
        digests = {r[key]["digest"] for r in ranks}
        log(f"dp_{key}: {P12_RANKS} ranks on one card over "
            f"{r0['backend']}, global batch {TRAIN_BATCH} "
            f"({TRAIN_BATCH // P12_RANKS} per rank), bf16, {P12_STEPS} steps:"
            f" losses {r0[key]['losses']}; step ms rank 0 "
            f"{[round(t, 3) for t in r0[key]['step_ms']]}, rank 1 "
            f"{[round(t, 3) for t in r1[key]['step_ms']]}; all_reduce "
            f"{r0[key]['all_reduce_bytes_per_step']:.0f} B in "
            f"{r0[key]['all_reduce_calls_per_step']:g} calls per step; "
            f"params bit-equal across ranks: {len(digests) == 1}; launches "
            f"per rank K1/K1'/K2 {[r[key]['launches'] for r in ranks]}, "
            f"offset K1'/K2 {[r[key]['offset_launches'] for r in ranks]}")
        if len(digests) != 1:
            fail(f"dp_{key}: the ranks' parameters differ")
        for r in ranks:
            if list(r[key]["launches"]) != per_rank:
                fail(f"dp_{key}: rank {r['rank']} launches "
                     f"{r[key]['launches']}, expected {per_rank}")
            want_off = per_rank[1] if r["rank"] > 0 else 0
            if list(r[key]["offset_launches"]) != [want_off, want_off]:
                fail(f"dp_{key}: rank {r['rank']} offset launches "
                     f"{r[key]['offset_launches']}, expected {want_off}")
        if r0[key]["losses"] != r1[key]["losses"] \
                or not all(np.isfinite(r0[key]["losses"])):
            fail(f"dp_{key}: the ranks' losses differ or are not finite")
    rel = r0["dp_d0"]["rel_to_one"]
    one = r0["one_process_d0"]
    log(f"dp_d0: |p_dp - p_one| / |p_one - p_0| = {rel:.3e} (tol "
        f"{GRAD_REL_TOL['bfloat16']:g}); one-process losses "
        f"{one['losses']} vs {r0['dp_d0']['losses']}; one-process step ms "
        f"{[round(t, 3) for t in one['step_ms']]}")
    if not rel <= GRAD_REL_TOL["bfloat16"]:
        fail("dp_d0: the two-rank parameters are not within phase 4's "
             "bound of the one-process run's")
    ar = sorted(r0["all_reduce_ms"])[1]
    log(f"dp all_reduce: one flat f32 bucket of "
        f"{r0['all_reduce_buffer_bytes']} B over {r0['backend']} between "
        f"two ranks on one card: {ar:.3f} ms (all: "
        f"{[round(t, 3) for t in r0['all_reduce_ms']]}); a record of the "
        f"host-staged path, not a scaling number")
    # the kernels at rank 1's offset
    off = r1["offset_check"]
    if not all(off["same"].values()):
        fail("rank 1's kernels at its offset differ from the one launch")
    # (c)
    frel = r0["fsdp_d01"]["rel_to_replicated"]
    ratio = r0["fsdp_d01"]["state_bytes"] / r0["dp_d01"]["state_bytes"]
    halves = r0["dp_d01"]["state_bytes"] \
        - r0["fsdp_d01"]["sharded_state_bytes"] // P12_RANKS
    log(f"dp_fsdp: {r0['fsdp_d01']['sharded_leaves']} of "
        f"{r0['fsdp_d01']['leaves']} leaves sharded; |p_fsdp - p_repl| / "
        f"|p_repl - p_0| = {frel:.3e} (tol {GRAD_REL_TOL['bfloat16']:g}); "
        f"param + moment bytes per rank {r0['fsdp_d01']['state_bytes']} vs "
        f"replicated {r0['dp_d01']['state_bytes']} (ratio {ratio:.4f})")
    if not frel <= GRAD_REL_TOL["bfloat16"]:
        fail("dp_fsdp: parameters not within phase 4's bound of (b)'s")
    # each sharded leaf and its moments by half, the rest whole: half of
    # the state at t5-base, where all but ~0.1 % of it shards
    if r0["fsdp_d01"]["state_bytes"] != halves or not ratio <= 0.52:
        fail(f"dp_fsdp: per-rank state bytes {r0['fsdp_d01']['state_bytes']}"
             f" (ratio {ratio:.4f}), expected {halves}")
    # (d)
    t_card, t_cpu = r0["tiny"]["cuda"], r0["tiny"]["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(t_card["losses"],
                                                        t_cpu["losses"]))
    same_tiny = {"result_matrix": t_card["result_matrix"]
                 == t_cpu["result_matrix"],
                 "answers": t_card["answers"] == t_cpu["answers"],
                 "ranks": all(r["tiny"]["cuda"]["result_matrix"]
                              == t_card["result_matrix"] for r in ranks)}
    per_lookup = t_card["lookup_bytes"] / max(t_card["lookups"], 1)
    log(f"dp_tiny_f32: VQACLTrainer ER at dp {P12_RANKS}, sharded device "
        f"cache ({t_card['cache_rows']} of {t_card['cache_n']} rows per "
        f"rank, {t_card['table_bytes']} B), card vs CPU: "
        f"{len(t_card['losses'])} / {len(t_cpu['losses'])} steps, loss max "
        f"rel err {tiny_err:.3e} (tol {CL_LOSS_RTOL:g}); equal "
        f"{json.dumps(same_tiny)}; lookup all_reduce {per_lookup:.0f} B per "
        f"lookup ({t_card['lookups']} lookups); launches rank 0 "
        f"{t_card['launches']}, rank 1 {r1['tiny']['cuda']['launches']}")
    if len(t_card["losses"]) != len(t_cpu["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same_tiny.values()):
        fail("dp_tiny_f32: the dp run on the card differs from the CPU run")
    launches = list(a_launches)
    offsets = [0, 0]
    for r in ranks:
        for key in ("dp_d0", "dp_d01", "fsdp_d01"):
            launches = [a + b for a, b in zip(launches, r[key]["launches"])]
            offsets = [a + b for a, b in zip(offsets,
                                             r[key]["offset_launches"])]
        launches = [a + b for a, b in zip(launches,
                                          r["tiny"]["cuda"]["launches"])]
        offsets = [a + b for a, b in zip(
            offsets, r["tiny"]["cuda"]["offset_launches"])]
    rec.update({
        "ranks_s": ranks_s, "backend": r0["backend"],
        "one_process_step_ms": r0["one_process_d0"]["step_ms"],
        "two_rank_step_ms": {k: [r[k]["step_ms"] for r in ranks]
                             for k in ("dp_d0", "dp_d01", "fsdp_d01")},
        "losses": {k: r0[k]["losses"] for k in ("dp_d0", "dp_d01",
                                                 "fsdp_d01")},
        "rel_to_one_process": rel, "fsdp_rel_to_replicated": frel,
        "all_reduce_ms": r0["all_reduce_ms"],
        "all_reduce_buffer_bytes": r0["all_reduce_buffer_bytes"],
        "all_reduce_bytes_per_step": r0["dp_d01"][
            "all_reduce_bytes_per_step"],
        "state_bytes": {"replicated": r0["dp_d01"]["state_bytes"],
                        "fsdp": r0["fsdp_d01"]["state_bytes"]},
        "offset_check": off,
        "tiny": {"loss_rel_err": tiny_err, "equal": same_tiny,
                 "lookup_bytes_per_lookup": per_lookup,
                 "lookups": t_card["lookups"],
                 "cache_rows": t_card["cache_rows"],
                 "launches": [r["tiny"]["cuda"]["launches"]
                              for r in ranks]}})
    return rec, launches, offsets


# ---- 13. tensor and pipeline parallelism -----------------------------------

P13_TP_STEPS = 3
P13_PP_STEPS = 2
P13_PP_MICRO = 4
# the parts, each a group of ranks on the one card over gloo: name →
# mesh axes
P13_PARTS = (("tp", {"tp": 2}), ("pp", {"pp": 2}),
             ("tppp", {"tp": 2, "pp": 2}))
# a mesh step's loss vs one process's from the same state, relative: in
# bf16 the tp partial sums are rounded to bf16 before their all_reduce
# and the one process rounds the whole product once; the pipelined
# stacks add the same terms in the same order
P13_LOSS_RTOL = 1e-2
# the parameters after the steps, as |p_mesh − p_one| / |p_one − p_0|:
# phase 4's gradient bound, as phase 12 holds its ranks (Adam divides
# each gradient entry by its own scale, so an entry near zero that the
# bf16 roundings move turns into a whole update of its parameter)
P13_PARAM_RTOL = GRAD_REL_TOL["bfloat16"]
P13_TINY = P12_TINY          # (d)'s items per task


def head_offset_counts():
    """K1′ and K2 launches with a first head h0 ≠ 0 (a tensor-parallel
    rank past the first), counted by the wrappers."""
    from vqacl_tpu_torch.ops import fused_attention as fa

    return (fa.fused_attention_fwd_train.head_offset_launches,
            fa.fused_attention_bwd.head_offset_launches)


def p13_tiny_trainer(mesh, out):
    """Phase 13's tiny f32 ER trainer (phase 12's settings) on ``mesh``:
    its tp and pp, the "tp" layout at tp > 1, ``P13_PP_MICRO``
    microbatches; ``out`` its output → (trainer, the list its predicts
    append their answers to)."""
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    tok = VLT5Tokenizer()
    tcl = Config()
    tcl.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0)
    tcl.train.lr = P12_TINY_LR
    tcl.train.batch_size = tcl.train.valid_batch_size = P12_TINY_BATCH
    tcl.train.epochs = 1
    tcl.train.m_size = 16
    tcl.mesh.tp, tcl.mesh.pp = mesh.tp, mesh.pp
    tcl.mesh.pp_micro = P13_PP_MICRO
    tcl.mesh.param_layout = "tp" if mesh.tp > 1 else "replicated"
    tcl.output = out
    tcm = tcl.model
    data = SyntheticDataModule(
        tok, tasks=CL_TASKS, n_train_per_task=P13_TINY[0],
        n_val_per_task=P13_TINY[1], n_test_per_task=P13_TINY[2],
        feat_dim=tcm.feat_dim, n_boxes=tcm.n_boxes, answer_vocab=4, seed=0)
    trainer = VQACLTrainer(tcl, data, tok, verbose=False,
                           init_params=vlt5.init_vlt5_params(4, tcm,
                                                             device="cpu"),
                           dtype=torch.float32, mesh_ctx=mesh)
    answers = []

    def predict(loader, predict=trainer.predict):
        answers.append(predict(loader))
        return answers[-1]

    trainer.predict = predict
    return trainer, answers


def p13_rank(ctx, spec):
    """The work of one rank of phase 13's part ``spec["part"]``: t5-base
    train steps at the global batch over the mesh (``ctx``: tp, pp or
    both) from the same state as a one-process run (rank 0 runs that
    too); with tp the "tp" layout (each rank its Megatron slices of the
    parameters and moments), with pp ``P13_PP_MICRO`` microbatches; in
    the tp and pp parts a tiny f32 ER run on the mesh, on the card and
    on the CPU (``tensor_pipeline`` holds it to one process's). → a
    JSON-able record."""
    import collections

    import numpy as np

    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.parallel.mesh import (MeshContext, make_mesh,
                                               shard_batch)
    from vqacl_tpu_torch.parallel.multihost import barrier
    from vqacl_tpu_torch.parallel.sharding import TpLayout
    from vqacl_tpu_torch.train.optim import make_transform, tree_leaves
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import make_train_step
    from vqacl_tpu_torch.utils.config import Config

    wrappers = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)

    def zero_counts():
        for w in wrappers:
            w.launches = w.strided_launches = 0
        for w in wrappers[1:]:
            w.offset_launches = w.head_offset_launches = 0

    def read_counts():
        return tuple(w.launches for w in wrappers)

    part, dev = spec["part"], ctx.device
    rec = {"rank": ctx.rank, "part": part, "backend": ctx.backend,
           "mesh": [ctx.dp, ctx.tp, ctx.pp],
           "index": [ctx.dp_index, ctx.tp_index, ctx.pp_stage]}
    base = Config()
    m = base.model
    params0 = vlt5.init_vlt5_params(0, m, device=dev)
    proto0 = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                               device=dev)
    tx = make_transform(base.train)
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    mom = 2 if base.train.adam_dtype in ("bfloat16", "bf16") else 4
    one_rank = MeshContext(device=dev)       # no group: one process

    def steps(dropout, mesh, n):
        """``n`` steps → (full parameters, record)."""
        cfg = Config()
        cfg.model.dropout_rate = dropout
        if mesh.pp > 1:
            cfg.model.pp_mesh, cfg.model.pp_micro = mesh, P13_PP_MICRO
        tpl = TpLayout(mesh, params0) if mesh.tp > 1 else None
        p = params0 if tpl is None else tpl.shard(params0)
        state = TrainState.create(p, tx, proto0, seed=0, warmup_iters=1.0,
                                  t_total=1000.0)
        step = make_train_step(cfg, dtype=torch.bfloat16, device=dev,
                               mesh_ctx=mesh if mesh.distributed else None,
                               tp=tpl)
        stats0 = collections.Counter(ctx.stats)
        zero_counts()
        losses, times = [], []
        for _ in range(n):
            b = tbatch
            if mesh.distributed:
                b = shard_batch(mesh, tbatch)
                barrier("step")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        delta = {k: (ctx.stats[k] - stats0.get(k, 0)) / n
                 for k in ctx.stats if k.startswith("all_reduce_")}
        full = state.params if tpl is None else tpl.gather(state.params)
        r = {"losses": losses, "step_ms": times, "launches": read_counts(),
             "offset_launches": offset_counts(),
             "head_offset_launches": head_offset_counts(),
             "all_reduce_per_step": delta,
             "state_bytes": sum(x.numel() * x.element_size() for t in (
                 state.params, state.opt_state.mu, state.opt_state.nu)
                 for x in tree_leaves(t))}
        if tpl is not None:     # the tp-sliced leaves' params and moments
            r["sharded_state_bytes"] = sum(
                x.numel() * (4 + 2 * mom) for x, d in zip(
                    tree_leaves(params0), tpl.dims) if d is not None)
        if not all(np.isfinite(losses)):
            fail(f"{part} rank {ctx.rank}: a loss is not finite: {losses}")
        return full, r

    n = P13_TP_STEPS if part == "tp" else P13_PP_STEPS
    rates = (0.0, DROPOUT) if part == "tp" else (0.0,)
    moved = lambda full: _tree_diff(full, params0, tree_leaves)  # noqa: E731
    for rate in rates:
        key = f"d{rate:g}"
        one = None
        if ctx.rank == 0:
            one, rec[f"one_{key}"] = steps(rate, one_rank, n)
        full, rec[key] = steps(rate, ctx, n)
        rec[key]["digest"] = _digest(full, tree_leaves)
        if one is not None:
            rec[key]["rel_to_one"] = _tree_diff(full, one, tree_leaves) \
                / moved(one)
        del one, full
        torch.cuda.empty_cache()
    if part == "pp":
        # the gradient bucket's all_reduce alone over dp × pp (one flat f32
        # buffer of every parameter)
        nparams = sum(p.numel() for p in tree_leaves(params0))
        buf = torch.zeros(nparams, dtype=torch.float32, device=dev)
        ar = []
        for _ in range(3):
            barrier("all_reduce")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx.all_reduce(buf, "dpp")
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        rec["bucket_ms"], rec["bucket_bytes"] = ar, nparams * 4
        mb = TRAIN_BATCH // P13_PP_MICRO
        rec["handoff_bytes"] = {
            "encoder": ctx.pp * mb * m.encoder_len * m.d_model * 2,
            "decoder": ctx.pp * mb * m.target_max_length * m.d_model * 2}
        rec["ticks"] = P13_PP_MICRO + ctx.pp - 1
        del buf
    del params0
    torch.cuda.empty_cache()
    if part == "tppp":
        return rec
    # (d) the tiny f32 ER run on the mesh, on the card and on the CPU (the
    # one-process run it is held to runs in the script's own process: a
    # trainer here would take part in the group's collectives)
    tiny = {}
    for where in ("cuda", "cpu"):
        mesh = ctx if where == "cuda" else make_mesh(tp=ctx.tp, pp=ctx.pp,
                                                     device="cpu")
        trainer, answers = p13_tiny_trainer(
            mesh, os.path.join(spec["work"], f"{part}_tiny_{where}"))
        # K1′/K2 per step (and K1 per predict batch) on a rank: its
        # stage's layers once per microbatch
        per = trainer.cfg.model.num_layers // mesh.pp \
            * (P13_PP_MICRO if mesh.pp > 1 else 1)
        r = drive_cl(trainer, f"p13_tiny_{part}_{where}_rank{ctx.rank}",
                     (zero_counts, read_counts, per)
                     if where == "cuda" else None)
        tiny[where] = {
            "result_matrix": r["result_matrix"], "losses": r["losses"],
            "answers": [{str(k): v for k, v in a.items()} for a in answers],
            "launches": r["launches"], "counts": r["counts"],
            "head_offset_launches": head_offset_counts()
            if where == "cuda" else None,
            "offset_launches": offset_counts() if where == "cuda"
            else None,
            "digest": _digest(trainer._full_params(), tree_leaves),
            "wall_s": r["wall_s"]}
        del trainer
    rec["tiny"] = tiny
    return rec


def tensor_pipeline():
    """Phase 13 → (record, [K1, K1′, K2] launches, [K1′, K2] offset
    launches, [K1′, K2] head-offset launches) of its main-path runs (the
    ranks' mesh steps and tiny mesh runs on the card), summed over the
    ranks of the three parts."""
    from vqacl_tpu_torch.parallel.mesh import MeshContext
    from vqacl_tpu_torch.train.optim import tree_leaves
    from vqacl_tpu_torch.utils.config import Config

    m = Config().model
    L = m.num_layers
    work = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    parts = {}
    try:
        for part, mesh in P13_PARTS:
            n = 1
            for v in mesh.values():
                n *= v
            ranks, secs = run_ranks(
                work, f"p13_{part}", n,
                {"phase": 13, "part": part, "mesh": mesh, "work": work},
                ("p13_tiny",))
            parts[part] = {"ranks": ranks, "s": secs}
        # (d)'s one-process run on the card, and each mesh run's last
        # checkpoint (rank 0's) loaded by that trainer
        trainer, answers = p13_tiny_trainer(
            MeshContext(device=torch.device("cuda")),
            os.path.join(work, "tiny_one"))
        r = drive_cl(trainer, "p13_tiny_one")
        one_tiny = {"result_matrix": r["result_matrix"],
                    "losses": r["losses"],
                    "answers": [{str(k): v for k, v in a.items()}
                                for a in answers], "ckpt": {}}
        for part in ("tp", "pp"):
            trainer.cfg.output = os.path.join(work, f"{part}_tiny_cuda")
            loaded, _ = trainer._load(CL_TASKS[-1])
            one_tiny["ckpt"][part] = (_digest(loaded, tree_leaves),
                                      sorted(os.listdir(trainer.cfg.output)))
        del trainer
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches, offsets, heads = [0, 0, 0], [0, 0], [0, 0]
    rec = {}
    for part, mesh in P13_PARTS:
        ranks = parts[part]["ranks"]
        tp, pp = mesh.get("tp", 1), mesh.get("pp", 1)
        n = P13_TP_STEPS if part == "tp" else P13_PP_STEPS
        r0 = ranks[0]
        out = {"ranks_s": parts[part]["s"]}
        for key in [k for k in ("d0", f"d{DROPOUT:g}") if k in r0]:
            one = r0[f"one_{key}"]
            digests = {r[key]["digest"] for r in ranks}
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                r0[key]["losses"], one["losses"]))
            rel = r0[key]["rel_to_one"]
            # K1′ and K2 per step on a rank: its stage's layers once per
            # microbatch (K1 only in eval)
            k = L // pp * (P13_PP_MICRO if pp > 1 else 1)
            per_step = [0, k, k]
            ar = r0[key]["all_reduce_per_step"]
            log(f"p13_{part}_{key}: {len(ranks)} ranks (tp {tp}, pp {pp}) "
                f"on one card over {r0['backend']}, global batch "
                f"{TRAIN_BATCH}, bf16, {n} steps"
                + (f", pp_micro {P13_PP_MICRO}" if pp > 1 else "")
                + f": losses {r0[key]['losses']} (one process "
                f"{one['losses']}, max rel err {loss_err:.3e}, tol "
                f"{P13_LOSS_RTOL:g}); |p_mesh - p_one| / |p_one - p_0| = "
                f"{rel:.3e} (tol {P13_PARAM_RTOL:g}); params "
                f"bit-equal across ranks: {len(digests) == 1}; step ms rank 0 "
                f"{[round(t, 3) for t in r0[key]['step_ms']]} (one process "
                f"{[round(t, 3) for t in one['step_ms']]}); all_reduce per "
                f"step rank 0: "
                + ", ".join(f"{g} {ar.get(f'all_reduce_{g}_bytes', 0):.0f} B "
                            f"in {ar.get(f'all_reduce_{g}_calls', 0):g}"
                            for g in ("tp", "pp", "dpp", "dp"))
                + f"; launches per rank K1/K1'/K2 "
                f"{[r[key]['launches'] for r in ranks]}, head offset "
                f"K1'/K2 {[r[key]['head_offset_launches'] for r in ranks]}, "
                f"row offset {[r[key]['offset_launches'] for r in ranks]}")
            if len(digests) != 1:
                fail(f"p13_{part}_{key}: the ranks' parameters differ")
            if not loss_err <= P13_LOSS_RTOL or not rel <= P13_PARAM_RTOL:
                fail(f"p13_{part}_{key}: not within the bounds of the "
                     f"one-process run")
            for r in ranks:
                t_idx = r["index"][1]
                want = [x * n for x in per_step]
                want_head = [per_step[1] * n] * 2 if t_idx > 0 else [0, 0]
                # under pp every microbatch past the first starts at a
                # Philox row offset
                off = per_step[1] * n * (P13_PP_MICRO - 1) // P13_PP_MICRO \
                    if pp > 1 else 0
                if list(r[key]["launches"]) != want \
                        or list(r[key]["head_offset_launches"]) != want_head \
                        or list(r[key]["offset_launches"]) != [off, off]:
                    fail(f"p13_{part}_{key}: rank {r['rank']} launches "
                         f"{r[key]['launches']}, head offsets "
                         f"{r[key]['head_offset_launches']}, offsets "
                         f"{r[key]['offset_launches']}; expected {want}, "
                         f"{want_head}, {[off, off]}")
                launches = [a + b for a, b in zip(launches,
                                                  r[key]["launches"])]
                offsets = [a + b for a, b in zip(offsets,
                                                 r[key]["offset_launches"])]
                heads = [a + b for a, b in zip(
                    heads, r[key]["head_offset_launches"])]
            out[key] = {"losses": r0[key]["losses"],
                        "one_losses": one["losses"], "loss_rel_err": loss_err,
                        "rel_to_one": rel,
                        "step_ms": [r[key]["step_ms"] for r in ranks],
                        "one_step_ms": one["step_ms"],
                        "all_reduce_per_step": ar,
                        "state_bytes": r0[key]["state_bytes"],
                        "one_state_bytes": one["state_bytes"]}
            if tp > 1:
                want_bytes = one["state_bytes"] \
                    - r0[key]["sharded_state_bytes"] // tp
                ratio = r0[key]["state_bytes"] / one["state_bytes"]
                log(f"p13_{part}_{key}: param + moment bytes per rank "
                    f"{r0[key]['state_bytes']} vs one process "
                    f"{one['state_bytes']} (ratio {ratio:.4f})")
                if r0[key]["state_bytes"] != want_bytes:
                    fail(f"p13_{part}_{key}: per-rank state bytes "
                         f"{r0[key]['state_bytes']}, expected {want_bytes}")
                out[key]["state_ratio"] = ratio
        if pp > 1 and "bucket_ms" in r0:
            bms = sorted(r0["bucket_ms"])[1]
            log(f"p13_{part}: {r0['ticks']} ticks per stack, hand-off bytes "
                f"per tick {json.dumps(r0['handoff_bytes'])}; the dp x pp "
                f"gradient bucket {r0['bucket_bytes']} B over "
                f"{r0['backend']}: {bms:.3f} ms (all "
                f"{[round(t, 3) for t in r0['bucket_ms']]}); a record of "
                f"the host-staged path, not a scaling number")
            out.update(ticks=r0["ticks"], handoff_bytes=r0["handoff_bytes"],
                       bucket_ms=r0["bucket_ms"],
                       bucket_bytes=r0["bucket_bytes"])
        if "tiny" in r0:
            t_card, t_cpu = r0["tiny"]["cuda"], r0["tiny"]["cpu"]
            t_one = one_tiny
            ckpt_digest, ckpt_files = one_tiny["ckpt"][part]
            same = {"card_cpu": t_card["result_matrix"]
                    == t_cpu["result_matrix"]
                    and t_card["answers"] == t_cpu["answers"],
                    "card_one": t_card["result_matrix"]
                    == t_one["result_matrix"]
                    and t_card["answers"] == t_one["answers"],
                    "ranks": all(r["tiny"]["cuda"]["result_matrix"]
                                 == t_card["result_matrix"] for r in ranks),
                    "checkpoint": ckpt_digest == t_card["digest"]}
            err = max(abs(a - b) / abs(b) for a, b in zip(t_card["losses"],
                                                          t_one["losses"]))
            log(f"p13_tiny_{part}: VQACLTrainer ER at tp {tp}, pp {pp} (f32, "
                f"{len(t_card['losses'])} steps) vs the CPU run and one "
                f"process on the card: loss max rel err {err:.3e} (tol "
                f"{CL_LOSS_RTOL:g}); equal {json.dumps(same)}; rank 0's "
                f"checkpoint files {ckpt_files}; "
                f"launches per rank "
                f"{[r['tiny']['cuda']['launches'] for r in ranks]}, head "
                f"offset {[r['tiny']['cuda']['head_offset_launches'] for r in ranks]}")
            if not all(same.values()) or not err <= CL_LOSS_RTOL:
                fail(f"p13_tiny_{part}: the mesh run differs from the CPU "
                     f"or the one-process run")
            for r in ranks:
                t = r["tiny"]["cuda"]
                launches = [a + b for a, b in zip(launches, t["launches"])]
                offsets = [a + b for a, b in zip(offsets,
                                                 t["offset_launches"])]
                heads = [a + b for a, b in zip(heads,
                                               t["head_offset_launches"])]
            out["tiny"] = {"equal": same, "loss_rel_err": err,
                           "launches": [r["tiny"]["cuda"]["launches"]
                                        for r in ranks]}
        rec[part] = out
    return rec, launches, offsets, heads


# ---- 14. the protocol runs -------------------------------------------------

# (a) the Table-1 surrogate's rows at seed 0 with scripts/ablation.py's
# defaults (vqacl_tpu_torch.ablation: tiny widths, f32, so K1/K1′/K2 take
# their scalar f32 route), each a process of this script in rank mode,
# side by side, the argv beyond the defaults (none), and the orderings
# the rows must show as (hi, lo, metric, margin): hi's metric at least
# lo's plus the margin (Forget: lower is better, so the vanilla row is
# hi). Each margin is about half the smallest single-seed gap of
# ABLATION.md's per-seed lines (38.2, 48.5 and 23.5 points)
P14_ROWS = ("vanilla", "er", "ours")
P14_ARGV = ()
P14_ORDERINGS = (("ours", "vanilla", "Avg_acc", 20.0),
                 ("vanilla", "ours", "Avg_forget", 25.0),
                 ("er", "vanilla", "Avg_acc", 10.0))
# (b) the "ours" row cut short, on the card and on the CPU from one init
# at dropout 0: its argv, and the lr at which its per-step losses are
# held to CL_LOSS_RTOL. At the surrogate's own lr of 1e-2 the training
# amplifies f32 rounding: on the CPU alone a 1e-7 relative change of the
# init moves the cut row's losses by up to ~5e-4 within its 17 steps, at
# 1e-3 by ~1e-7 (tests/test_torch_ablation.py::
# test_cut_row_amplifies_rounding_at_the_surrogates_lr). So at 1e-2 the
# card and the CPU must give the same result matrix, answers and metrics,
# and at 1e-3 also the same losses within CL_LOSS_RTOL
P14_CUT_ARGV = ("--tasks", "2", "--n_train", "64", "--epochs", "1")
P14_CUT_LR = 1e-3
P14_DIR = os.path.join(HERE, "build", "chip_smoke", "phase14")


def p14_orderings(rows):
    """[(text, holds)] for each (hi, lo, metric, margin) of
    ``P14_ORDERINGS`` over ``rows`` ({row: its cell})."""
    out = []
    for hi, lo, metric, margin in P14_ORDERINGS:
        a, b = rows[hi][metric], rows[lo][metric]
        out.append((f"{hi} {metric} {a:.3f} >= {lo} {b:.3f} + {margin:g} "
                    f"(gap {a - b:+.3f})", bool(a - b >= margin)))
    return out


def p14_matrix_complete(matrix, n_tasks):
    """True when the lower triangle of ``matrix`` (row i: the test after
    task i) holds n(n+1)/2 evaluated, finite cells and nothing above it
    was evaluated."""
    import numpy as np

    m = np.asarray(matrix, dtype=np.float64)
    if m.shape != (n_tasks, n_tasks) or not np.isfinite(m).all():
        return False
    low = np.tril_indices(n_tasks)
    return bool((m[low] >= 0).all()
                and (m[np.triu_indices(n_tasks, 1)] == -1).all())


def attention_counters():
    """(zero_counts, read_counts) over K1, K1′ and K2's wrappers."""
    from vqacl_tpu_torch.ops import fused_attention as fa

    ws = (fa.fused_attention, fa.fused_attention_fwd_train,
          fa.fused_attention_bwd)

    def zero_counts():
        for w in ws:
            w.launches = w.strided_launches = 0
            w.route_launches = dict.fromkeys(fa.ROUTE_NAMES, 0)

    return zero_counts, lambda: tuple(w.launches for w in ws)


def p14_on_route(label, rec, route):
    """Every launch of the run just read (``rec["launches"]``) on
    ``route`` ("scalar" or "mma"): the wrappers' ``route_launches``."""
    from vqacl_tpu_torch.ops import fused_attention as fa

    routes = [dict(w.route_launches) for w in (
        fa.fused_attention, fa.fused_attention_fwd_train,
        fa.fused_attention_bwd)]
    rec["route_launches"] = routes
    log(f"{label}: launches by route K1 {routes[0]} K1' {routes[1]} "
        f"K2 {routes[2]}")
    if [r[route] for r in routes] != list(rec["launches"]):
        fail(f"{label}: not every launch on the {fa.ROUTE_NAMES[route]} "
             f"route: {routes}")


def p14_cell(name, a, label, counters=None, **kw):
    """One surrogate cell through ``ablation.run_row``, driven by
    ``drive_cl`` (with ``counters``: (zero_counts, read_counts), the
    launches checked against the counts) → (its result, drive_cl's
    record with the answers of every predict)."""
    from vqacl_tpu_torch import ablation

    sw = dict(ablation.ROWS)[name]
    recs = {}

    def drive(trainer):
        answers = []

        def predict(loader, predict=trainer.predict):
            answers.append(predict(loader))
            return answers[-1]

        trainer.predict = predict
        recs["rec"] = drive_cl(trainer, label, None if counters is None else
                               (*counters, trainer.cfg.model.num_layers))
        recs["rec"]["answers"] = answers
        return recs["rec"]["metrics"]

    t0 = time.perf_counter()
    res = ablation.run_row(name, sw["memory"], sw["prototype"], a,
                           seed=a.seed, cl_reg=sw.get("cl_reg", "none"),
                           memloss=sw.get("memloss", False), drive=drive,
                           **kw)
    res["wall_s"] = time.perf_counter() - t0
    return res, recs["rec"]


def p14_row(spec, rank):
    """Rank mode, phase 14 (a): surrogate row ``spec["rows"][rank]`` at
    seed 0 on the card, its launches checked → its record."""
    from vqacl_tpu_torch import ablation

    torch.set_num_threads(1)       # a tiny f32 row: the host's dispatch
    name = spec["rows"][rank]
    a = ablation.parse_args(["--device", "cuda", "--out",
                             os.path.join(spec["work"], name),
                             *spec["argv"]])
    res, rec = p14_cell(name, a, f"p14_{name}", attention_counters())
    p14_on_route(f"p14_{name}", rec, "scalar")
    log(f"p14_{name}: Avg_acc {res['Avg_acc']} Avg_forget "
        f"{res['Avg_forget']} diag_acc {res['diag_acc']} wall "
        f"{res['wall_s']:.3f} s; launches K1/K1'/K2 "
        f"{'/'.join(map(str, rec['launches']))}")
    return {**res, **{k: rec[k] for k in (
        "launches", "expected_launches", "counts", "route_launches",
        "train_step_ms_median", "predict_batch_ms_median", "wall_share")}}


def p14_cut(counters):
    """Phase 14 (b): the cut "ours" row on the card and on the CPU from one
    init at dropout 0, at the surrogate's lr and at ``P14_CUT_LR`` →
    (record, [K1, K1′, K2] launches on the card)."""
    from vqacl_tpu_torch import ablation
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.utils.config import tiny_model_config

    cut = ablation.parse_args(["--out", os.path.join(P14_DIR, "cut"),
                               *P14_CUT_ARGV])
    init = vlt5.init_vlt5_params(cut.seed, tiny_model_config(
        vocab_size=32200), device="cpu")
    out, k = {}, [0, 0, 0]
    for lr in (None, P14_CUT_LR):
        tag = "surrogate_lr" if lr is None else f"lr_{lr:g}"
        runs = {}
        for dev in ("cuda", "cpu"):
            cut.device = dev
            label = f"p14_cut_ours_{tag}_{dev}"
            runs[dev] = p14_cell("ours", cut, label, counters
                                 if dev == "cuda" else None,
                                 init_params=init, dropout_rate=0.0, lr=lr)
            if dev == "cuda":
                p14_on_route(label, runs[dev][1], "scalar")
        (card_res, card), (cpu_res, cpu) = runs["cuda"], runs["cpu"]
        k = [x + y for x, y in zip(k, card["launches"])]
        err = max(abs(x - y) / abs(y) for x, y in zip(card["losses"],
                                                       cpu["losses"]))
        metrics = ("Avg_acc", "Avg_forget", "diag_acc")
        same = {"steps": len(card["losses"]) == len(cpu["losses"]),
                "result_matrix": card["result_matrix"]
                == cpu["result_matrix"],
                "answers": card["answers"] == cpu["answers"],
                "metrics": [card_res[m] for m in metrics]
                == [cpu_res[m] for m in metrics]}
        held = lr is not None
        if held:
            same["losses"] = err <= CL_LOSS_RTOL
        log(f"p14 cut ours row ({' '.join(P14_CUT_ARGV)}, lr "
            f"{'1e-2 (the surrogate' + chr(39) + 's)' if lr is None else f'{lr:g}'}"
            f", dropout 0, one init), card vs CPU: {len(card['losses'])} / "
            f"{len(cpu['losses'])} steps, loss max rel err {err:.3e}"
            + (f" (tol {CL_LOSS_RTOL:g})" if held else
               " (recorded: rounding amplified at this lr)")
            + f"; equal: {json.dumps(same)}; Avg_acc {card_res['Avg_acc']}"
            f" / {cpu_res['Avg_acc']}; wall {card_res['wall_s']:.3f} / "
            f"{cpu_res['wall_s']:.3f} s")
        out[tag] = {"loss_rel_err": err, "equal": same,
                    "launches": card["launches"], "counts": card["counts"],
                    "expected_launches": card["expected_launches"],
                    "card": card_res, "cpu": cpu_res}
        if not all(same.values()):
            fail(f"p14: the cut ours row ({tag}) on the card differs from "
                 f"the CPU run")
    return out, k


def p14_soak(counters):
    """Phase 14 (c): the small soak at t5-base through
    ``vqacl_tpu_torch.soak.run`` → (record, [K1, K1′, K2] launches)."""
    import numpy as np

    from vqacl_tpu_torch import soak

    zero_counts, read_counts = counters
    zero_counts()
    t0 = time.perf_counter()
    srec = soak.run(full=False, out=os.path.join(P14_DIR, "soak"),
                    device="cuda", verbose=False)
    srec["phase_s"] = time.perf_counter() - t0
    srec["launches"] = list(read_counts())
    n = len(srec["task_wall_s"])
    complete = p14_matrix_complete(srec["result_matrix"], n)
    log(f"p14 soak: {n} tasks, {n * (n + 1) // 2}-cell matrix complete "
        f"{complete}, Avg_acc {srec['Avg_acc']} Avg_forget "
        f"{srec['Avg_forget']}, launches {srec['launches']} (expected "
        f"{srec['expected_launches']}), {srec['phase_s']:.3f} s")
    p14_on_route("p14_soak", srec, "mma")
    if not complete or not np.isfinite([srec["Avg_acc"],
                                        srec["Avg_forget"]]).all():
        fail(f"p14 soak: the matrix or metrics are not complete and "
             f"finite: {srec['result_matrix']}")
    if srec["launches"] != srec["expected_launches"] \
            or min(srec["launches"]) <= 0:
        fail(f"p14 soak: launches {srec['launches']}, expected "
             f"{srec['expected_launches']}, each above zero")
    rec = {k: v for k, v in srec.items() if k != "result_matrix"}
    rec["matrix_complete"] = complete
    return rec, srec["launches"]


def protocol_runs(counters):
    """Phase 14: the Table-1 surrogate's rows (each a process of this
    script in rank mode) and meanwhile one cut row on the card against the
    CPU, then the small soak alone, through the modules a user runs
    (``vqacl_tpu_torch.ablation``, ``vqacl_tpu_torch.soak``).
    ``counters``: (zero_counts, read_counts). → (record, [K1, K1′, K2]
    launches)."""
    shutil.rmtree(P14_DIR, ignore_errors=True)
    os.makedirs(P14_DIR)
    log(f"p14 surrogate: rows {list(P14_ROWS)}, seed 0, the surrogate's "
        f"defaults{' with ' + ' '.join(P14_ARGV) if P14_ARGV else ''} "
        f"(f32, tiny widths), one process each, side by side with (b)")
    spec = {"phase": 14, "rows": list(P14_ROWS), "argv": list(P14_ARGV),
            "work": P14_DIR}
    ranks, secs, (cut, cut_k) = run_ranks(
        P14_DIR, "p14_rows", len(P14_ROWS), spec, echo=("p14_",),
        meanwhile=lambda: p14_cut(counters))
    rows = dict(zip(P14_ROWS, ranks))
    orderings = p14_orderings(rows)
    for text, holds in orderings:
        log(f"p14 ordering: {text} -> {'ok' if holds else 'FAILS'}")
    log(f"p14 surrogate rows in {secs:.1f} s (side by side)")
    if not all(h for _, h in orderings):
        fail("p14: the surrogate's rows do not show the Table-1 orderings")
    soak, soak_k = p14_soak(counters)
    p14_k = [sum(r["launches"][i] for r in ranks) + cut_k[i] + soak_k[i]
             for i in range(3)]
    shutil.rmtree(P14_DIR, ignore_errors=True)
    log(f"phase 14 launches K1={p14_k[0]} K1'={p14_k[1]} K2={p14_k[2]}")
    return {"surrogate": {"rows": rows, "orderings": orderings,
                          "rows_s": secs},
            "cut": cut, "soak": soak}, p14_k


def main(argv=None) -> int:
    global BASE_CSRC
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", metavar="DIR",
                    help="another checkout: time its kernels beside these "
                         "(phases 1-2 only)")
    # rank mode: one rank of phase 12's group, started by the script itself
    for name, kind in (("--rank", int), ("--world", int), ("--store", str),
                       ("--spec", str), ("--out", str)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vqacl_tpu_torch")):
        print("chip_smoke: run from a checkout (vqacl_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args)
    if args.base:
        BASE_CSRC = os.path.join(os.path.abspath(args.base),
                                 "vqacl_tpu_torch", "csrc")
        if not os.path.isdir(BASE_CSRC):
            print(f"chip_smoke: --base {args.base}: no vqacl_tpu_torch/csrc",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from vqacl_tpu_torch.cl.comp_trainer import CompVQACLTrainer
    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.collate import collate
    from vqacl_tpu_torch.data.features import MemoryFeatureStore
    from vqacl_tpu_torch.data.synthetic import SyntheticVQA
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import vlt5
    from vqacl_tpu_torch.models.convert import to_device
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch import mm_bench
    from vqacl_tpu_torch.ops import _build, dw, nms
    from vqacl_tpu_torch.ops import fused_attention as fa
    from vqacl_tpu_torch.serve import VQAPredictor, VQAServer
    from vqacl_tpu_torch.train.optim import (make_transform, tree_leaves,
                                             tree_map)
    from vqacl_tpu_torch.train.state import TrainState
    from vqacl_tpu_torch.train.step import (make_eval_step,
                                            make_loss_eval_step,
                                            make_train_step)
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    counters = (fa.fused_attention, fa.fused_attention_fwd_train,
                fa.fused_attention_bwd)

    def zero_counts():
        for c in counters:
            c.launches = 0
            c.strided_launches = 0
            c.route_launches = dict.fromkeys(fa.ROUTE_NAMES, 0)
        for c in counters[1:]:
            c.offset_launches = c.head_offset_launches = 0

    def read_counts():
        return tuple(c.launches for c in counters)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    libs = _build.build()
    if BASE_CSRC is not None:
        base_libs = _build.build(
            [n for n in _build.SIGNATURES
             if os.path.exists(os.path.join(BASE_CSRC, f"{n}.cu"))],
            csrc=BASE_CSRC)
        log(f"base: {BASE_CSRC}, {len(base_libs)} kernel libraries")
    log(f"build: {len(libs)} kernel libraries in {time.time() - t0:.1f} s")

    # ---- 2. kernel check ------------------------------------------------
    cfg = Config()
    m = cfg.model
    H, dk, L = m.num_heads, m.d_kv, m.max_text_length
    S = m.encoder_len
    k1 = check_attention(fa, "eval_shape", EVAL_BATCH, S, S, H, dk, L,
                         "bfloat16", text_len=L, timed=True)
    # the CL loop's DER capture runs K1 at the train batch
    check_attention(fa, "capture_shape", TRAIN_BATCH, S, S, H, dk, L,
                    "bfloat16", text_len=L)
    check_attention(fa, "rect_f32", 8, 10, 58, H, dk, 0, "float32")
    check_attention(fa, "rect_bf16_bias", 16, 19, 37, H, dk, 7,
                    "bfloat16")
    check_attention(fa, "decoder_self_f32", 8, 10, 10, H, dk, 10,
                    "float32")
    check_attention(fa, "odd_width_f32", 3, 13, 29, 4, 8, 5,
                    "float32")
    k1p = k2 = None
    for rate in (0.0, DROPOUT):
        rows = check_train_attention(fa, "train_shape", TRAIN_BATCH, S, S, H,
                                     dk, L, "bfloat16", rate, text_len=L,
                                     timed=rate == DROPOUT)
        if rate == DROPOUT:
            k1p, k2 = rows
        check_train_attention(fa, "rect_f32_L0", 8, 10, 58, H, dk, 0,
                              "float32", rate)
        check_train_attention(fa, "rect_bf16_bias", 16, 19, 37, H, dk, 7,
                              "bfloat16", rate)
        check_train_attention(fa, "odd_width_f32", 3, 13, 29, 4, 8, 5,
                              "float32", rate)
        check_train_attention(fa, "decoder_self_causal_f32", 8, 10, 10, H,
                              dk, 10, "float32", rate, causal=True)
        check_train_attention(fa, "decoder_self_causal_bf16", 16, 10, 10,
                              H, dk, 10, "bfloat16", rate, causal=True)
        check_train_attention(fa, "decoder_cross_bf16_L0", 16, 10, S + 2, H,
                              dk, 0, "bfloat16", rate, text_len=L)
        for (name, *shape, L_) in BF16_EDGES:
            check_train_attention(fa, name, *shape, L_, "bfloat16", rate,
                                  text_len=L_)
    for (name, *shape, L_) in BF16_EDGES:
        check_attention(fa, name, *shape, L_, "bfloat16", text_len=L_)
    check_refused(fa)
    # a second tensor-parallel rank's heads at the train shape (phase 13)
    head_off = check_head_offset_attention(fa, TRAIN_BATCH, S, S, H, dk, L,
                                           "bfloat16", DROPOUT, text_len=L)
    # NExT-QA's encoder (phase 10): 23 text + 16 clip positions, a
    # [H,23,23] bias; K1 at the eval batch, K1′ and K2 at the train batch,
    # dense and on merged q|k|v views (the trainer runs merged)
    NQ_L, NQ_S = 23, 23 + 16
    nq_k1 = check_attention(fa, "nextqa_eval_shape", EVAL_BATCH, NQ_S, NQ_S,
                            H, dk, NQ_L, "bfloat16", text_len=NQ_L,
                            timed=True)
    check_strided(fa, "nextqa_eval_shape", EVAL_BATCH, NQ_S, NQ_S, H, dk,
                  NQ_L, "bfloat16", 0.0, "self")
    nq_k1p = nq_k2 = None
    for rate in (0.0, DROPOUT):
        rows = check_train_attention(fa, "nextqa_train_shape", TRAIN_BATCH,
                                     NQ_S, NQ_S, H, dk, NQ_L, "bfloat16",
                                     rate, text_len=NQ_L,
                                     timed=rate == DROPOUT)
        if rate == DROPOUT:
            nq_k1p, nq_k2 = rows
        check_strided(fa, "nextqa_train_shape", TRAIN_BATCH, NQ_S, NQ_S, H,
                      dk, NQ_L, "bfloat16", rate, "self")
    # the Table-1 surrogate's encoder (phase 14): tiny widths in f32, 4
    # heads of 8, 6 text + 4 box positions, a [4,6,6] bias, batch 16
    tm = tiny_model_config()
    sur = (16, tm.encoder_len, tm.encoder_len, tm.num_heads, tm.d_kv,
           tm.max_text_length)
    check_attention(fa, "surrogate_f32", *sur, "float32",
                    text_len=tm.max_text_length)
    for rate in (0.0, DROPOUT):
        check_train_attention(fa, "surrogate_f32", *sur, "float32", rate,
                              text_len=tm.max_text_length)
    # the fused decoder's shapes at the train batch (K4): K1′/K2 with
    # dropout in training, K1 in the loss-eval step
    T = m.target_max_length
    dec_rows = {
        "self": check_train_attention(
            fa, "decoder_self_train", TRAIN_BATCH, T, T, H, dk, T,
            "bfloat16", DROPOUT, causal=True, timed=True),
        "cross": check_train_attention(
            fa, "decoder_cross_train", TRAIN_BATCH, T, S + 2, H, dk, 0,
            "bfloat16", DROPOUT, text_len=L, timed=True),
        "self_eval": check_attention(
            fa, "decoder_self_eval", TRAIN_BATCH, T, T, H, dk, T,
            "bfloat16", timed=True),
        "cross_eval": check_attention(
            fa, "decoder_cross_eval", TRAIN_BATCH, T, S + 2, H, dk, 0,
            "bfloat16", text_len=L, timed=True)}
    # K5: the ladder from the smallest shape up, the probe's shape (timed),
    # the odd shapes (wgmma and mma routes, and f32), the f32 probe
    for shape in DW_LADDER:
        check_dw(dw, "dw_ladder", *shape, "bfloat16")
    k5 = check_dw(dw, "dw_probe", *DW_PROBE, "bfloat16", timed=True)
    if k5["route"] != "wgmma":
        fail(f"dw_probe took the {k5['route']} route, not wgmma")
    for shape in DW_ODD:
        for dname in ("bfloat16", "float32"):
            check_dw(dw, "dw_odd", *shape, dname)
    check_dw(dw, "dw_probe_f32", *DW_PROBE, "float32")
    # N1 at the RPN's and the sweep's shapes, with nothing valid, and a
    # sweep that even IoU 0.9 leaves short of 36 boxes
    n1 = check_nms(nms, "nms_rpn", *NMS_RPN, timed=True)
    n1_sweep = check_nms(nms, "nms_sweep", *NMS_SWEEP, timed=True, seed=1)
    check_nms(nms, "nms_all_invalid", NMS_SWEEP[0], NMS_RPN[1],
              NMS_SWEEP[0], seed=2)
    scarce = check_nms(nms, "nms_sweep_scarce", *NMS_SWEEP, clusters=12,
                       seed=3)
    if not scarce["kept"][-1] < 36:
        fail(f"nms_sweep_scarce keeps {scarce['kept']}: not scarce")
    if BASE_CSRC is not None:
        keys = ("ms", "base_ms", "call_ms", "base_call_ms", "bound_ms")
        pick_ab = lambda r: {k: r[k] for k in keys if k in r}
        log("ab " + json.dumps({
            "base": BASE_CSRC, "card": card,
            "K1 eval": pick_ab(k1), "K1' train": pick_ab(k1p),
            "K2 train": pick_ab(k2),
            "K1' decoder self": pick_ab(dec_rows["self"][0]),
            "K1' decoder cross": pick_ab(dec_rows["cross"][0]),
            "K2 decoder self": pick_ab(dec_rows["self"][1]),
            "K2 decoder cross": pick_ab(dec_rows["cross"][1]),
            "K1 decoder self": pick_ab(dec_rows["self_eval"]),
            "K1 decoder cross": pick_ab(dec_rows["cross_eval"]),
            "K1 nextqa eval": pick_ab(nq_k1),
            "K1' nextqa train": pick_ab(nq_k1p),
            "K2 nextqa train": pick_ab(nq_k2),
            "N1 rpn": pick_ab(n1), "N1 sweep": pick_ab(n1_sweep),
            "K5 probe": pick_ab(k5)}))
        return 0

    # ---- 3. the slice at t5-base -----------------------------------------
    t0 = time.time()
    params = vlt5.init_vlt5_params(0, m, device="cuda")
    # without this a random decoder keeps predicting its start token (pad)
    params["shared"][m.pad_token_id] = 0.0
    cast = vlt5.cast_params_for_inference(params, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cuda")
    proto = proto._replace(
        q_proto=torch.randn(m.n_ques_types, m.d_model, generator=g,
                            device="cuda"),
        v_proto=torch.randn(m.n_categories, m.d_model, generator=g,
                            device="cuda"))
    pool = SyntheticVQA(EVAL_BATCH, seed=0)
    batch = collate(pool.examples, with_targets=False)["tensors"]
    log(f"slice: t5-base random init + cast in {time.time() - t0:.1f} s")

    ev = make_eval_step(cfg, dtype=torch.bfloat16, device="cuda")
    tokens = ev(cast, proto, batch)             # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for _ in range(EVAL_STEPS):
        t0 = time.perf_counter()
        tokens = ev(cast, proto, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    eval_launches, eval_k1p, eval_k2 = read_counts()
    per_step = eval_launches / EVAL_STEPS
    eval_step_ms = sorted(times)[len(times) // 2]
    log(f"eval_step: bs {EVAL_BATCH} bf16 eval_step_ms={eval_step_ms:.3f} "
        f"(all: {', '.join(f'{t:.3f}' for t in times)}) "
        f"fused_attention launches={eval_launches} ({per_step:g}/step)")
    if eval_launches != m.num_layers * EVAL_STEPS:
        fail(f"expected {m.num_layers} kernel launches per eval step, got "
             f"{per_step:g}")
    if eval_k1p or eval_k2:
        fail(f"the eval step launched K1' {eval_k1p} and K2 {eval_k2} times")

    tok = tokens.cpu().numpy()
    T = m.gen_max_length - 1
    if tok.shape != (EVAL_BATCH, T) or tok.dtype != np.int32 \
            or tok.min() < 0 or tok.max() >= m.vocab_size:
        fail(f"eval tokens {tok.dtype} {tok.shape} "
             f"range [{tok.min()}, {tok.max()}]")
    for row in tok:
        hit = np.flatnonzero(row == m.eos_token_id)
        if hit.size and (row[hit[0] + 1:] != m.pad_token_id).any():
            fail(f"tokens after EOS are not pad: {row}")
    log(f"eval tokens: {len(np.unique(tok))} distinct ids, rows with EOS "
        f"{int((tok == m.eos_token_id).any(axis=1).sum())}/{EVAL_BATCH}, "
        f"first rows {tok[:2, :6].tolist()}")

    # encoder through the kernel vs the unfused plain-attention encoder
    dev_batch = {k: torch.from_numpy(batch[k]).cuda()
                 for k in ("input_ids", "vis_feats", "boxes")}
    with torch.inference_mode():
        h_k, _ = vlt5.encode(cast, m, **dev_batch, dtype=torch.bfloat16)
        m_plain = Config().model
        m_plain.fused_attention = False
        h_p, _ = vlt5.encode(cast, m_plain, **dev_batch,
                             dtype=torch.bfloat16)
    enc_err = float((h_k.float() - h_p.float()).abs().max())
    enc_scale = float(h_p.float().abs().max())
    enc_rel = enc_err / enc_scale
    cfg_plain = Config()
    cfg_plain.model = m_plain
    tok_plain = make_eval_step(cfg_plain, dtype=torch.bfloat16,
                               device="cuda")(cast, proto, batch)
    rows_equal = float((tok_plain.cpu().numpy() == tok).all(axis=1).mean())
    log(f"encoder: kernel vs plain attention max_abs_err={enc_err:.4e} "
        f"max|plain|={enc_scale:.4e} rel={enc_rel:.3e} (tol 3e-2); "
        f"decoded rows equal {rows_equal:.3f} (tol >= 0.9)")
    if not enc_rel <= 3e-2:
        fail("encoder output through the kernel disagrees with plain")
    if rows_equal < 0.9:
        fail("decoded tokens through the kernel disagree with plain")

    # small-input reference: f32 tokens on the card == CPU plain path
    tiny = Config()
    tiny.model = tiny_model_config(vocab_size=32200)
    tp_cpu = vlt5.init_vlt5_params(3, tiny.model, device="cpu")
    tp_cpu["shared"][tiny.model.pad_token_id] = 0.0
    tproto = ProtoState.create(tiny.model.n_ques_types,
                               tiny.model.n_categories, tiny.model.d_model,
                               device="cpu")
    tb = collate(SyntheticVQA(8, seed=2, feat_dim=tiny.model.feat_dim,
                              n_boxes=tiny.model.n_boxes,
                              text_len=tiny.model.max_text_length).examples,
                 max_text_length=tiny.model.max_text_length,
                 n_boxes=tiny.model.n_boxes, feat_dim=tiny.model.feat_dim,
                 with_targets=False)["tensors"]
    tok_cpu = make_eval_step(tiny, dtype=torch.float32, device="cpu")(
        tp_cpu, tproto, tb).numpy()
    tok_gpu = make_eval_step(tiny, dtype=torch.float32, device="cuda")(
        to_device(tp_cpu, "cuda"), tproto.to("cuda"), tb).cpu().numpy()
    log(f"small f32 reference: card tokens == CPU plain tokens: "
        f"{bool((tok_cpu == tok_gpu).all())} ({tok_gpu[:2].tolist()})")
    if not (tok_cpu == tok_gpu).all():
        fail("f32 tokens on the card differ from the CPU plain path")

    del cast, h_k, h_p
    torch.cuda.empty_cache()

    # ---- 4. the training slice at t5-base ---------------------------------
    tcfg = Config()
    tm_ = tcfg.model
    t0 = time.time()
    tparams = vlt5.init_vlt5_params(0, tm_, device="cuda")
    tx = make_transform(tcfg.train)
    tproto0 = ProtoState.create(tm_.n_ques_types, tm_.n_categories,
                                tm_.d_model, device="cuda")
    tbatch = next(SyntheticVQA(2 * TRAIN_BATCH, seed=0).batches(
        TRAIN_BATCH, seed=0))["tensors"]
    gb = {k: torch.from_numpy(v).cuda() for k, v in tbatch.items()}
    log(f"train: t5-base f32 master weights, bf16 compute, dropout "
        f"{tm_.dropout_rate}, batch {TRAIN_BATCH}, lr {tcfg.train.lr}, "
        f"adam {tcfg.train.adam_impl}/{tcfg.train.adam_dtype}; set-up "
        f"{time.time() - t0:.1f} s")

    def drive_train(run_cfg, label, per_step):
        """TRAIN_WARMUP + TRAIN_STEPS train steps on one batch from the
        seeded init; checks the launches per step (K1 0, K1′ and K2
        ``per_step``), finite metrics, a falling loss → (state, record)."""
        # warm-up of one step: step 0 is HF's zero update, every later
        # step runs at the configured lr
        state = TrainState.create(tparams, tx, tproto0, seed=0,
                                  warmup_iters=1.0, t_total=1000.0)
        step = make_train_step(run_cfg, dtype=torch.bfloat16, device="cuda")
        all_metrics = []
        for _ in range(TRAIN_WARMUP):
            state, met = step(state, tbatch)
            all_metrics.append({k: float(v) for k, v in met.items()})
        torch.cuda.synchronize()
        zero_counts()
        ttimes = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, met = step(state, tbatch)
            torch.cuda.synchronize()
            ttimes.append((time.perf_counter() - t0) * 1e3)
            all_metrics.append({k: float(v) for k, v in met.items()})
        k1, k1p, k2 = read_counts()
        losses = [mt["loss"] for mt in all_metrics]
        ms = sorted(ttimes)[len(ttimes) // 2]
        log(f"{label}: bs {TRAIN_BATCH} bf16 train_step_ms={ms:.3f} (all: "
            f"{', '.join(f'{t:.3f}' for t in ttimes)}) launches over "
            f"{TRAIN_STEPS} steps: K1={k1} K1'={k1p} K2={k2}")
        log(f"{label} losses: {', '.join(f'{x:.4f}' for x in losses)}; last "
            f"metrics {json.dumps(all_metrics[-1])}")
        if not all(np.isfinite(v) for mt in all_metrics for v in mt.values()):
            fail(f"{label}: a train-step metric is not finite")
        if (k1, k1p, k2) != (0, per_step * TRAIN_STEPS,
                             per_step * TRAIN_STEPS):
            fail(f"{label}: expected 0 K1 and {per_step} K1'/K2 launches per "
                 f"train step, got {k1}/{k1p}/{k2} over {TRAIN_STEPS} steps")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail(f"{label}: the loss did not fall on a fixed batch: {losses}")
        if float(state.step) != TRAIN_WARMUP + TRAIN_STEPS:
            fail(f"{label}: train state step {int(state.step)}")
        return state, {"train_step_ms": ms, "train_step_ms_all": ttimes,
                       "losses": losses, "launches": (k1, k1p, k2)}

    def grad_check(params, m_kernel, m_plain, what):
        """Parameter gradients at dropout 0, kernels vs plain attention,
        in bf16 at the train batch and in f32 at batch 8."""
        rel = {}
        for dname, nb in (("bfloat16", TRAIN_BATCH), ("float32", 8)):
            dtp = getattr(torch, dname)
            part = {k: v[:nb] for k, v in gb.items()}
            lf, gf = _grads(vlt5, tree_leaves, tree_map, params, m_kernel,
                            part, tproto0, dtp)
            lu, gu = _grads(vlt5, tree_leaves, tree_map, params, m_plain,
                            part, tproto0, dtp)
            rel[dname] = float((gf - gu).norm() / gu.norm())
            log(f"grad check {what} {dname} bs {nb}: loss kernel {lf:.6f} "
                f"plain {lu:.6f}; |g_kernel - g_plain| / |g_plain| = "
                f"{rel[dname]:.3e} (tol {GRAD_REL_TOL[dname]:g})")
            if not rel[dname] <= GRAD_REL_TOL[dname]:
                fail(f"{dname} gradients through the kernels disagree with "
                     f"the {what}")
            del gf, gu
        return rel

    def small_train_reference(fused_decoder):
        """Three f32 train steps of a tiny config on the card == the CPU
        plain path (dropout 0). cuBLAS and the CPU sum in other orders,
        and the Adam direction m/(√v+ε) magnifies that for gradient
        entries near ε, so parameters are held to 3 % of one lr-1e-3
        update (a wrong gradient or Adam term moves them by a whole
        update) → (loss rel err, param max abs err)."""
        small = Config()
        small.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0,
                                        fused_decoder=fused_decoder)
        small.train.lr = 1e-3
        sm = small.model
        sp = vlt5.init_vlt5_params(5, sm, device="cpu")
        spro = ProtoState.create(sm.n_ques_types, sm.n_categories,
                                 sm.d_model, device="cpu")
        sbatches = [b["tensors"] for b in SyntheticVQA(
            24, seed=6, feat_dim=sm.feat_dim, n_boxes=sm.n_boxes,
            text_len=sm.max_text_length, vocab_size=sm.vocab_size,
            answer_vocab=8).batches(8, seed=1)]
        stx = make_transform(small.train)
        s_cpu = TrainState.create(sp, stx, spro, seed=0, warmup_iters=1.0,
                                  t_total=40.0)
        s_gpu = TrainState.create(to_device(sp, "cuda"), stx,
                                  spro.to("cuda"), seed=0, warmup_iters=1.0,
                                  t_total=40.0)
        step_cpu = make_train_step(small, dtype=torch.float32, device="cpu")
        step_gpu = make_train_step(small, dtype=torch.float32, device="cuda")
        loss_err = 0.0
        for b in sbatches:
            s_cpu, mc = step_cpu(s_cpu, b)
            s_gpu, mg = step_gpu(s_gpu, b)
            loss_err = max(loss_err, abs(float(mg["loss"])
                                         - float(mc["loss"]))
                           / abs(float(mc["loss"])))
        pc, pg = tree_leaves(s_cpu.params), tree_leaves(s_gpu.params)
        param_err = max(float((a - b.cpu()).abs().max())
                        for a, b in zip(pc, pg))
        log(f"small f32 train reference (fused_decoder={fused_decoder}): 3 "
            f"steps card vs CPU plain path: loss rel err {loss_err:.3e} "
            f"(tol 1e-5), param max abs err {param_err:.3e} (tol "
            f"{SMALL_PARAM_TOL:g})")
        if not (loss_err <= 1e-5 and param_err <= SMALL_PARAM_TOL):
            fail("f32 train steps on the card differ from the CPU plain path")
        return loss_err, param_err

    state, train = drive_train(tcfg, "train_step", tm_.num_layers)
    train_step_ms, ttimes = train["train_step_ms"], train["train_step_ms_all"]
    losses = train["losses"]
    train_k1, train_k1p, train_k2 = train["launches"]
    # gradients through K1'/K2 vs the unfused encoder, at dropout 0
    m_unf = Config().model
    m_unf.fused_attention = False
    grad_rel = grad_check(state.params, tm_, m_unf, "unfused encoder")
    del state
    torch.cuda.empty_cache()
    small_loss_err, small_param_err = small_train_reference(False)

    # ---- 4b. the fused decoder (K4) ---------------------------------------
    fcfg = Config()
    fcfg.model.fused_decoder = True
    fm = fcfg.model
    # per step: 12 encoder blocks + 12 decoder self- + 12 cross-attentions
    fd_per_step = fm.num_layers + 2 * fm.num_decoder_layers
    state, fd_train = drive_train(fcfg, "train_step_fused_decoder",
                                  fd_per_step)
    fd_k1, fd_k1p, fd_k2 = fd_train["launches"]
    log(f"train_step_ms: unfused decoder {train_step_ms:.3f}, fused decoder "
        f"{fd_train['train_step_ms']:.3f}")
    m_dec_unf = Config().model          # fused encoder, plain decoder
    fd_grad_rel = grad_check(state.params, fm, m_dec_unf, "unfused decoder")
    fd_small = small_train_reference(True)
    # the loss-eval step: K1 in the encoder and in both decoder attentions
    fd_eval = {}
    for dname, nb in (("bfloat16", TRAIN_BATCH), ("float32", 8)):
        dtp = getattr(torch, dname)
        part = {k: v[:nb] for k, v in tbatch.items()}
        plain_cfg = Config()
        loss_u = float(make_loss_eval_step(plain_cfg, dtype=dtp,
                                           device="cuda")(
            state.params, state.proto, part))
        ev = make_loss_eval_step(fcfg, dtype=dtp, device="cuda")
        ev(state.params, state.proto, part)          # warm-up
        torch.cuda.synchronize()
        zero_counts()
        loss_f = float(ev(state.params, state.proto, part))
        counts = read_counts()
        rel = abs(loss_f - loss_u) / abs(loss_u)
        fd_eval[dname] = {"loss_fused": loss_f, "loss_unfused": loss_u,
                          "rel": rel, "launches": counts}
        log(f"loss_eval fused decoder {dname} bs {nb}: loss {loss_f:.6f} vs "
            f"unfused decoder {loss_u:.6f}, rel {rel:.3e} (tol "
            f"{LOSS_EVAL_RTOL[dname]:g}); launches K1={counts[0]} "
            f"K1'={counts[1]} K2={counts[2]}")
        if counts != (fd_per_step, 0, 0):
            fail(f"expected {fd_per_step} K1 launches and no K1'/K2 per "
                 f"loss-eval step, got {counts}")
        if not (np.isfinite(loss_f) and rel <= LOSS_EVAL_RTOL[dname]):
            fail("the fused decoder's eval loss disagrees with the unfused "
                 "decoder's")
    loss_eval_k1 = fd_eval["bfloat16"]["launches"][0]

    # ---- 4c. remat: block recompute --------------------------------------
    remat = {}
    base_params = state.params
    for mode in (False, "full", "dots"):
        rstate = TrainState.create(base_params, tx, tproto0, seed=7,
                                   warmup_iters=1.0, t_total=1000.0)
        rstep = make_train_step(fcfg, dtype=torch.bfloat16, device="cuda",
                                remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        zero_counts()
        rstate, met = rstep(rstate, tbatch)
        torch.cuda.synchronize()
        counts = read_counts()
        step_peak = torch.cuda.max_memory_allocated() - before
        upd = tree_leaves(rstate.params)
        step_gen_state = rstate.generator.get_state()
        del rstate, rstep
        gen = torch.Generator(device="cuda").manual_seed(7)
        peak = {}
        loss_g, flat = _grads(vlt5, tree_leaves, tree_map, base_params, fm,
                              gb, tproto0, torch.bfloat16, generator=gen,
                              remat=mode, peak=peak)
        r = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
             "gen_state": step_gen_state, "grad_loss": loss_g,
             "grad_gen_state": gen.get_state(), "launches": counts,
             "step_peak_above_state_bytes": step_peak,
             "fwd_bwd_peak_bytes": peak["bytes"]}
        log(f"remat={mode}: loss {r['loss']:.6f} grad_norm "
            f"{r['grad_norm']:.6f} launches K1={counts[0]} K1'={counts[1]} "
            f"K2={counts[2]}; max_memory_allocated above the start: forward"
            f"+backward {peak['bytes'] / 2 ** 30:.3f} GiB, whole step "
            f"(optimizer included) {step_peak / 2 ** 30:.3f} GiB")
        if mode is False:
            r0, flat0, upd0 = r, flat, upd
            remat[mode] = r
            continue
        grad_err = float((flat - flat0).norm() / flat0.norm())
        params_equal = all(torch.equal(a, b) for a, b in zip(upd, upd0))
        same_gen = torch.equal(r["gen_state"], r0["gen_state"]) \
            and torch.equal(r["grad_gen_state"], r0["grad_gen_state"])
        r["grad_rel_err"] = grad_err
        remat[mode] = r
        log(f"remat={mode} vs none: loss equal {r['loss'] == r0['loss']}, "
            f"|g - g0| / |g0| = {grad_err:.3e} (tol {REMAT_GRAD_RTOL:g}), "
            f"updated parameters equal {params_equal}, generator state "
            f"equal {same_gen}")
        if not (r["loss"] == r0["loss"] and r["grad_loss"] == r0["grad_loss"]
                and grad_err <= REMAT_GRAD_RTOL and same_gen):
            fail(f"remat={mode} changed the step")
        # every fused block's forward replays once in the backward pass
        if r["launches"] != (0, 2 * fd_per_step, fd_per_step):
            fail(f"remat={mode}: expected K1'={2 * fd_per_step} and "
                 f"K2={fd_per_step} per step, got {r['launches']}")
        del flat, upd
    if r0["launches"] != (0, fd_per_step, fd_per_step):
        fail(f"remat=False: launches {r0['launches']}")
    remat_summary = {str(k): {
        key: v.get(key, 0.0) for key in (
            "loss", "launches", "fwd_bwd_peak_bytes",
            "step_peak_above_state_bytes", "grad_rel_err")}
        for k, v in remat.items()}
    del state, remat, base_params, tparams, flat0, upd0
    torch.cuda.empty_cache()

    # ---- 5. serving -------------------------------------------------------
    store = MemoryFeatureStore()
    imgs = SyntheticVQA(32, seed=4).examples
    for i, ex in enumerate(imgs):
        store.put(f"img{i}", ex["vis_feats"], ex["boxes"])
    pred = VQAPredictor(cfg, params, proto, VLT5Tokenizer(), store,
                        batch_size=16, dtype=torch.bfloat16, device="cuda")
    n_clients, per_client = 16, 3
    with VQAServer(pred, max_wait_ms=5.0) as srv:
        srv.submit("warm up?", "img0").result(timeout=300)
        warm = srv.stats()
        zero_counts()
        answers, errors = [], []
        start = threading.Barrier(n_clients)

        def client(c):
            start.wait()
            for r in range(per_client):
                i = (c * per_client + r) % len(imgs)
                try:
                    answers.append(srv.submit(
                        f"what is in image {i}?", f"img{i}").result(
                            timeout=300))
                except Exception as e:       # recorded, fails the run
                    errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        serve_launches = fa.fused_attention.launches
        st = srv.stats()
    batches = st["batches"] - warm["batches"]
    log(f"serving: {len(answers)} answers from {n_clients} clients x "
        f"{per_client} in {wall:.3f} s; stats {json.dumps(st)}; "
        f"fused_attention launches={serve_launches} over {batches} batches")
    if any(t.is_alive() for t in threads):
        fail("serving clients did not finish")
    if errors or st["errors"] or len(answers) != n_clients * per_client:
        fail(f"serving errors: {errors[:3]} stats {st}")
    if not all(isinstance(a, str) for a in answers):
        fail("serving returned non-string answers")
    if serve_launches != m.num_layers * batches:
        fail(f"serving launched the kernel {serve_launches} times over "
             f"{batches} batches")

    # ---- 6. the mm_bench probe (K5) -------------------------------------
    torch.cuda.synchronize()
    dw.dw_splitk.launches = 0
    dw.dw_splitk.route_launches = dict.fromkeys(dw.ROUTES, 0)
    mm_rows = mm_bench.run("cuda", MM_BENCH_SHAPES, reps=MM_BENCH_REPS)
    dw_launches = dw.dw_splitk.launches
    dw_routes = dict(dw.dw_splitk.route_launches)
    log(f"mm_bench ({MM_BENCH_REPS} timed calls per case, CUDA events; peak "
        f"{mm_bench.PEAK_FLOPS / 1e12:g} TFLOP/s bf16; {card}):")
    log(mm_bench.table(mm_rows))
    log(f"mm_bench: dw_splitk launches={dw_launches} by route "
        f"{json.dumps(dw_routes)}")
    if dw_routes["wgmma"] == 0:
        fail("mm_bench did not launch dw_splitk's wgmma route")
    if not all(np.isfinite(r["us"]) and r["us"] > 0 for r in mm_rows):
        fail("mm_bench gave a time that is not a positive number")

    # ---- 7. the continual-learning loop -----------------------------------
    cl = {}
    cl_k = [0, 0, 0]
    n_tr, n_va, n_te = CL_ITEMS
    cl_tok = VLT5Tokenizer()
    for name, reg in (("er", "none"), ("ewc", "ewc"), ("derpp", "derpp")):
        ccfg = Config()
        ccfg.train.batch_size = TRAIN_BATCH
        ccfg.train.valid_batch_size = EVAL_BATCH
        ccfg.train.epochs = 1
        ccfg.train.memory = True
        ccfg.train.m_size = CL_M_SIZE
        ccfg.train.cl_reg = reg
        ccfg.train.fisher_batches = CL_FISHER_BATCHES
        cm = ccfg.model
        t0 = time.time()
        cdata = SyntheticDataModule(
            cl_tok, tasks=CL_TASKS,
            n_train_per_task=n_tr if reg == "none" else CL_REG_TRAIN,
            n_val_per_task=n_va, n_test_per_task=n_te, feat_dim=cm.feat_dim,
            n_boxes=cm.n_boxes, n_images=CL_IMAGES, seed=0)
        with tempfile.TemporaryDirectory() as out:
            ccfg.output = out
            trainer = VQACLTrainer(ccfg, cdata, cl_tok, verbose=False,
                                   device="cuda", init_params=params,
                                   dtype=torch.bfloat16)
            log(f"cl_{name}: t5-base bf16 compute, f32 master weights, "
                f"dropout {cm.dropout_rate}, batch {TRAIN_BATCH}, eval batch "
                f"{EVAL_BATCH}, tasks {list(CL_TASKS)}, "
                f"{len(cdata.train_items(CL_TASKS[0]))} "
                f"train items per task, m_size {CL_M_SIZE}, cl_reg {reg}, "
                f"merged_qkv {cm.merged_qkv} (the trainer's resolve of "
                f"'auto'); set-up {time.time() - t0:.1f} s")
            cl[name] = drive_cl(trainer, f"cl_{name}",
                                (zero_counts, read_counts, cm.num_layers))
            if name == "er":   # phase 9 exports its last checkpoint
                os.makedirs(P7_DIR, exist_ok=True)
                os.replace(os.path.join(out, f"{CL_TASKS[-1]}_LAST.npz"),
                           P7_CKPT)
        cl_k = [a + b for a, b in zip(cl_k, cl[name]["launches"])]
        del trainer
        torch.cuda.empty_cache()

    # a tiny f32 run on the card == the same run on the CPU
    tcl = Config()
    tcl.model = tiny_model_config(vocab_size=32200, dropout_rate=0.0)
    tcl.train.lr = 1e-3
    tcl.train.batch_size = tcl.train.valid_batch_size = CL_TINY_BATCH
    tcl.train.epochs = 1
    tcl.train.m_size = 16
    tcl.train.comp_cate = "G5"
    tcm = tcl.model
    tinit = vlt5.init_vlt5_params(4, tcm, device="cpu")
    tiny_runs = {}
    for dev in ("cuda", "cpu"):
        tdata = SyntheticDataModule(
            cl_tok, tasks=CL_TASKS, n_train_per_task=CL_TINY[0],
            n_val_per_task=CL_TINY[1], n_test_per_task=CL_TINY[2],
            feat_dim=tcm.feat_dim, n_boxes=tcm.n_boxes, answer_vocab=4,
            seed=0)
        with tempfile.TemporaryDirectory() as out:
            tcl.output = out
            trainer = CompVQACLTrainer(tcl, tdata, cl_tok, verbose=False,
                                       device=dev, init_params=tinit,
                                       dtype=torch.float32)
            answers = []

            def predict(loader, predict=trainer.predict):
                answers.append(predict(loader))
                return answers[-1]

            trainer.predict = predict
            rec = drive_cl(trainer, f"cl_tiny_f32_{dev}",
                           (zero_counts, read_counts, tcm.num_layers)
                           if dev == "cuda" else None)
            rec["answers"] = answers
            rec["comp"] = trainer.result_matrix_comp.to_dict()
            rec["noncomp"] = trainer.result_matrix_noncomp.to_dict()
            tiny_runs[dev] = rec
    card_run, cpu_run = tiny_runs["cuda"], tiny_runs["cpu"]
    tiny_err = max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                        cpu_run["losses"]))
    same = {k: card_run[k] == cpu_run[k] for k in ("result_matrix", "comp",
                                                   "noncomp", "answers")}
    log(f"cl tiny f32 CompVQACLTrainer (comp_cate G5), card vs CPU: "
        f"{len(card_run['losses'])} / {len(cpu_run['losses'])} steps, loss "
        f"max rel err {tiny_err:.3e} (tol {CL_LOSS_RTOL:g}); equal: "
        f"{json.dumps(same)}; Avg_acc {card_run['Avg_acc']}")
    if len(card_run["losses"]) != len(cpu_run["losses"]) \
            or not tiny_err <= CL_LOSS_RTOL or not all(same.values()):
        fail("the tiny f32 CL run on the card differs from the CPU run")
    cl_k = [a + b for a, b in zip(cl_k, card_run["launches"])]

    # ---- 8. the serving extras ------------------------------------------
    t0 = time.time()
    extras, p8_k = serving_extras(params, proto, (zero_counts, read_counts),
                                  eval_step_ms, cl_tok)
    log(f"phase 8 in {time.time() - t0:.1f} s")

    # ---- 9. the model extensions ----------------------------------------
    t0 = time.time()
    try:
        ext9, p9_k = model_extensions(
            params, proto, (zero_counts, read_counts, strided_counts),
            cl_tok, P7_CKPT)
    finally:
        shutil.rmtree(P7_DIR, ignore_errors=True)
    log(f"phase 9 in {time.time() - t0:.1f} s")

    # ---- 10. the training entry points ------------------------------------
    t0 = time.time()
    ext10, p10_k = training_entry_points(params, (zero_counts, read_counts),
                                         cl_tok)
    ext10["phase_s"] = time.time() - t0
    log(f"phase 10 in {ext10['phase_s']:.1f} s")

    # ---- 11. region and video extraction ----------------------------------
    t0 = time.time()
    ext11, p11_k, n1_launches = extraction(
        params, proto, (zero_counts, read_counts), cl_tok)
    ext11["phase_s"] = time.time() - t0
    log(f"phase 11 in {ext11['phase_s']:.1f} s")

    # ---- 12. data parallelism ---------------------------------------------
    t0 = time.time()
    ext12, p12_k, p12_off = data_parallel((zero_counts, read_counts))
    ext12["phase_s"] = time.time() - t0
    log(f"phase 12 in {ext12['phase_s']:.1f} s")

    # ---- 13. tensor and pipeline parallelism -----------------------------
    t0 = time.time()
    ext13, p13_k, p13_off, p13_head = tensor_pipeline()
    ext13["phase_s"] = time.time() - t0
    ext13["head_offset_check"] = head_off
    log(f"phase 13 in {ext13['phase_s']:.1f} s")

    # ---- 14. the protocol runs ------------------------------------------
    t0 = time.time()
    ext14, p14_k = protocol_runs((zero_counts, read_counts))
    ext14["phase_s"] = time.time() - t0
    log(f"phase 14 in {ext14['phase_s']:.1f} s")

    def row(name, source, replaces, launches, r, offsets=None, heads=None):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
        if offsets is not None:     # the dp ranks past the first, and the
            out["offset_launches"] = offsets    # pipeline's microbatches
        if heads is not None:       # phase 13's tp ranks past the first
            out["head_offset_launches"] = heads
        return out

    fwd_src = "vqacl_tpu_torch/csrc/fused_attention_fwd.cu"
    # launches over the main paths' runs: K1 in the eval steps, the
    # fused-decoder loss-eval step and the CL loops' predict and DER
    # capture batches; K1′/K2 in the train steps with the plain and with
    # the fused decoder and in the CL loops' train, replay and importance
    # steps; K5 in the probe; phase 8's beam, cached, HTTP and pack runs;
    # phase 9's merged train steps, decodes and classifier head; phase 10's
    # CLI runs (VQA train and Test(), NExT-QA, the tiny card runs); phase
    # 11's answers over the extracted pack; phase 12's one-rank mesh and
    # its two ranks' steps and tiny CL runs (K1′/K2 of the second rank at
    # its row offset: ``offset_launches``); phase 13's tp, pp and tp x pp
    # ranks' steps and tiny CL runs (K1′/K2 of the second tp rank over
    # its heads: ``head_offset_launches``; a pipeline's microbatches past
    # the first at their row offsets); phase 14's surrogate rows, cut row
    # and small soak. N1 in phase 11's extraction runs (two per image)
    # and CLI records
    kernels = [
        row("fused_attention_fwd", fwd_src,
            "vqacl_tpu/ops/fused_attention.py:159",
            eval_launches + loss_eval_k1 + cl_k[0] + p8_k[0] + p9_k[0]
            + p10_k[0] + p11_k[0] + p12_k[0] + p13_k[0] + p14_k[0], k1),
        row("fused_attention_fwd_train", fwd_src,
            "vqacl_tpu/ops/fused_attention.py:199",
            train_k1p + fd_k1p + cl_k[1] + p8_k[1] + p9_k[1] + p10_k[1]
            + p12_k[1] + p13_k[1] + p14_k[1], k1p, p12_off[0] + p13_off[0],
            p13_head[0]),
        row("fused_attention_bwd",
            "vqacl_tpu_torch/csrc/fused_attention_bwd.cu",
            "vqacl_tpu/ops/fused_attention.py:272",
            train_k2 + fd_k2 + cl_k[2] + p8_k[2] + p9_k[2] + p10_k[2]
            + p12_k[2] + p13_k[2] + p14_k[2], k2, p12_off[1] + p13_off[1],
            p13_head[1]),
        row("dw_splitk", "vqacl_tpu_torch/csrc/dw_splitk.cu",
            "scripts/mm_bench.py:121", dw_launches, k5),
        # not a Pallas kernel: the two greedy suppressions JAX runs as a
        # lax.scan; its time is the RPN shape's
        row("greedy_nms", "vqacl_tpu_torch/csrc/nms.cu",
            "vqacl_tpu/vision/rpn.py:154, vqacl_tpu/ops/nms.py:83",
            n1_launches, n1),
    ]
    def pick(r):
        return {k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by")
                if k in r}

    dec_times = {"self": {"K1p": pick(dec_rows["self"][0]),
                          "K2": pick(dec_rows["self"][1])},
                 "cross": {"K1p": pick(dec_rows["cross"][0]),
                           "K2": pick(dec_rows["cross"][1])},
                 "self_eval": {"K1": pick(dec_rows["self_eval"])},
                 "cross_eval": {"K1": pick(dec_rows["cross_eval"])}}
    log("summary " + json.dumps({
        "eval_step_ms": eval_step_ms, "eval_batch": EVAL_BATCH,
        "launches_per_eval_step": per_step, "encoder_rel_err": enc_rel,
        "rows_equal": rows_equal, "train_step_ms": train_step_ms,
        "train_step_ms_all": ttimes, "train_batch": TRAIN_BATCH,
        "train_losses": losses,
        "launches_per_train_step": {
            "K1": train_k1 / TRAIN_STEPS, "K1p": train_k1p / TRAIN_STEPS,
            "K2": train_k2 / TRAIN_STEPS},
        "grad_rel_err": grad_rel, "small_train_loss_rel_err": small_loss_err,
        "small_train_param_err": small_param_err,
        "kernel_call_ms": {"K1": k1["call_ms"], "K1p": k1p["call_ms"]},
        "kernel_bytes_flops": {"K1p": [k1p["bytes"], k1p["flops"]],
                               "K2": [k2["bytes"], k2["flops"]],
                               "K5": [k5["bytes"], k5["flops"]]},
        "fused_decoder": {
            "train_step_ms": fd_train["train_step_ms"],
            "train_step_ms_all": fd_train["train_step_ms_all"],
            "train_losses": fd_train["losses"],
            "launches_per_train_step": {
                "K1": fd_k1 / TRAIN_STEPS, "K1p": fd_k1p / TRAIN_STEPS,
                "K2": fd_k2 / TRAIN_STEPS},
            "grad_rel_err": fd_grad_rel,
            "small_train_loss_rel_err": fd_small[0],
            "small_train_param_err": fd_small[1],
            "loss_eval": fd_eval, "kernel_times": dec_times},
        "remat": remat_summary, "mm_bench": mm_rows,
        "mm_bench_dw_route_launches": dw_routes,
        "k5_probe": {k: k5[k] for k in (
            "route", "ms", "base_ms", "plain_ms", "library_ms",
            "library_bf16_ms", "bound_ms", "bound_by") if k in k5},
        "cl": {k: {key: v for key, v in r.items() if key != "metrics"}
               for k, r in cl.items()},
        "cl_tiny": {"loss_rel_err": tiny_err, "equal": same,
                    "launches": card_run["launches"]},
        "serving_extras": extras, "serving_extras_launches": p8_k,
        "model_extensions": ext9, "model_extensions_launches": p9_k,
        "training_cli": ext10, "training_cli_launches": p10_k,
        "extraction": ext11, "extraction_launches": list(p11_k),
        "data_parallel": ext12, "data_parallel_launches": p12_k,
        "data_parallel_offset_launches": p12_off,
        "tensor_pipeline": ext13, "tensor_pipeline_launches": p13_k,
        "tensor_pipeline_offset_launches": p13_off,
        "tensor_pipeline_head_offset_launches": p13_head,
        "protocol_runs": ext14, "protocol_runs_launches": p14_k,
        "extraction_n1_launches": n1_launches,
        "nms_kernel_times": {"rpn": pick(n1), "sweep": pick(n1_sweep)},
        "nextqa_kernel_times": {"K1": pick(nq_k1), "K1p": pick(nq_k1p),
                                "K2": pick(nq_k2)},
        "serve": st, "serve_wall_s": wall, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
