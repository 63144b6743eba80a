"""Device-resident feature cache (counterpart of
``vqacl_tpu/data/device_cache.py``): the top tier of the feature
hierarchy.

  device — this module: the whole region-feature table lives on the card
           (bf16, f32, or int8 with per-row scales); batches carry int32
           slot indices and the gather runs on the card inside the step.
           A train batch of 80 then copies 320 bytes of slots to the
           card instead of 23.6 MB of f32 features and boxes.
  host   — data/packed_cache.py (native mmap pack, threaded gather)
  disk   — h5 / pack files (data/features.py).

The gather is plain PyTorch (``index_select``): in the JAX package it is
``jnp.take`` under ``jit``, not a Pallas kernel. The table is converted
on the host and copied to the device once. ``shard=True`` row-shards the
table over a data-parallel mesh, as JAX does: padded to a multiple of
dp, a rank of dp index d holds rows [d·n/dp, (d+1)·n/dp) (its tp and pp
peers hold the same rows). A lookup then gathers the global batch's
slots over the dp group, fills the rows whose slots this rank holds (in
the table's own type, with int8 scales and boxes), combines them over
the dp group bit for bit in one ``all_reduce`` and keeps this rank's rows
(``lookup_bytes`` counts that buffer's bytes over ``lookups`` calls).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vqacl_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}


def _to_bf16_fast(x: np.ndarray) -> np.ndarray:
    """f32 → the bits of bf16 (uint16), round-to-nearest-even, as integer
    numpy (bf16 is the top 16 bits of f32; add 0x7FFF plus the lowest kept
    bit before truncating). The same bits as the JAX package's, at memory
    bandwidth; NaNs keep a set mantissa bit through the carry, infinities
    stay infinite."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((u + r) >> np.uint32(16)).astype(np.uint16)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bits → a bf16 tensor on the host (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def _quant_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-(image, box)-row int8 quantization: q = rint(x/s),
    s = rowmax(|x|)/127 (1 for an all-zero row). → (int8 values, f32
    scales [..., boxes]). The dequantization error is at most s/2."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(axis=-1) / 127.0
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


class DeviceFeatureCache:
    """feats [N, n_boxes, feat_dim] + boxes [N, n_boxes, 4] on ``device``.

    ``feats`` is f32 numpy, or already in the table's type: uint16 bf16
    bits (``_to_bf16_fast``) for bf16, int8 with ``scales`` for int8.
    ``feat_dtype`` torch.int8 stores the table quantized per (image, box)
    row, half the bytes of bf16, dequantized in the gather within s/2;
    bf16 gives the host pipeline's features exactly as the encoder sees
    them (it rounds the features to bf16 first).
    """

    def __init__(self, feats: np.ndarray, boxes: np.ndarray, device="cuda",
                 shard: bool = False, feat_dtype=torch.bfloat16,
                 scales: Optional[np.ndarray] = None, mesh_ctx=None):
        if shard and mesh_ctx is None:
            raise ValueError("a sharded device cache needs a mesh "
                             "(mesh_ctx)")
        if feat_dtype not in DTYPES.values():
            raise ValueError(f"feat_dtype {feat_dtype}: pick from "
                             f"{list(DTYPES.values())}")
        self.device = resolve_device(device)
        feats = np.asarray(feats)
        self.n = feats.shape[0]
        if feat_dtype == torch.int8:
            if feats.dtype == np.int8:
                if scales is None:
                    raise ValueError("int8 features need their scales")
            else:
                # chunked: the f32 temporaries stay small
                q = np.empty(feats.shape, np.int8)
                scales = np.empty(feats.shape[:-1], np.float32)
                for s in range(0, self.n, 1024):
                    q[s:s + 1024], scales[s:s + 1024] = _quant_rows(
                        feats[s:s + 1024])
                feats = q
            host = torch.from_numpy(feats)
        elif feat_dtype == torch.bfloat16:
            host = _bf16_tensor(feats if feats.dtype == np.uint16
                                else _to_bf16_fast(feats))
        else:
            host = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
        boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32))
        if feat_dtype == torch.int8:
            scales = torch.from_numpy(np.ascontiguousarray(scales,
                                                           np.float32))
        self.ctx = mesh_ctx if shard else None
        self.row0, self.rows = 0, self.n
        self.lookup_bytes = 0
        self.lookups = 0
        if shard:
            # pad to a multiple of dp (zeros; scales 1), keep this rank's
            # block of rows
            dp = mesh_ctx.dp
            pad = (-self.n) % dp
            self.rows = (self.n + pad) // dp
            self.row0 = mesh_ctx.dp_index * self.rows

            def block(t, fill):
                if pad:
                    t = torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]),
                                                 fill, dtype=t.dtype)])
                return t[self.row0:self.row0 + self.rows]

            host, boxes = block(host, 0), block(boxes, 0)
            if feat_dtype == torch.int8:
                scales = block(scales, 1)
        self.feats = host.to(self.device)
        self.boxes = boxes.to(self.device)
        self.scales = None if feat_dtype != torch.int8 else \
            scales.to(self.device)

    @property
    def nbytes(self) -> int:
        """Bytes of the table on the device (features, scales, boxes): this
    rank's block when sharded."""
        return sum(t.numel() * t.element_size()
                   for t in (self.feats, self.scales, self.boxes)
                   if t is not None)

    def lookup(self, slots) -> Tuple[torch.Tensor, torch.Tensor]:
        """slots [B] int (numpy or tensor) → (feats [B, n_boxes,
        feat_dim] f32, boxes [B, n_boxes, 4] f32) on the device; slot −1
        and out-of-range slots give zeros (the collator's pad rows). On a
        sharded table every rank must look up together (``slots`` its
        rows of the global batch)."""
        if isinstance(slots, np.ndarray):
            slots = torch.from_numpy(slots)
        slots = slots.to(self.device, non_blocking=True)
        if self.ctx is not None:
            return self._lookup_sharded(slots)
        valid = ((slots >= 0) & (slots < self.n))[:, None, None]
        idx = slots.clamp(0, self.n - 1).long()
        f = self.feats.index_select(0, idx).float()
        if self.scales is not None:
            f = f * self.scales.index_select(0, idx)[..., None]
        b = self.boxes.index_select(0, idx)
        return (torch.where(valid, f, torch.zeros_like(f)),
                torch.where(valid, b, torch.zeros_like(b)))

    def _lookup_sharded(self, slots: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``lookup`` on a row-sharded table: every rank fills the
        global batch's rows whose slots it holds, one ``combine_all``
        joins them, each rank keeps its own rows."""
        ctx = self.ctx
        B = slots.shape[0]
        g = ctx.gather_rows(slots.to(torch.int32), "dp")       # [dp·B]
        local = g.long() - self.row0
        own = ((g >= 0) & (g < self.n) & (local >= 0)
               & (local < self.rows))[:, None, None]
        idx = local.clamp(0, self.rows - 1)
        parts = [self.feats.index_select(0, idx), self.boxes.index_select(0,
                                                                          idx)]
        if self.scales is not None:
            parts.append(self.scales.index_select(0, idx)[..., None])
        parts = [torch.where(own, t, torch.zeros_like(t)) for t in parts]
        self.lookup_bytes += sum(-(-t.numel() * t.element_size() // 16) * 16
                                 for t in parts)
        self.lookups += 1
        mine = slice(ctx.dp_index * B, (ctx.dp_index + 1) * B)
        parts = [t[mine] for t in ctx.combine_all(parts, "dp")]
        f = parts[0].float()
        if self.scales is not None:
            f = f * parts[2]
        return f, parts[1]

    @classmethod
    def from_store(cls, store, img_ids: Sequence[str], device="cuda",
                   shard: bool = False, feat_dtype=torch.bfloat16,
                   mesh_ctx=None
                   ) -> Tuple["DeviceFeatureCache", Dict[str, int]]:
        """Build from a host feature store → (cache, {img_id: slot}). The
        host table is allocated once in the table's type and filled per
        image, then copied to the device once."""
        ids = list(img_ids)
        f0, b0 = store.get(ids[0])
        np_dtype = {torch.bfloat16: np.uint16, torch.float32: np.float32,
                    torch.int8: np.int8}[feat_dtype]
        feats = np.empty((len(ids),) + np.shape(f0), np_dtype)
        boxes = np.empty((len(ids),) + np.shape(b0), np.float32)
        scales = np.empty((len(ids),) + np.shape(f0)[:-1], np.float32) \
            if feat_dtype == torch.int8 else None
        slot_of = {}
        for i, img in enumerate(ids):
            f, b = store.get(img)
            if feat_dtype == torch.bfloat16:
                feats[i] = _to_bf16_fast(f)
            elif feat_dtype == torch.int8:
                feats[i], scales[i] = _quant_rows(f)
            else:
                feats[i] = f
            boxes[i] = b
            slot_of[img] = i
        return cls(feats, boxes, device=device, shard=shard,
                   feat_dtype=feat_dtype, scales=scales,
                   mesh_ctx=mesh_ctx), slot_of


def with_features(cache: DeviceFeatureCache, batch: Dict) -> Dict:
    """``batch`` with its ``slots`` replaced by the gathered vis_feats and
    boxes (on the cache's device)."""
    b = dict(batch)
    b["vis_feats"], b["boxes"] = cache.lookup(b.pop("slots"))
    return b


def make_cached_train_step(cfg, cache: DeviceFeatureCache,
                           dtype=torch.bfloat16, device="cuda", **kw):
    """``make_train_step`` over batches that carry ``slots`` [B] int32 in
    place of vis_feats/boxes: ``(state, batch, reg=None)``."""
    from vqacl_tpu_torch.train.step import make_train_step

    inner = make_train_step(cfg, dtype=dtype, device=device, **kw)

    @functools.wraps(inner)
    def step(state, batch, *extra):      # extra: the EWC/MAS RegState
        return inner(state, with_features(cache, batch), *extra)

    return step


def make_cached_eval_step(cfg, cache: DeviceFeatureCache,
                          dtype=torch.bfloat16, device="cuda", **kw):
    """``make_eval_step`` (its options in ``kw``) over slot batches."""
    from vqacl_tpu_torch.train.step import make_eval_step

    inner = make_eval_step(cfg, dtype=dtype, device=device, **kw)

    def step(params, proto, batch):
        return inner(params, proto, with_features(cache, batch))

    return step


def make_cached_der_step(cfg, cache: DeviceFeatureCache,
                         dtype=torch.bfloat16, device="cuda", **kw):
    """``make_der_replay_step`` over slot batches."""
    from vqacl_tpu_torch.train.step import make_der_replay_step

    inner = make_der_replay_step(cfg, dtype=dtype, device=device, **kw)

    def step(state, batch):
        return inner(state, with_features(cache, batch))

    return step


def make_cached_logits_step(cfg, cache: DeviceFeatureCache,
                            dtype=torch.bfloat16, device="cuda", **kw):
    """``make_logits_step`` (the DER capture pass) over slot batches."""
    from vqacl_tpu_torch.train.step import make_logits_step

    inner = make_logits_step(cfg, dtype=dtype, device=device, **kw)

    def step(params, proto, batch):
        return inner(params, proto, with_features(cache, batch))

    return step
