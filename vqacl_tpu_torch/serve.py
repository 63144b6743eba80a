"""Batched inference API: checkpoint in, answers out.

Counterpart of ``vqacl_tpu/serve.py``, with the same behaviour:

    predictor = VQAPredictor.from_checkpoint("snap/vqacl/q_causal_LAST",
                                             tokenizer, feature_store)
    answers = predictor.answer(["what color is the cat?"], ["COCO_..._42"])

``VQAServer`` adds continuous batching: concurrent ``submit()`` calls
coalesce into single eval-step calls on a background worker, so batch
fill tracks offered load instead of per-caller batch sizes.
``cli/serve_http.py`` puts it behind HTTP.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vqacl_tpu_torch.data.collate import collate
from vqacl_tpu_torch.data.device_cache import make_cached_eval_step
from vqacl_tpu_torch.models.convert import to_device
from vqacl_tpu_torch.models.prototype import ProtoState
from vqacl_tpu_torch.models.vlt5 import cast_params_for_inference
from vqacl_tpu_torch.train.checkpoint import load_checkpoint
from vqacl_tpu_torch.train.step import make_eval_step
from vqacl_tpu_torch.utils.config import Config
from vqacl_tpu_torch.utils.device import resolve_device


class VQAPredictor:
    def __init__(self, cfg: Config, params, proto: ProtoState, tokenizer,
                 feature_store, batch_size: int = 16, num_beams: int = 1,
                 dtype=torch.bfloat16, device="cuda",
                 device_cache=None, slot_of: Optional[Dict[str, int]] = None):
        """``params``/``proto`` are moved to ``device``; with bf16 the
        matmul weights are cast once (the predictor's weights never
        change). ``num_beams`` > 1 decodes with beam search.
        ``device_cache``/``slot_of`` (a ``DeviceFeatureCache`` on
        ``device`` and its img_id→slot map, data/device_cache.py) serve
        from the device-resident feature table: requests carry int32
        slots and the features never cross from the host."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self._slot_of = slot_of
        if device_cache is not None:
            if slot_of is None:
                raise ValueError("device_cache requires slot_of")
            self._eval = make_cached_eval_step(cfg, device_cache, dtype=dtype,
                                               device=self.device,
                                               num_beams=num_beams)
        else:
            self._eval = make_eval_step(cfg, dtype=dtype, device=self.device,
                                        num_beams=num_beams)
        params = to_device(params, self.device)
        if dtype == torch.bfloat16:
            params = cast_params_for_inference(params, dtype)
        self.params = params
        self.proto = proto.to(self.device)
        self.tok = tokenizer
        self.features = feature_store
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer, feature_store,
                        cfg: Optional[Config] = None, **kw) -> "VQAPredictor":
        """Serve a ``.npz`` checkpoint written by either package."""
        params, proto, _ = load_checkpoint(path)
        return cls(cfg or Config(), params, proto, tokenizer,
                   feature_store, **kw)

    def _examples(self, questions: Sequence[str],
                  img_ids: Sequence[str]) -> List[Dict]:
        out = []
        for q, img in zip(questions, img_ids):
            ex = {
                "input_ids": self.tok.encode(
                    f"vqa: {q}", max_length=self.cfg.model.max_text_length),
                "ques_label": 0, "cate_label": 0,
            }
            if self._slot_of is not None:       # device-cache serving
                ex["slot"] = self._slot_of[img]
            else:
                ex["vis_feats"], ex["boxes"] = self.features.get(img)
            out.append(ex)
        return out

    def dispatch_chunk(self, chunk: List[Dict]) -> torch.Tensor:
        """Run the eval step on ≤ batch_size prepared examples (padded to
        batch_size); returns the token tensor on the device, so the copy
        to the host happens in :meth:`finish_chunk`."""
        if len(chunk) > self.batch_size:
            raise ValueError(f"chunk of {len(chunk)} exceeds batch size "
                             f"{self.batch_size}")
        m = self.cfg.model
        b = collate(chunk, max_text_length=m.max_text_length,
                    n_boxes=m.n_boxes,
                    target_max_length=m.target_max_length,
                    n_ques_types=m.n_ques_types,
                    n_categories=m.n_categories, feat_dim=m.feat_dim,
                    pad_to_batch=self.batch_size, with_targets=False)
        return self._eval(self.params, self.proto, b["tensors"])

    def finish_chunk(self, tokens_dev: torch.Tensor, n: int) -> List[str]:
        """Copy to the host and detokenize a :meth:`dispatch_chunk` result."""
        return self.tok.batch_decode(tokens_dev[:n].cpu().numpy())

    def decode_chunk(self, chunk: List[Dict]) -> List[str]:
        return self.finish_chunk(self.dispatch_chunk(chunk), len(chunk))

    def answer(self, questions: Sequence[str],
               img_ids: Sequence[str]) -> List[str]:
        """Batched answers (padded to the static batch size)."""
        if len(questions) != len(img_ids):
            raise ValueError("questions and img_ids differ in length")
        exs = self._examples(questions, img_ids)
        answers: List[str] = []
        for s in range(0, len(exs), self.batch_size):
            answers.extend(self.decode_chunk(exs[s:s + self.batch_size]))
        return answers


class VQAServer:
    """Continuous-batching online server over one ``VQAPredictor``.

    Requests enter through :meth:`submit` (thread-safe, returns a
    ``Future``); one background worker drains the queue, coalescing
    whatever is in flight — up to the predictor's batch size, waiting at
    most ``max_wait_ms`` after the first request of a batch — into one
    eval-step call. A bad request (unknown ``img_id``) fails only its
    own future, never the batch. Example prep (tokenize + feature fetch)
    runs on the caller's thread at submit time.
    """

    _STOP = object()

    def __init__(self, predictor: VQAPredictor, max_wait_ms: float = 5.0,
                 latency_window: int = 1024, pipeline_depth: int = 0):
        """``pipeline_depth=0``: the worker finishes each batch before the
        next, so the device call itself is the batching window.
        ``pipeline_depth>=1``: the dispatch worker runs ahead by that many
        calls while a finisher thread copies tokens and detokenizes."""
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._batched_items = 0
        self._errors = 0
        self._lat: List[float] = []     # ring buffer of latencies (s)
        self._lat_cap = latency_window
        self._closed = False
        self._pipelined = int(pipeline_depth) >= 1
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="vqa-server-dispatch")
        if self._pipelined:
            self._fin_q: "queue.Queue" = queue.Queue(
                maxsize=int(pipeline_depth))
            self._finisher = threading.Thread(target=self._finish_loop,
                                              daemon=True,
                                              name="vqa-server-finish")
            self._finisher.start()
        self._worker.start()

    # -- client side ----------------------------------------------------
    def submit(self, question: str, img_id: str) -> "Future":
        """Enqueue one request; resolves to the answer string."""
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("VQAServer is closed"))
            return fut
        with self._lock:
            self._requests += 1
        try:
            ex = self.predictor._examples([question], [img_id])[0]
        except Exception as e:          # unknown img_id / store IO error
            with self._lock:
                self._errors += 1
            fut.set_exception(e)
            return fut
        self._q.put((ex, fut, time.monotonic()))
        return fut

    def answer(self, questions: Sequence[str],
               img_ids: Sequence[str]) -> List[str]:
        """Synchronous convenience: submit all, wait for all."""
        futs = [self.submit(q, i) for q, i in zip(questions, img_ids)]
        return [f.result() for f in futs]

    # -- worker side ----------------------------------------------------
    def _loop(self) -> None:
        cap = self.predictor.batch_size
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            batch: List[Tuple] = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._STOP:
                    self._q.put(item)   # re-queue for the outer loop
                    break
                batch.append(item)
            futs = [b[1] for b in batch]
            try:
                tokens_dev = self.predictor.dispatch_chunk(
                    [b[0] for b in batch])
            except Exception as e:      # device-side failure: fail batch
                self._fail(futs, e)
                continue
            if self._pipelined:
                # bounded put = backpressure: at most pipeline_depth
                # device calls in flight before dispatch stalls
                self._fin_q.put((tokens_dev, batch, futs))
            else:
                self._finish_batch(tokens_dev, batch, futs)

    def _fail(self, futs, err) -> None:
        with self._lock:
            self._errors += len(futs)
        for f in futs:
            if not f.done():
                f.set_exception(err)

    def _finish_loop(self) -> None:
        while True:
            item = self._fin_q.get()
            if item is self._STOP:
                return
            self._finish_batch(*item)

    def _finish_batch(self, tokens_dev, batch, futs) -> None:
        try:
            answers = self.predictor.finish_chunk(tokens_dev, len(batch))
        except Exception as e:
            self._fail(futs, e)
            return
        now = time.monotonic()
        with self._lock:
            self._batches += 1
            self._batched_items += len(batch)
            for (_, _, t0) in batch:
                if len(self._lat) >= self._lat_cap:
                    self._lat.pop(0)
                self._lat.append(now - t0)
        for f, a in zip(futs, answers):
            try:
                f.set_result(a)
            except Exception:   # close() failed it first — drop the race
                pass

    # -- lifecycle / telemetry ------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat)
            n = len(lat)
            return {
                "requests": self._requests,
                "batches": self._batches,
                "errors": self._errors,
                "mean_batch_fill": (self._batched_items / self._batches
                                    if self._batches else 0.0),
                "batch_capacity": self.predictor.batch_size,
                "latency_p50_ms": 1e3 * lat[n // 2] if n else None,
                "latency_p99_ms": (1e3 * lat[min(n - 1, (99 * n) // 100)]
                                   if n else None),
            }

    def close(self, timeout: float = 10.0) -> None:
        """Drain in-flight work and stop the stage threads in order."""
        self._closed = True
        self._q.put(self._STOP)
        self._worker.join(timeout=timeout)
        if self._pipelined:
            self._fin_q.put(self._STOP)
            self._finisher.join(timeout=timeout)
        # fail any request that slipped past the _closed check into the
        # queue after the sentinel (or was left behind by a stuck
        # worker), so its caller's fut.result() never blocks forever
        err = RuntimeError("VQAServer closed before this request was served")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                continue
            _, fut, _ = item
            try:
                fut.set_exception(err)
            except Exception:   # lost the race against a live worker
                pass

    def __enter__(self) -> "VQAServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
