"""Continuous batching scheduler over an Engine: the counterpart of
simpleinfer_tpu/serving/batcher.py, with the same surface.

- Buckets: arriving requests are packed into the smallest BUCKET >=
  queue depth and the batch is padded to that bucket (pad rows are
  computed and discarded). Buckets default to powers of two up to
  `max_batch`, so the forward sees a few fixed shapes (cuDNN's and the
  kernels' first-call setup runs once per bucket, at `warmup`).
- The scheduler thread drains the queue continuously: while the card
  works on batch N, batch N+1 is gathered and staged, and a batch's
  output is fetched only when its engine is about to be reused (or the
  queue goes idle).
- Each request resolves a concurrent.futures.Future with its output row,
  so callers get per-request latency out of a batched backend.

The dispatch contract, which the JAX package gets from XLA's
asynchronous calls: `_dispatch` returns as soon as the batch is QUEUED
on the card. Its host work is one copy of the items into a pinned host
tensor, a non-blocking copy of it to the card (Engine.input), the
forward's and the postprocess's launches, and a non-blocking copy of
the output into pinned memory, after which a CUDA event is recorded.
`_resolve` waits on that event only, so the fetch of batch N never
waits for the forward of batch N+1. Everything runs on the engine's
stream: the caching allocators' stream order keeps every block alive
until the work that reads it has run.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

# warmup(probe_spill=True)'s default budget for Engine.temp_bytes, which
# counts every temporary of an eager forward (not XLA's spill bytes, which
# the JAX package's 32 MB default was tuned against). Measured on an H100
# 80GB HBM3 at 700 W, YOLOv5s-640 bf16 int8w (chip_smoke.py, phase
# `serving`, bucket_sweep): the forward's time per image falls at every
# bucket, 7.83 / 2.96 / 1.69 / 0.825 / 0.597 / 0.431 ms at b1 / 2 / 4 / 8 /
# 16 / 32, so the budget is b32's temp_bytes, 3,552,562,176 bytes, rounded
# up to a MiB: every bucket up to 32 is kept
SPILL_BUDGET_BYTES = 3388 << 20


@dataclass
class Request:
    array: np.ndarray  # one item, engine input layout (e.g. HWC)
    future: Future = field(default_factory=Future)
    enqueue_t: float = field(default_factory=time.perf_counter)


@dataclass
class BucketStats:
    """Per-bucket request latency accounting (enqueue -> resolve)."""

    batches: int = 0
    items: int = 0
    total_latency_s: float = 0.0
    max_latency_s: float = 0.0

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / max(self.items, 1)


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    padded_items: int = 0
    total_latency_s: float = 0.0
    total_batch_time_s: float = 0.0
    batches_per_engine: list = field(default_factory=list)
    per_bucket: dict = field(default_factory=dict)  # bucket -> BucketStats

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / max(self.requests, 1)

    @property
    def mean_batch_occupancy(self) -> float:
        done = self.requests
        return done / max(done + self.padded_items, 1)

    def slo_report(self, target_ms: float) -> dict:
        """Per-bucket mean/max latency vs a target; `within` is False
        for any bucket whose MAX observed latency exceeded it."""
        return {
            b: {"mean_ms": s.mean_latency_ms,
                "max_ms": s.max_latency_s * 1e3,
                "items": s.items,
                "within": s.max_latency_s * 1e3 <= target_ms}
            for b, s in sorted(self.per_bucket.items())}


def _default_buckets(max_batch: int) -> list:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def stage_batch(arrays: list, bucket: int, pin: bool):
    """The items, zero-padded to `bucket` rows, in one host copy: into a
    pinned torch tensor (its .numpy() view) when `pin`, else into a numpy
    array. Items are promoted as np.stack promotes them; items of unequal
    shapes raise ValueError."""
    dtype = np.result_type(*(a.dtype for a in arrays))
    shape = (bucket, *arrays[0].shape)
    if pin:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        out = torch.empty(shape, dtype=tdtype, pin_memory=True)
        buf = out.numpy()
    else:
        out = buf = np.empty(shape, dtype)
    n = len(arrays)
    np.stack(arrays, out=buf[:n])
    buf[n:] = 0
    return out


def fetch_async(out: torch.Tensor):
    """Queue an output's copy to the host; returns (host tensor, CUDA
    event recorded after the copy, or None for a CPU tensor, which is
    returned as it is). bf16 converts to f32 on the card first: numpy has
    no bfloat16, and the wire format must be portable."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return host, done


class BatchingService:
    """Continuous batching front-end for one Engine or a pool of them.

    Usage:
        svc = BatchingService(engine, input_name, out_name, max_batch=32)
        svc.start()
        fut = svc.submit(image_nhwc_row)      # -> Future
        result = fut.result()
        svc.stop()

    Pass a LIST of engines for data-parallel serving: batches round-robin
    across engines and the pipeline runs len(engines) deep, so every
    engine's batch is queued while the host gathers the next one. On one
    card every engine of the pool shares it.
    """

    def __init__(self, engine, input_name: str | None = None,
                 output_name: str | None = None, max_batch: int = 32,
                 buckets: list | None = None,
                 max_wait_ms: float = 2.0,
                 device_postprocess=None):
        """`device_postprocess` (optional torch callable tensor->tensor)
        runs on the raw output ON DEVICE, under torch.inference_mode(),
        before the host fetch — e.g. zoo.detect.decode_device to fetch
        [N, max_det, 6] rows in place of the raw YOLO head."""
        self.engines = list(engine) if isinstance(
            engine, (list, tuple)) else [engine]
        if not self.engines:
            raise ValueError("need at least one engine")
        self.engine = self.engines[0]
        self.input_name = input_name or self.engine.input_names[0]
        self.output_name = output_name or self.engine.output_names[0]
        self.device_post = device_postprocess
        self.max_batch = max_batch
        self.buckets = sorted(buckets or _default_buckets(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = ServiceStats(
            batches_per_engine=[0] * len(self.engines))
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- client side -----------------------------------------------------
    def submit(self, array: np.ndarray) -> Future:
        if self._thread is None:
            raise RuntimeError("service not started")
        req = Request(np.asarray(array))
        self._q.put(req)
        return req.future

    def warmup(self, probe_spill: bool = False,
               spill_budget_bytes: int = SPILL_BUDGET_BYTES) -> None:
        """Run every bucket once up front (Engine.warmup: the kernel
        libraries load, cuDNN's and cuBLAS's first-call setup runs).

        probe_spill=True additionally asks each bucket's forward how many
        bytes of temporaries it holds at its peak (Engine.temp_bytes) and
        DROPS buckets above `spill_budget_bytes` (SPILL_BUDGET_BYTES: no
        YOLOv5s-640 bucket up to 32 on an H100, where the time per image
        falls with the bucket): a larger offered load is then served as
        waves of the largest kept bucket. The smallest bucket is always
        kept; an engine without memory statistics (the CPU) keeps all.
        """
        if probe_spill:
            kept = self.buckets[:1]
            for b in self.buckets[1:]:
                t = self.engine.temp_bytes(b)
                if t is None or t <= spill_budget_bytes:
                    kept.append(b)
                else:
                    logging.getLogger("simpleinfer_tpu_torch").warning(
                        "serving bucket b%d drops: forward temporaries "
                        "%.0f MB > budget %.0f MB (loads route to the "
                        "surviving buckets)", b, t / 2**20,
                        spill_budget_bytes / 2**20)
            self.buckets = kept
            self.max_batch = min(self.max_batch, kept[-1])
        for eng in self.engines:
            eng.warmup(self.buckets)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "BatchingService":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="si-batcher")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if self._thread is None:
            return
        if drain:
            self._q.join()
        self._stop.set()
        self._thread.join()
        self._thread = None

    # ---- scheduler -------------------------------------------------------
    def _gather(self) -> list:
        """Block for one request, then drain whatever arrived (up to
        max_batch), waiting at most max_wait_s for stragglers."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            # a fuller bucket is always better; only wait when the
            # current size would pad heavily
            try:
                batch.append(self._q.get(block=remaining > 0,
                                         timeout=max(remaining, 0)))
            except queue.Empty:
                break
        return batch

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _dispatch(self, batch: list, engine_idx: int):
        """Stage + forward one batch on one engine and queue its output's
        copy to the host; returns (batch, host output, CUDA event or None,
        t0, bucket) as soon as that work is queued (not done)."""
        t0 = time.perf_counter()
        n = len(batch)
        bucket = self._bucket_for(n)
        eng = self.engines[engine_idx]
        x = stage_batch([r.array for r in batch], bucket,
                        pin=eng.device.type == "cuda")
        eng.input(self.input_name, x)
        eng.forward()
        out = eng.extract(self.output_name, as_numpy=False)
        with torch.inference_mode():
            if self.device_post is not None:
                out = self.device_post(out)
            host, done = fetch_async(out)
        self.stats.batches_per_engine[engine_idx] += 1
        return batch, host, done, t0, bucket

    def _resolve(self, inflight) -> None:
        """Wait for a dispatched batch's output copy (its own event only)
        and complete its futures."""
        batch, host, done, t0, bucket = inflight
        n = len(batch)
        try:
            if done is not None:
                done.synchronize()
            rows = host.numpy()
            for i, r in enumerate(batch):
                r.future.set_result(rows[i])
        except Exception as e:  # noqa: BLE001 — propagate to all waiters
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            now = time.perf_counter()
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.padded_items += bucket - n
            self.stats.total_batch_time_s += now - t0
            lat = [now - r.enqueue_t for r in batch]
            self.stats.total_latency_s += sum(lat)
            bs = self.stats.per_bucket.setdefault(bucket, BucketStats())
            bs.batches += 1
            bs.items += n
            bs.total_latency_s += sum(lat)
            bs.max_latency_s = max(bs.max_latency_s, max(lat, default=0.0))
            for _ in batch:
                self._q.task_done()

    def _loop(self) -> None:
        """Pipelined schedule, len(engines) deep: while the card runs
        each engine's batch, the host gathers and stages the next one,
        and an engine's previous output is fetched only when that engine
        is about to be reused (or the queue goes idle)."""
        depth = len(self.engines)
        inflight: deque = deque()  # oldest first
        rr = 0  # round-robin engine cursor
        while not self._stop.is_set():
            batch = self._gather()
            if batch:
                # dispatch BEFORE fetching the oldest output: queueing
                # behind a busy stream is free, and fetching first would
                # idle the card behind one host wait. The previous
                # output's host copy is its own pinned block.
                dispatched = False
                try:
                    inflight.append(self._dispatch(batch, rr % depth))
                    rr += 1
                    dispatched = True
                except Exception as e:  # noqa: BLE001 — staging failed
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                    for _ in batch:
                        self._q.task_done()
                    self.stats.requests += len(batch)
                    self.stats.batches += 1
                # resolve the oldest output once the pipeline is full;
                # after a FAILED dispatch resolve unconditionally, so a
                # stream of bad requests can never starve futures whose
                # batches the card already finished
                if len(inflight) > depth or (not dispatched and inflight):
                    self._resolve(inflight.popleft())
            elif inflight:
                # idle: complete waiters promptly
                self._resolve(inflight.popleft())
        while inflight:
            self._resolve(inflight.popleft())
