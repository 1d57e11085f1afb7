"""Continuous-batching text generation service: the counterpart of
simpleinfer_tpu/serving/llm.GenerationService.

A fixed pool of `slots` rows steps through zoo/generate.CachedDecoder
decode blocks, and requests are admitted into free rows mid-flight: a
new prompt prefills (one batched pass per admission wave, at the
smallest prefill bucket covering the wave's longest prompt) while its
neighbours are deep in decode. Sampling (temperature / top-k / top-p)
runs on the device with per-row parameters, so greedy and sampled
requests share a step batch.

Pipelining: the next decode block is enqueued, chained on the device
from the last block's final tokens, before the last block's tokens are
fetched, so the fetch and the host's bookkeeping overlap the card's
work. A request holds its row until done (no preemption).

Both attention lineages serve: nn.MultiheadAttention (GPT) and
si.RotaryAttention (llama; sliding windows, whose pool caches are rings
sized to the window, with a decode horizon of at most
CachedDecoder.RING_HEADROOM; gemma2's softcap; BLOOM's ALiBi). Sliding,
softcapped and ALiBi models decode on torch under decode_attn="auto"
(CachedDecoder.kernel_ok), as in the JAX package.

Not ported yet: TieredGenerationService, adaptive_horizon, cancel /
deadlines / priorities, the kv_prefix ladder and sample caps (JAX's
`decode_attn="auto"` with kv_prefix_ladder=None is what "auto" does
here: the kernel at slots >= KERNEL_MIN_SLOTS), and /v1/generate.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..zoo.generate import CachedDecoder


@dataclass
class _GenRequest:
    prompt: np.ndarray          # [P] int
    max_new: int
    eos_id: int | None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    # streaming: accepted tokens are pushed here as the scheduler finds
    # them (block granularity); None marks completion
    stream_q: queue.Queue | None = None


@dataclass
class GenStats:
    requests: int = 0
    completed: int = 0
    steps: int = 0
    prefills: int = 0
    tokens_out: int = 0
    occupancy_sum: float = 0.0
    latency_sum_ms: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(1, self.steps)

    @property
    def mean_latency_ms(self) -> float:
        return self.latency_sum_ms / max(1, self.completed)


class StreamHandle:
    """Iterator over one request's generated tokens (submit_stream):
    yields int ids as the scheduler accepts them and ends when the
    request completes; `result(timeout)` returns the full
    [prompt + generated] array."""

    def __init__(self, req: _GenRequest):
        self._req = req
        self.future = req.future

    def __iter__(self):
        while True:
            tok = self._req.stream_q.get()
            if tok is None:
                if self.future.exception() is not None:
                    raise self.future.exception()
                return
            yield tok

    def result(self, timeout: float | None = None) -> np.ndarray:
        return self.future.result(timeout=timeout)


class GenerationService:
    """Slot-scheduled generation over one causal-LM engine.

        svc = GenerationService(engine, slots=16).start()
        ids = svc.submit([1, 5, 9], max_new=32, eos_id=2).result()
        svc.stop()

    Greedy requests (temperature = 0) are deterministic; scratch blocks
    and the decode kernel change only the f32 summation order.
    """

    #: smallest pool where decode_attn="auto" dispatches the per-row
    #: decode kernel: on an H100 a decode step's frozen-cache attention
    #: through the kernel beats the torch route at every pool size from
    #: 1 slot (1.05x) to 16 (7.7x) (chip_smoke.decode_slots_sweep,
    #: PERF.md); the JAX package's TPU crossover was 16
    KERNEL_MIN_SLOTS = 1

    def __init__(self, engine, slots: int = 8, tick_timeout_s: float = 0.01,
                 seed: int = 0, decode_horizon: int = 1,
                 pipelined: bool = True, kv_dtype: str | None = None,
                 scratch_blocks: bool = True,
                 prefill_ladder: tuple | list | str | None = "auto",
                 decode_attn: str = "auto"):
        """decode_attn: "torch" (torch attention over the cache),
        "kernel" (every block runs the per-row decode kernel) or "auto"
        (the kernel at slots >= KERNEL_MIN_SLOTS when the decoder allows
        it, else torch). prefill_ladder: admission bucket widths; "auto"
        = {64, 256, 1024} below the window plus the window itself. Over
        ring caches decode_horizon is at most
        CachedDecoder.RING_HEADROOM: the JAX service fails at its first
        decode block past it, this one when it is built."""
        if decode_attn not in ("torch", "kernel", "auto"):
            raise ValueError(f"decode_attn must be 'torch', 'kernel' or "
                             f"'auto', got {decode_attn!r}")
        self._dec = CachedDecoder(
            engine, kv_dtype=kv_dtype, scratch_blocks=scratch_blocks,
            decode_attn="kernel" if decode_attn == "kernel" else "torch")
        self._attn_auto = (decode_attn == "auto"
                           and slots >= self.KERNEL_MIN_SLOTS
                           and self._dec.kernel_ok)
        if self._dec._has_ring and decode_horizon > self._dec.RING_HEADROOM:
            raise ValueError(
                f"decode blocks over ring-stored sliding caches are "
                f"limited to {self._dec.RING_HEADROOM} steps, got "
                f"decode_horizon {decode_horizon}")
        window = self._dec._window
        if isinstance(prefill_ladder, str):
            if prefill_ladder != "auto":
                raise ValueError(f"prefill_ladder must be a sequence, "
                                 f"None or 'auto', got {prefill_ladder!r}")
            buckets = [b for b in (64, 256, 1024) if b < window]
        else:
            if isinstance(prefill_ladder, int):
                prefill_ladder = (prefill_ladder,)
            buckets = sorted(int(b) for b in (prefill_ladder or ()))
            if any(not 1 <= b <= window for b in buckets):
                raise ValueError(f"prefill_ladder entries must be in "
                                 f"[1, {window}], got {buckets}")
            buckets = [b for b in buckets if b < window]
        self._prefill_ladder = buckets + [window]
        self._slots = int(slots)
        self._pipelined = bool(pipelined)
        self._horizon = max(1, int(decode_horizon))
        self._window = window
        self._tick_timeout = tick_timeout_s
        self._seed = int(seed)
        self._queue: list[_GenRequest] = []
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._running = False
        self._active: list = []
        self.stats = GenStats()

    # ---- client API ------------------------------------------------------
    def submit(self, prompt_ids, max_new: int, eos_id: int | None = None, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> Future:
        """Queue a request; the Future resolves with np.int64
        [prompt + generated]."""
        return self._enqueue(prompt_ids, max_new, eos_id, temperature,
                             top_k, top_p, None).future

    def submit_stream(self, prompt_ids, max_new: int,
                      eos_id: int | None = None, *,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0) -> StreamHandle:
        """Like submit, but returns a StreamHandle yielding each generated
        token id as the scheduler accepts it (up to decode_horizon at
        once)."""
        return StreamHandle(self._enqueue(prompt_ids, max_new, eos_id,
                                          temperature, top_k, top_p,
                                          queue.Queue()))

    def _enqueue(self, prompt_ids, max_new, eos_id, temperature, top_k,
                 top_p, stream_q) -> _GenRequest:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self._window:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"the window {self._window}")
        if not (0 <= top_p <= 1.0):
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        req = _GenRequest(prompt=prompt, max_new=max_new, eos_id=eos_id,
                          temperature=float(temperature), top_k=int(top_k),
                          top_p=float(top_p), stream_q=stream_q)
        with self._cv:
            if not self._running:
                raise RuntimeError("service not started")
            self._queue.append(req)
            self.stats.requests += 1
            self._cv.notify()
        return req

    def warmup(self) -> "GenerationService":
        """Run one admission at the smallest bucket and one decode block
        of the serving shape outside the serving window: the kernel
        libraries build and load, and the allocator and the torch
        library kernels initialise. Eager PyTorch compiles nothing per
        shape, so the JAX package's per-bucket warm-up has no
        counterpart. Call before start()."""
        n = self._slots
        caches = self._dec.init_cache(n)
        zeros = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int64)
        ones = np.ones(n, np.float32)
        window = np.zeros((n, self._prefill_ladder[0]), np.float32)
        window[:, 0] = 1.0
        tok, caches = self._dec.prefill_install(
            window, np.ones(n, np.int64), self._seed, 0, zeros, topk, ones,
            caches, np.arange(n))
        out, last, caches = self._dec.decode_block(
            tok, np.ones(n, np.int64), caches, self._seed, 1, zeros, topk,
            ones, self._horizon,
            attn_impl="kernel" if self._attn_auto else "default")
        if self._pipelined:
            self._dec.merge_tokens(np.zeros(n, np.int64), last,
                                   np.arange(n))
        out.cpu()
        return self

    def start(self) -> "GenerationService":
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="si-genservice")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        with self._cv:
            self._running = False
            self._cv.notify()
        if self._thread:
            self._thread.join(timeout=60 if drain else 5)
            self._thread = None

    # ---- scheduler loop --------------------------------------------------
    def _loop(self) -> None:
        try:
            if self._dec._device.type == "cuda":
                torch.cuda.set_device(self._dec._device)
            self._loop_inner()
        except BaseException as e:  # fail fast, never hang clients
            with self._cv:
                pending = list(self._queue)
                self._queue.clear()
                self._running = False
            for req in pending + [r for r in self._active if r]:
                if not req.future.done():
                    req.future.set_exception(e)
                if req.stream_q is not None:
                    req.stream_q.put(None)
            raise

    def _loop_inner(self) -> None:
        n = self._slots
        caches = self._dec.init_cache(n)
        active: list[_GenRequest | None] = [None] * n
        self._active = active
        bufs = np.zeros((n, self._window), np.int64)
        pos = np.zeros(n, np.int64)        # index of the token to feed
        deadline = np.zeros(n, np.int64)   # stop when the write reaches it
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int64)
        topp = np.ones(n, np.float32)
        seq = 0                            # generator step counter
        # the block in flight: (tokens, last tokens, k, fed positions,
        # live fraction) — dispatched, not yet fetched
        in_flight = None
        attn = "kernel" if self._attn_auto else "default"

        def dispatch(tokens, fed_pos, k):
            nonlocal caches, seq
            live = float(np.mean([r is not None for r in active]))
            seq += k
            toks, last, caches = self._dec.decode_block(
                tokens, fed_pos, caches, self._seed, seq - k + 1, temp,
                topk, topp, k, attn_impl=attn)
            return toks, last, k, np.asarray(fed_pos, np.int64), live

        def process(blk) -> None:
            # fetch the block's tokens (in pipelined mode its successor
            # already runs) and fold them into the row buffers
            toks_dev, _last, k, _fed, live = blk
            toks = toks_dev.cpu().numpy()               # [n, k]
            self.stats.steps += k
            self.stats.occupancy_sum += live * k
            for i in range(n):
                req = active[i]
                if req is None:
                    continue
                for j in range(k):
                    new_pos = pos[i] + 1  # index the fed token predicted
                    bufs[i, new_pos] = toks[i, j]
                    self.stats.tokens_out += 1
                    if req.stream_q is not None:
                        req.stream_q.put(int(toks[i, j]))
                    if (req.eos_id is not None
                            and toks[i, j] == req.eos_id) \
                            or new_pos + 1 >= deadline[i]:
                        self._finish(i, active, bufs, int(new_pos) + 1, req)
                        break
                    pos[i] = new_pos

        while True:
            with self._cv:
                have_active = any(r is not None for r in active)
                if not self._running and not self._queue \
                        and not have_active and in_flight is None:
                    return
                can_admit = bool(self._queue) and any(
                    r is None for r in active)
            if can_admit and in_flight is not None:
                # a chained block still carries the garbage tail of rows
                # that finished inside its predecessor: drain it before
                # rows are handed to new requests
                process(in_flight)
                in_flight = None
                continue
            with self._cv:
                admitted: list[tuple[int, _GenRequest]] = []
                for i in range(n):
                    if active[i] is None and self._queue:
                        req = self._queue.pop(0)
                        active[i] = req
                        admitted.append((i, req))
                if not admitted and not any(
                        r is not None for r in active) \
                        and in_flight is None:
                    if not self._running:
                        return
                    self._cv.wait(timeout=self._tick_timeout)
                    continue

            if admitted:
                # one batched prefill for the whole wave, at the smallest
                # bucket covering its longest prompt. The JAX package pads
                # the wave to the pool size (one compiled shape); eager
                # PyTorch compiles nothing, so only admitted rows run
                na = len(admitted)
                maxlen = max(len(r.prompt) for _, r in admitted)
                width = next(b for b in self._prefill_ladder if b >= maxlen)
                window = np.zeros((na, width), np.float32)
                lengths = np.ones(na, np.int64)
                rows = np.zeros(na, np.int64)
                t_a = np.zeros(na, np.float32)
                k_a = np.zeros(na, np.int64)
                p_a = np.ones(na, np.float32)
                for j, (i, req) in enumerate(admitted):
                    p = len(req.prompt)
                    window[j, :p] = req.prompt
                    lengths[j] = p
                    rows[j] = i
                    t_a[j], k_a[j], p_a[j] = (req.temperature, req.top_k,
                                              req.top_p)
                seq += 1
                tok, caches = self._dec.prefill_install(
                    window, lengths, self._seed, seq, t_a, k_a, p_a, caches,
                    rows)
                self.stats.prefills += len(admitted)
                for j, (i, req) in enumerate(admitted):
                    p = len(req.prompt)
                    bufs[i, :] = 0
                    bufs[i, :p] = req.prompt
                    deadline[i] = min(p + req.max_new, self._window)
                    temp[i], topk[i], topp[i] = (req.temperature,
                                                 req.top_k, req.top_p)
                if self._pipelined:
                    # enqueue the first decode block chained from the
                    # prefill's tokens on the device, then fetch them
                    pos_fed = pos.copy()
                    for j, (i, _req) in enumerate(admitted):
                        pos_fed[i] = lengths[j]
                    carry = bufs[np.arange(n),
                                 np.minimum(pos_fed, self._window - 1)]
                    tokens_dev = self._dec.merge_tokens(carry, tok, rows)
                    in_flight = dispatch(tokens_dev, pos_fed, self._horizon)
                nxt_a = tok.cpu().numpy()
                for j, (i, req) in enumerate(admitted):
                    p = len(req.prompt)
                    nxt = int(nxt_a[j])
                    bufs[i, p] = nxt
                    self.stats.tokens_out += 1
                    if req.stream_q is not None:
                        req.stream_q.put(nxt)
                    if (req.eos_id is not None and nxt == req.eos_id) \
                            or p + 1 >= deadline[i]:
                        self._finish(i, active, bufs, p + 1, req)
                    else:
                        pos[i] = p
            if not any(r is not None for r in active):
                if in_flight is not None:
                    process(in_flight)   # garbage block; rows all done
                    in_flight = None
                continue

            if in_flight is None:
                tokens = bufs[np.arange(n), pos]
                in_flight = dispatch(tokens, pos.copy(), self._horizon)
            nxt = None
            if self._pipelined:
                # the successor, chained from the in-flight block's last
                # tokens, goes in before the in-flight block is fetched
                pos_next = np.minimum(in_flight[3] + in_flight[2],
                                      self._window - 1)
                nxt = dispatch(in_flight[1], pos_next, self._horizon)
            process(in_flight)
            in_flight = nxt

    def _finish(self, i, active, bufs, end, req) -> None:
        out = bufs[i, :end].copy()
        self.stats.completed += 1
        self.stats.latency_sum_ms += (
            time.perf_counter() - req.t_submit) * 1e3
        active[i] = None
        if not req.future.done():
            req.future.set_result(out)
        if req.stream_q is not None:
            req.stream_q.put(None)       # end-of-stream sentinel
