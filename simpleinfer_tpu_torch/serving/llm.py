"""Continuous-batching text generation service: the counterpart of
simpleinfer_tpu/serving/llm.py (GenerationService and
TieredGenerationService).

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
work. A request holds its row until done, cancelled or past its
deadline (no preemption); priorities order the admission queue only.
A row freed while a chained block is in flight is admitted again only
after that block is drained, so its garbage never reaches the next
occupant.

Per dispatch the scheduler picks (as the JAX package does) the sampler
cap — the capped sampler when every live row is greedy or has 0 < top_k
<= cap, else the exact one — and the smallest kv_prefix rung covering
every live row's appends (full-horizon blocks only). Under
decode_attn="auto" the per-row decode kernel runs every block of a pool
of at least KERNEL_MIN_SLOTS, with a rung up to KERNEL_RUNG_MAX as its
max_len; sliding, softcapped and ALiBi models decode on torch
(CachedDecoder.kernel_ok). Both attention lineages serve, and sliding
models' pool caches are rings (a decode horizon of at most
CachedDecoder.RING_HEADROOM), which rungs never cut.

TieredGenerationService routes each request to the smallest of several
pools (each its own GenerationService with a window override) whose
window fits prompt + max_new.

The port compiles nothing per shape, so an uncapped admission wave
takes the smallest bucket too (the JAX package pads those to the window
to avoid an unwarmed executable).

On a tensor-parallel engine (EngineConfig.mesh, model > 1; every rank
builds the same service) the scheduler runs on the model axis' first
rank, the primary: each decoder call it makes (admissions, slots,
positions, cancellations are all in the calls' arguments) is broadcast
to the other ranks first (`_PlanCast`), whose follower loop replays it
on their heads, so every collective of the walk meets its peers.
Clients submit on the primary; stopping it stops the followers. The
tiers of a TieredGenerationService share one plan stream: each message
carries its tier, the primary's tiers send under their shared host
lock, and one follower loop a rank runs each call on its tier's decoder.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.mesh import AXIS_MODEL, axis_index, broadcast_object
from ..zoo.generate import CachedDecoder
from .batcher import fetch_async


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
    # set by GenerationService.cancel: an active row is freed at the next
    # drain, its future resolving with the tokens accepted so far
    cancelled: bool = False
    # absolute perf_counter deadline (submit's timeout_s): an expired
    # ACTIVE request resolves with its partial tokens, an expired QUEUED
    # one fails with TimeoutError when it would be admitted
    deadline_s: float | None = None
    # admission priority: higher first, FIFO within a class
    priority: int = 0


@dataclass
class GenStats:
    requests: int = 0
    completed: int = 0
    steps: int = 0
    prefills: int = 0
    tokens_out: int = 0
    occupancy_sum: float = 0.0
    latency_sum_ms: float = 0.0
    # decode steps dispatched on the capped sampler
    capped_steps: int = 0
    # active requests cancelled (their rows freed early); queued cancels
    # are not counted
    cancelled: int = 0
    # requests past their deadline (active: partial result; queued:
    # TimeoutError)
    timed_out: int = 0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(1, self.steps)

    @property
    def mean_latency_ms(self) -> float:
        return self.latency_sum_ms / max(1, self.completed)


class StreamHandle:
    """Iterator over one request's generated tokens (submit_stream):
    yields int ids as the scheduler accepts them and ends when the
    request completes (eos, max_new, cancel or deadline);
    `result(timeout)` returns the full [prompt + generated] array. If the
    request failed, iteration and result() raise."""

    def __init__(self, req: _GenRequest):
        self._req = req
        self.future = req.future

    def __iter__(self):
        while True:
            tok = self._req.stream_q.get()
            if tok is None:
                if not self.future.cancelled() and \
                        self.future.exception() is not None:
                    raise self.future.exception()
                return
            yield tok

    def result(self, timeout: float | None = None) -> np.ndarray:
        return self.future.result(timeout=timeout)


class _FairLock:
    """A lock taken in arrival order: a holder that releases and asks
    again queues behind the threads already waiting. The tiers of a
    TieredGenerationService share one, so that their schedulers take
    turns at their host work (see there)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._waiting: collections.deque = collections.deque()
        self._held = False

    def __enter__(self):
        me = object()
        with self._cv:
            self._waiting.append(me)
            while self._held or self._waiting[0] is not me:
                self._cv.wait()
            self._waiting.popleft()
            self._held = True

    def __exit__(self, *exc):
        with self._cv:
            self._held = False
            self._cv.notify_all()

    @contextlib.contextmanager
    def released(self):
        """Let the lock go for a wait, and take it back in turn."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()


class _PlanCast:
    """A CachedDecoder on a tensor-parallel rank whose calls are the
    model group's plan. On the primary every call of CALLS is first
    broadcast as (method, arguments), then run; a follower's `follow`
    receives the same calls in the same order and runs them on its own
    decoder. Device tensors and cache pools in the arguments (the
    results of earlier calls, such as a chained block's last tokens)
    travel as references to the result they came from, which each rank
    resolves to its own. Other attributes are the decoder's.

    `log`, when a list, takes every call of the plan on every rank as
    (call number, method, arguments, keyword arguments, result), the
    arguments in their broadcast form; `replay` runs such a log again
    from its first call.

    The tiers of a TieredGenerationService share one stream: every
    message goes out as (tier, message), and `peers` (the tiers' casts,
    in tier order; [self] alone) are the decoders a follower's loop
    runs each call on."""

    CALLS = ("init_cache", "prefill_install", "decode_block",
             "merge_tokens")
    #: results kept referable: the scheduler reads back at most the
    #: block in flight and its successor
    KEEP = 8
    #: an idle primary sends a tick this often, so that a follower's
    #: wait never reaches the process group's timeout
    IDLE_TICK_S = 60.0

    def __init__(self, dec: CachedDecoder, mesh):
        self._dec, self._mesh = dec, mesh
        self.primary = axis_index(mesh, AXIS_MODEL) == 0
        self.tier = 0
        self.peers = [self]
        self._n = 0
        self._by_id: dict = {}          # id(obj) -> (key, obj)
        self._by_key: dict = {}         # key -> obj
        self.last_send = time.monotonic()
        self.log: list | None = None

    def __getattr__(self, name):
        if name in self.CALLS:
            fn = getattr(self._dec, name)

            def call(*args, **kwargs):
                msg = ("call", name, self._encode(args),
                       {k: self._encode(v) for k, v in kwargs.items()})
                self.send(msg)
                return self._run(msg)
            return call
        return getattr(self._dec, name)

    def send(self, msg) -> None:
        broadcast_object((self.tier, msg), self._mesh, AXIS_MODEL, 0)
        self.last_send = time.monotonic()

    def follow(self, ends: int = 1) -> None:
        """Replay the primary's calls, each on its tier's decoder, until
        `ends` ends of a phase came (a tier's warmup, or its scheduler
        loop: one a tier)."""
        while True:
            tier, msg = broadcast_object(None, self._mesh, AXIS_MODEL, 0)
            if msg[0] == "end":
                ends -= 1
                if ends == 0:
                    return
            elif msg[0] == "call":
                self.peers[tier]._run(msg)

    def _run(self, msg):
        _, name, args, kwargs = msg
        result = self._register(getattr(self._dec, name)(
            *self._decode(args), **self._decode(kwargs)))
        if self.log is not None:
            self.log.append((self._n, name, args, kwargs, result))
        return result

    def replay(self, log) -> list:
        """Run the calls of `log` again, in order, on this (fresh) plan's
        decoder; returns their results. Every rank of the model group
        replays the same log together."""
        self._n = log[0][0] - 1 if log else 0
        return [self._run(("call", name, args, kwargs))
                for _n, name, args, kwargs, _r in log]

    def _register(self, result):
        """Number the tensors and cache pools of a call's result."""
        self._n += 1

        def walk(x, path):
            if isinstance(x, (torch.Tensor, dict)):
                key = (self._n,) + path
                self._by_id[id(x)] = (key, x)
                self._by_key[key] = x
            elif isinstance(x, tuple):
                for i, v in enumerate(x):
                    walk(v, path + (i,))

        walk(result, ())
        old = [k for k in self._by_key if k[0] <= self._n - self.KEEP]
        for k in old:
            obj = self._by_key.pop(k)
            if self._by_id.get(id(obj), (None,))[0] == k:
                del self._by_id[id(obj)]
        return result

    def _encode(self, x):
        if isinstance(x, (torch.Tensor, dict)):
            ref = self._by_id.get(id(x))
            if ref is None:
                raise ValueError("a device argument of a tensor-parallel "
                                 "decoder call must be an earlier call's "
                                 "result")
            return ("__ref__", ref[0])
        if isinstance(x, (tuple, list)):
            return type(x)(self._encode(v) for v in x)
        return x

    def _decode(self, x):
        if isinstance(x, tuple) and len(x) == 2 and x[0] == "__ref__":
            return self._by_key[x[1]]
        if isinstance(x, (tuple, list)):
            return type(x)(self._decode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._decode(v) for k, v in x.items()}
        return x


def _ladder(value, window: int, auto: list, name: str) -> list:
    """Sorted rung / bucket widths of `value` ("auto" -> `auto`, an int,
    a sequence or None), each in [1, window], those below the window."""
    if isinstance(value, str):
        if value != "auto":
            raise ValueError(f"{name} must be a sequence, None or 'auto', "
                             f"got {value!r}")
        return sorted(auto)
    if isinstance(value, int):
        value = (value,)
    out = sorted(int(b) for b in (value or ()))
    if any(not 1 <= b <= window for b in out):
        raise ValueError(f"{name} entries must be in [1, {window}], got "
                         f"{out}")
    return [b for b in out if b < window]


class GenerationService:
    """Slot-scheduled generation over one causal-LM engine.

        svc = GenerationService(engine, slots=16).start()
        ids = svc.submit([1, 5, 9], max_new=32, eos_id=2).result()
        svc.stop()

    Greedy requests (temperature = 0) are deterministic; scratch blocks,
    rungs and the decode kernel change only the f32 summation order.
    Sampled requests draw from the service's seed stream: their draws
    depend on admission timing and, in auto cap mode, on which sampler
    each block ran (CachedDecoder.generate(seed=...) reproduces one).
    """

    #: the cap of sample_cap="auto": top-64 covers greedy and top_k <= 64
    #: exactly (the JAX package's value). On an H100, 16 rows (8 at top-k
    #: 40) over 32000 logits: the capped sampler alone 0.202 ms against
    #: the exact one's 0.279, a llama "base" decode step 3.88 against
    #: 3.97 ms on the card (chip_smoke.sample_cap_readings, PERF.md)
    DEFAULT_SAMPLE_CAP = 64
    #: smallest pool where decode_attn="auto" dispatches the per-row
    #: decode kernel: on an H100 a decode step's frozen-cache attention
    #: through the kernel beats the torch route at every pool size from
    #: 1 slot (1.05x) to 16 (7.7x) (chip_smoke.decode_slots_sweep,
    #: PERF.md); the JAX package's TPU crossover was 16
    KERNEL_MIN_SLOTS = 1
    #: the largest rung decode_attn="auto" hands the decode kernel as its
    #: max_len; a block on a larger rung reads through the kernel with
    #: the window's split count. decode_attention alone for a decode step
    #: at 16 slots, window 2048, on an H100 (chip_smoke.rung_sweep,
    #: PERF.md), max_len = the rung vs the window: rung 256 0.278 vs
    #: 0.288 ms, 512 0.439 vs 0.379, 1024 0.560 vs 0.481. The rung-cut
    #: torch route (the JAX package's choice on a TPU) lost to both on
    #: every pool (a step's whole frozen-cache attention 2.79 / 4.48 /
    #: 8.82 ms against the kernel route's 1.68 / 1.85 / 1.94)
    KERNEL_RUNG_MAX = 256

    def __init__(self, engine, slots: int = 8, tick_timeout_s: float = 0.01,
                 seed: int = 0, decode_horizon: int = 1,
                 adaptive_horizon: bool = False,
                 pipelined: bool = True, kv_dtype: str | None = None,
                 scratch_blocks: bool = True,
                 sample_cap: int | None | str = "auto",
                 kv_prefix_ladder: tuple | list | str | None = "auto",
                 prefill_ladder: tuple | list | str | None = "auto",
                 decode_attn: str = "auto", window: int | None = None):
        """sample_cap: "auto" (the capped sampler of DEFAULT_SAMPLE_CAP
        candidates per dispatch whenever every live row is greedy or
        has 0 < top_k <= cap, else the exact sampler: auto never
        truncates), an int (that cap on every dispatch; out-of-regime
        rows are truncated, warned once) or None (the exact sampler).

        kv_prefix_ladder: ascending rungs; a full-horizon block reads
        the smallest rung covering max(live pos) + K of the
        position-indexed caches. "auto" = {window/8, /4, /2} >= 64; None
        = the whole window every block.

        prefill_ladder: admission bucket widths; "auto" = {64, 256, 1024}
        below the window plus the window itself.

        decode_attn: "torch" (torch attention over the cache, cut to the
        rung), "kernel" (every block runs the per-row decode kernel, the
        rung as its max_len) or "auto" (the kernel at slots >=
        KERNEL_MIN_SLOTS when the decoder allows it, rungs up to
        KERNEL_RUNG_MAX as its max_len; else torch).

        adaptive_horizon: while requests wait, cap each block (pow2 of
        the horizon) at the nearest live deadline so freed rows admit
        sooner. The JAX package's default (False) stands; PERF.md has
        the H100 reading.

        window: a cache length below the model's seq_len (the tiers of
        TieredGenerationService); submit rejects rows that could outgrow
        it. Over ring caches decode_horizon is at most
        CachedDecoder.RING_HEADROOM: the JAX service fails at its first
        decode block past it, this one when it is built."""
        if decode_attn not in ("torch", "kernel", "auto"):
            raise ValueError(f"decode_attn must be 'torch', 'kernel' or "
                             f"'auto', got {decode_attn!r}")
        if isinstance(sample_cap, str):
            if sample_cap != "auto":
                raise ValueError(f"sample_cap must be an int, None or "
                                 f"'auto', got {sample_cap!r}")
            self._cap_mode, self._cap = "auto", self.DEFAULT_SAMPLE_CAP
        elif sample_cap is None:
            self._cap_mode, self._cap = "off", None
        else:
            self._cap_mode, self._cap = "fixed", int(sample_cap)
        self._cap_warned = False
        self._dec = CachedDecoder(
            engine, kv_dtype=kv_dtype, scratch_blocks=scratch_blocks,
            sample_cap=self._cap if self._cap_mode == "fixed" else None,
            decode_attn="kernel" if decode_attn == "kernel" else "torch",
            window=window)
        mesh = getattr(engine, "mesh", None)
        # a tensor-parallel engine: the primary's decoder calls are the
        # followers' plan
        self._cast = _PlanCast(self._dec, mesh) if mesh is not None \
            else None
        if self._cast is not None:
            self._dec = self._cast
        self._attn_auto = (decode_attn == "auto"
                           and slots >= self.KERNEL_MIN_SLOTS
                           and self._dec.kernel_ok)
        if self._dec._has_ring and decode_horizon > self._dec.RING_HEADROOM:
            raise ValueError(
                f"decode blocks over ring-stored sliding caches are "
                f"limited to {self._dec.RING_HEADROOM} steps, got "
                f"decode_horizon {decode_horizon}")
        window = self._dec._window
        self._prefix_ladder = _ladder(
            kv_prefix_ladder, window,
            {p for p in (window // 8, window // 4, window // 2) if p >= 64},
            "kv_prefix_ladder")
        self._prefill_ladder = _ladder(
            prefill_ladder, window, [b for b in (64, 256, 1024)
                                     if b < window], "prefill_ladder") \
            + [window]
        self._slots = int(slots)
        self._pipelined = bool(pipelined)
        self._horizon = max(1, int(decode_horizon))
        self._adaptive = bool(adaptive_horizon)
        # the block sizes the loop may dispatch: the pow2 ladder under
        # adaptivity, else the horizon alone
        ks, k = [], self._horizon
        while k >= 1:
            ks.append(k)
            if not self._adaptive:
                break
            k //= 2
        self._block_ladder = ks
        self._window = window
        self._tick_timeout = tick_timeout_s
        self._seed = int(seed)
        self._queue: list[_GenRequest] = []
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._running = False
        self._active: list = []
        # held by the scheduler for each pass of its loop, but not while
        # it idles or waits on the card (_fetch); TieredGenerationService
        # gives its tiers one between them
        self._host = _FairLock()
        self.stats = GenStats()

    # ---- client API ------------------------------------------------------
    def submit(self, prompt_ids, max_new: int, eos_id: int | None = None, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               timeout_s: float | None = None, priority: int = 0) -> Future:
        """Queue a request; the Future resolves with np.int64
        [prompt + generated].

        timeout_s: a deadline — an ACTIVE request past it resolves with
        the tokens accepted so far; a QUEUED one fails with TimeoutError
        instead of being admitted. priority: higher admits first (FIFO
        within a class); rows already held are never preempted."""
        return self._enqueue(prompt_ids, max_new, eos_id, temperature,
                             top_k, top_p, None, timeout_s,
                             priority).future

    def submit_stream(self, prompt_ids, max_new: int,
                      eos_id: int | None = None, *,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, timeout_s: float | None = None,
                      priority: int = 0) -> StreamHandle:
        """Like submit, but returns a StreamHandle yielding each generated
        token id as the scheduler accepts it (up to decode_horizon at
        once)."""
        return StreamHandle(self._enqueue(
            prompt_ids, max_new, eos_id, temperature, top_k, top_p,
            queue.Queue(), timeout_s, priority))

    @property
    def follower(self) -> bool:
        """True on a tensor-parallel rank that replays the primary's
        plan (no scheduler, no clients)."""
        return self._cast is not None and not self._cast.primary

    def _enqueue(self, prompt_ids, max_new, eos_id, temperature, top_k,
                 top_p, stream_q, timeout_s=None,
                 priority=0) -> _GenRequest:
        if self.follower:
            raise RuntimeError(
                "submit on the primary rank: this rank of the tensor-"
                "parallel service replays the primary's plan")
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
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        # only a FIXED cap truncates; auto mode routes out-of-regime rows
        # to the exact sampler
        if (self._cap_mode == "fixed" and temperature > 0.0
                and not 0 < top_k <= self._cap and not self._cap_warned):
            self._cap_warned = True
            logging.getLogger(__name__).warning(
                "sample_cap=%d is active but a request sampled with "
                "top_k=%d — its draw is truncated to the top-%d "
                "candidates (exact only for 0 < top_k <= cap); further "
                "occurrences are not logged", self._cap, top_k, self._cap)
        req = _GenRequest(
            prompt=prompt, max_new=max_new, eos_id=eos_id,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), stream_q=stream_q,
            deadline_s=None if timeout_s is None
            else time.perf_counter() + timeout_s,
            priority=int(priority))
        with self._cv:
            if not self._running:
                raise RuntimeError("service not started")
            # before the first strictly lower priority: higher first,
            # FIFO within a class, and a 0 jumps queued negatives
            at = next((i for i, q in enumerate(self._queue)
                       if q.priority < req.priority), len(self._queue))
            self._queue.insert(at, req)
            self.stats.requests += 1
            self._cv.notify()
        return req

    def cancel(self, future: Future) -> bool:
        """Cancel a submitted request (a client that went away). A QUEUED
        request is removed and its future cancelled (result() raises
        CancelledError). An ACTIVE request's row is freed at the
        scheduler's next drain and its future resolves with the tokens
        accepted so far; its stream ends. Returns True if the request
        was queued or active, False if unknown or finished."""
        with self._cv:
            for i, req in enumerate(self._queue):
                if req.future is future:
                    self._queue.pop(i)
                    req.future.cancel()
                    if req.stream_q is not None:
                        req.stream_q.put(None)
                    return True
            for req in self._active:
                if req is not None and req.future is future:
                    req.cancelled = True
                    self._cv.notify()
                    return True
        return False

    def warmup(self) -> "GenerationService":
        """Run, outside the serving window, one admission wave and one
        decode block of every kind the loop may dispatch: each block
        size of the ladder, each rung at the full horizon with the
        attention route it takes there, and in auto cap mode the exact
        sampler too. The kernel libraries build and load, and the
        allocator and the torch library kernels initialise. Eager
        PyTorch compiles nothing per shape, so one admission at the
        smallest bucket stands for the JAX package's per-bucket ones.
        Call before start(), on every rank of a tensor-parallel engine
        (a follower replays the primary's warmup)."""
        if self.follower:
            self._cast.follow()
            return self
        try:
            self._warmup_calls()
        finally:
            if self._cast is not None:
                self._cast.send(("end",))
        return self

    def _warmup_calls(self) -> None:
        n = self._slots
        caches = self._dec.init_cache(n)
        zeros = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int64)
        ones = np.ones(n, np.float32)
        toks = np.ones(n, np.int64)
        window = np.zeros((n, self._prefill_ladder[0]), np.float32)
        window[:, 0] = 1.0
        caps = [self._cap, None] if self._cap_mode == "auto" \
            else ["default"]
        full = self._block_ladder[0]
        out = last = None
        for ci, cap in enumerate(caps):
            _, caches = self._dec.prefill_install(
                window, np.ones(n, np.int64), self._seed, 0, zeros, topk,
                ones, caches, np.arange(n), sample_cap=cap)
            blocks = [(k, None) for k in self._block_ladder]
            if ci == 0:
                blocks += [(full, p) for p in self._prefix_ladder]
            for k, rung in blocks:
                attn, prefix = self._route(rung)
                out, last, caches = self._dec.decode_block(
                    toks, np.ones(n, np.int64), caches, self._seed, 1,
                    zeros, topk, ones, k, prefix, sample_cap=cap,
                    attn_impl=attn)
        if self._pipelined:
            self._dec.merge_tokens(np.zeros(n, np.int64), last,
                                   np.arange(n))
        out.cpu()

    def _route(self, rung) -> tuple:
        """(attn_impl, kv_prefix) of a block whose live rows a rung (or
        None) covers: the decoder's own attention and the rung outside
        auto mode; under auto the kernel, the rung its max_len up to
        KERNEL_RUNG_MAX."""
        if not self._attn_auto:
            return "default", rung
        return "kernel", (rung if rung is not None
                          and rung <= self.KERNEL_RUNG_MAX else None)

    def start(self) -> "GenerationService":
        self._running = True
        self._thread = threading.Thread(
            target=self._follow if self.follower else self._loop,
            daemon=True, name="si-genservice")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler (after the queue drains, with drain). On a
        follower: wait until the primary stops."""
        with self._cv:
            self._running = False
            self._cv.notify()
        if self._thread:
            self._thread.join(timeout=None if self.follower
                              else 60 if drain else 5)
            self._thread = None

    def _follow(self, ends: int = 1) -> None:
        dev = self._cast._dec._device
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        self._cast.follow(ends)

    # ---- scheduler loop --------------------------------------------------
    def _fetch(self, toks) -> np.ndarray:
        """A block's or a wave's tokens on the host: the copy is queued
        under the host lock, the wait for the card runs outside it, so
        another tier's scheduler enqueues its launches meanwhile."""
        host, done = fetch_async(toks)
        if done is not None:
            with self._host.released():
                done.synchronize()
        return host.numpy()

    def _loop(self) -> None:
        try:
            dev = self._dec._device
            if dev.type == "cuda" and dev.index is not None:
                # a bare "cuda" is the thread's current device already
                torch.cuda.set_device(dev)
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
        finally:
            self._end_followers()

    def _end_followers(self) -> None:
        """The primary's scheduler has ended: so do the followers' loops
        (a process group that already failed is logged, not raised)."""
        if self._cast is None:
            return
        try:
            with self._host:         # the tiers' sends share one stream
                self._cast.send(("end",))
        except Exception:  # noqa: BLE001 (a boundary: the loop is over)
            logging.getLogger(__name__).exception(
                "could not stop the tensor-parallel followers")

    def _loop_inner(self) -> None:
        n = self._slots
        with self._host:             # a decoder call: the tiers' stream
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
        # live fraction, capped) — dispatched, not yet fetched
        in_flight = None

        def choose_k(pos_now) -> int:
            # while requests wait, cap the block (pow2 ladder) at the
            # nearest live deadline, so a freed row admits sooner
            k = self._horizon
            with self._cv:
                waiting = len(self._queue)
            if self._adaptive and waiting and k > 1:
                rem = min(int(deadline[i]) - int(pos_now[i]) - 1
                          for i in range(n) if active[i] is not None)
                k = max((v for v in self._block_ladder
                         if v <= max(1, rem)), default=1)
            return k

        def choose_prefix(fed_pos, k):
            # the smallest rung covering every LIVE row's appends (pos ..
            # pos + k - 1 readable: rung >= pos + k), full-horizon blocks
            # only. A row that finished inside the in-flight block still
            # counts as live here, so the pool stays on its larger rung
            # one block longer: a superset read, correct
            if k != self._horizon or not self._prefix_ladder:
                return None
            live = [int(fed_pos[i]) for i in range(n)
                    if active[i] is not None]
            need = (max(live) if live else 0) + k
            return next((p for p in self._prefix_ladder if p >= need), None)

        def choose_cap(reqs):
            # auto: the capped sampler is exact when every row is greedy
            # or has 0 < top_k <= cap; one out-of-regime row takes the
            # whole dispatch to the exact sampler (auto never truncates)
            if self._cap_mode != "auto":
                return "default"
            ok = all(r.temperature <= 0.0 or 0 < r.top_k <= self._cap
                     for r in reqs)
            return self._cap if ok else None

        def dispatch(tokens, fed_pos, k):
            # k decode steps for the whole pool; rows that finish inside
            # the block decode garbage for its tail, discarded in process
            nonlocal caches, seq
            live = float(np.mean([r is not None for r in active]))
            seq += k
            cap = choose_cap([r for r in active if r is not None])
            attn, prefix = self._route(choose_prefix(fed_pos, k))
            toks, last, caches = self._dec.decode_block(
                tokens, fed_pos, caches, self._seed, seq - k + 1, temp,
                topk, topp, k, prefix, sample_cap=cap, attn_impl=attn)
            capped = (self._cap is not None if cap == "default"
                      else cap is not None)
            return toks, last, k, np.asarray(fed_pos, np.int64), live, capped

        def process(blk) -> None:
            # fetch the block's tokens (in pipelined mode its successor
            # already runs) and fold them into the row buffers
            toks_dev, _last, k, _fed, live, capped = blk
            toks = self._fetch(toks_dev)                # [n, k]
            self.stats.steps += k
            if capped:
                self.stats.capped_steps += k
            self.stats.occupancy_sum += live * k
            for i in range(n):
                req = active[i]
                if req is None:
                    continue
                expired = (req.deadline_s is not None
                           and time.perf_counter() > req.deadline_s)
                if req.cancelled or expired:
                    # free the row; resolve with the tokens accepted
                    # BEFORE this block (its tokens are discarded)
                    if req.cancelled:
                        self.stats.cancelled += 1
                    else:
                        self.stats.timed_out += 1
                    self._finish(i, active, bufs, int(pos[i]) + 1, req)
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
            idle_tick = False
            with self._cv:
                if not self._queue and in_flight is None and \
                        all(r is None for r in active):
                    if not self._running:
                        return       # stopped, and nothing left to serve
                    self._cv.wait(timeout=self._tick_timeout)
                    idle_tick = self._cast is not None and (
                        time.monotonic() - self._cast.last_send
                        > self._cast.IDLE_TICK_S)
                    if not idle_tick:
                        continue
                can_admit = bool(self._queue) and any(
                    r is None for r in active)
            if idle_tick:
                with self._host:     # the tiers' sends share one stream
                    self._cast.send(("tick",))
                continue
            # the pass runs under the host lock, the wait above outside it
            with self._host:
                if can_admit and in_flight is not None:
                    # a chained block still carries the garbage tail of rows
                    # freed inside its predecessor (finished, cancelled or
                    # expired): drain it before rows are handed to new
                    # requests
                    process(in_flight)
                    in_flight = None
                    continue
                with self._cv:
                    admitted: list[tuple[int, _GenRequest]] = []
                    for i in range(n):
                        while active[i] is None and self._queue:
                            req = self._queue.pop(0)
                            if (req.deadline_s is not None
                                    and time.perf_counter() > req.deadline_s):
                                self.stats.timed_out += 1
                                if not req.future.done():
                                    req.future.set_exception(TimeoutError(
                                        "request deadline passed while "
                                        "queued"))
                                if req.stream_q is not None:
                                    req.stream_q.put(None)
                                continue
                            active[i] = req
                            admitted.append((i, req))

                if admitted:
                    # one batched prefill for the whole wave, at the smallest
                    # bucket covering its longest prompt. The JAX package pads
                    # the wave to the pool size (one compiled shape); eager
                    # PyTorch compiles nothing, so only admitted rows run
                    na = len(admitted)
                    maxlen = max(len(r.prompt) for _, r in admitted)
                    width = next(b for b in self._prefill_ladder
                                 if b >= maxlen)
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
                        window, lengths, self._seed, seq, t_a, k_a, p_a,
                        caches, rows,
                        sample_cap=choose_cap([r for _, r in admitted]))
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
                        in_flight = dispatch(tokens_dev, pos_fed,
                                             choose_k(pos_fed))
                    nxt_a = self._fetch(tok)
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
                    in_flight = dispatch(tokens, pos.copy(), choose_k(pos))
                nxt = None
                if self._pipelined:
                    # the successor, chained from the in-flight block's last
                    # tokens, goes in before the in-flight block is fetched
                    pos_next = np.minimum(in_flight[3] + in_flight[2],
                                          self._window - 1)
                    nxt = dispatch(in_flight[1], pos_next, choose_k(pos_next))
                process(in_flight)
                in_flight = nxt

    def _finish(self, i, active, bufs, end, req) -> None:
        out = bufs[i, :end].copy()
        self.stats.completed += 1
        self.stats.latency_sum_ms += (
            time.perf_counter() - req.t_submit) * 1e3
        active[i] = None
        # the future may have been cancelled directly by its client (not
        # through self.cancel): setting a result on it would raise and
        # end the scheduler
        if not req.future.done():
            req.future.set_result(out)
        if req.stream_q is not None:
            req.stream_q.put(None)       # end-of-stream sentinel


class TieredGenerationService:
    """Tiered KV pools: each request goes to the SMALLEST tier whose
    window fits len(prompt) + max_new.

    A uniform pool allocates the model's whole window per slot though
    most requests are short. Several GenerationServices over the same
    engine (weights shared; caches per tier through CachedDecoder
    (window=...)) give more slots for the same cache bytes. A row's
    total length is bounded at admission, so it never outgrows its tier
    and its tokens are the single-tier service's. Each tier runs its own
    scheduler thread, and the tiers share one host lock, so that their
    schedulers take turns a whole pass at a time, each waiting for the
    card outside it: two eager walks interleaved op by op under the
    interpreter lock handed it over at every torch call, and each decode
    step took about 3x its host time on an H100's host (PERF.md).

    tiers: (slots, window) pairs, windows strictly ascending; the last
    window may be None (the model's seq_len). kwargs go to every
    GenerationService.

    On a tensor-parallel engine the tiers' plans share one stream
    (_PlanCast): the primary's schedulers send their decoder calls
    tagged with their tier, under the shared host lock, so the calls
    reach the stream in the order they run; a follower runs one loop
    that replays each call on its tier's decoder, and refuses clients.
    """

    def __init__(self, engine, tiers=((8, 512), (8, None)), **kwargs):
        if not tiers:
            raise ValueError("need at least one (slots, window) tier")
        self.services = [GenerationService(engine, slots=int(slots),
                                           window=window, **kwargs)
                         for slots, window in tiers]
        wins = [svc._window for svc in self.services]
        if wins != sorted(wins) or len(set(wins)) != len(wins):
            raise ValueError(
                f"tier windows must be strictly ascending, got {wins}")
        self.windows = wins
        host = _FairLock()
        for svc in self.services:
            svc._host = host
        casts = [svc._cast for svc in self.services]
        if casts[0] is not None:
            for i, cast in enumerate(casts):
                cast.tier, cast.peers = i, casts
        self._follow_thread: threading.Thread | None = None

    @property
    def follower(self) -> bool:
        """True on a tensor-parallel rank that replays the primary's
        tiers (no schedulers, no clients)."""
        return self.services[0].follower

    # ---- lifecycle (every tier) -----------------------------------------
    def warmup(self) -> "TieredGenerationService":
        for svc in self.services:
            svc.warmup()
        return self

    def start(self) -> "TieredGenerationService":
        if self.follower:
            # one loop for the tiers' one stream, until every tier ended
            svc = self.services[0]
            self._follow_thread = threading.Thread(
                target=svc._follow, kwargs={"ends": len(self.services)},
                daemon=True, name="si-genservice-tiers")
            self._follow_thread.start()
            return self
        for svc in self.services:
            svc.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop every tier's scheduler; on a follower, wait until the
        primary's tiers have all stopped."""
        if self._follow_thread is not None:
            self._follow_thread.join()
            self._follow_thread = None
        for svc in self.services:
            svc.stop(drain=drain)

    # ---- routing ----------------------------------------------------------
    def _route(self, prompt_ids, max_new: int) -> GenerationService:
        need = len(prompt_ids) + int(max_new)
        for svc in self.services:
            if need <= svc._window:
                return svc
        raise ValueError(
            f"prompt ({len(prompt_ids)}) + max_new ({max_new}) exceeds "
            f"the largest tier window {self.windows[-1]}")

    def submit(self, prompt_ids, max_new: int, *args, **kwargs) -> Future:
        return self._route(prompt_ids, max_new).submit(
            prompt_ids, max_new, *args, **kwargs)

    def submit_stream(self, prompt_ids, max_new: int, *args, **kwargs):
        return self._route(prompt_ids, max_new).submit_stream(
            prompt_ids, max_new, *args, **kwargs)

    def cancel(self, future: Future) -> bool:
        return any(svc.cancel(future) for svc in self.services)

    # ---- accounting -------------------------------------------------------
    @property
    def stats(self) -> GenStats:
        """Stats summed over the tiers (each tier's in
        .services[i].stats)."""
        agg = GenStats()
        for svc in self.services:
            for f in GenStats.__dataclass_fields__:
                setattr(agg, f, getattr(agg, f) + getattr(svc.stats, f))
        return agg

    def cache_bytes(self) -> int:
        """KV-pool bytes over the tiers, from the leaf shapes
        (CachedDecoder.cache_nbytes): nothing is allocated to count
        them."""
        return sum(svc._dec.cache_nbytes(svc._slots)
                   for svc in self.services)
