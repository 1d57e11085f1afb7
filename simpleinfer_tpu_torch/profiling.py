"""Observability: roofline accounting, device timing, kernel profiles,
instrumented runs — the counterpart of simpleinfer_tpu/profiling.py.

- roofline_report / summarize_roofline(program): per-op FLOPs, weight
  and output bytes, arithmetic intensity and the compute-or-bandwidth
  verdict against a ChipSpec (default `H100`), from the FLOP counts and
  inferred shapes of executor.Program.
- measure_device_time(fn, *args): the card's time per call from CUDA
  events (the host clock for CPU tensors).
- chip_speed_factor(): the card's bf16 GEMM rate now against its healthy
  reading.
- trace(logdir): torch.profiler around a block (a Chrome trace into
  logdir); device_profile(fn, *args): rows per CUDA kernel of `iters`
  traced calls (self device time, count, category, GFLOP/s where the
  FLOPs are given); format_kernel_stats renders them.
- timed_run / attribute_slices: op by op with a synchronise after each
  op; the forward cut into segments of even FLOPs, each timed by CUDA
  events between its ops.

Names that differ from the JAX package's, because theirs name an XLA
means: `V5E` is `H100` (the spec), ChipSpec's `vmem_mb` is `l2_mb`;
`hlo_stats(trace_dir)`, which parses xprof's .xplane.pb, is
`kernel_stats(prof)`, which reads torch.profiler's key_averages(), with
`KERNEL_STAT_KEYS` for `_HLO_STAT_KEYS` and `format_kernel_stats` for
`format_hlo_stats`; `trace` yields the torch.profiler profile (its
Chrome trace goes into logdir). measure_device_time has no XLA
`compiler_options` or `precompile`: eager PyTorch compiles nothing, so
there is no two-point loop to time either.

On CUDA tensors every timer here reads the card (CUDA events,
torch.profiler's device rows) and fails rather than fall back to the
host clock; only CPU tensors are timed by the host.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass

import torch

from .quant.tensor import (Quantized4Tensor, QuantizedActivation,
                           QuantizedTensor)


@dataclass(frozen=True)
class ChipSpec:
    """Peak numbers used for roofline ratios. The default is NVIDIA's
    data sheet for the H100 SXM at its 700 W power limit: dense bf16
    989 TFLOP/s on the tensor cores, float32 67 TFLOP/s outside them
    (the port's fp32 parity mode keeps TF32 off), 3.35 TB/s of HBM3 and
    50 MB of L2. A card set below 700 W (nvidia-smi's power.limit) runs
    below these under load."""

    name: str = "h100-sxm-700w"
    peak_bf16_tflops: float = 989.0
    peak_fp32_tflops: float = 67.0
    hbm_gbps: float = 3350.0
    l2_mb: float = 50.0

    def peak_tflops(self, dtype: str) -> float:
        return (self.peak_fp32_tflops if dtype == "float32"
                else self.peak_bf16_tflops)


H100 = ChipSpec()


@dataclass
class OpCost:
    name: str
    type: str
    flops: int
    weight_bytes: int
    out_bytes: int
    out_shape: list

    @property
    def bytes_total(self) -> int:
        return self.weight_bytes + self.out_bytes

    @property
    def intensity(self) -> float:
        """FLOPs per byte moved (weights + outputs; inputs are usually a
        prior op's output already counted once)."""
        return self.flops / max(self.bytes_total, 1)

    def bound(self, spec: ChipSpec = H100, dtype: str = "bfloat16") -> str:
        ridge = spec.peak_tflops(dtype) * 1e12 / (spec.hbm_gbps * 1e9)
        return "compute" if self.intensity >= ridge else "bandwidth"

    def min_time_us(self, spec: ChipSpec = H100,
                    dtype: str = "bfloat16") -> float:
        """Speed-of-light time: max of compute and bandwidth floors."""
        t_c = self.flops / (spec.peak_tflops(dtype) * 1e12)
        t_b = self.bytes_total / (spec.hbm_gbps * 1e9)
        return max(t_c, t_b) * 1e6


def _nbytes(weights: dict) -> int:
    """Bytes of an op's weights as held: a quantized tensor counts its
    own int8 data or packed nibbles and its f32 scales."""
    total = 0
    for w in weights.values():
        if isinstance(w, QuantizedTensor):
            parts = (w.data, w.scale)
        elif isinstance(w, Quantized4Tensor):
            parts = (w.packed, w.scale)
        elif isinstance(w, torch.Tensor):
            parts = (w,)
        else:
            parts = ()
        total += sum(t.numel() * t.element_size() for t in parts)
    return int(total)


def roofline_report(program, batch: int = 1, dtype_bytes: int = 2) -> list:
    """Per-op cost table from the lowered Program (executor.Program).

    Uses the inferred op shapes (program.op_output_shapes) with their
    batch taken as 1 and scaled by `batch`; output element size =
    dtype_bytes (2 for bf16). Raises when the program has no op shapes
    (an undeclared input shape, an op that cannot run on fake tensors)
    rather than count part of the model."""
    if program.op_output_shapes is None:
        raise ValueError(
            "no roofline: the program's op shapes are unknown (an input's "
            "shape is undeclared, or an op could not run on fake tensors)")
    out = []
    for impl in program.impls:
        shapes = program.op_output_shapes[impl.name]
        flops = program.op_flops(impl) * batch
        out_bytes = sum(
            batch * int(math.prod(s[1:])) * dtype_bytes if s else 0
            for s in shapes)
        out.append(OpCost(
            name=impl.name, type=impl.type, flops=flops,
            weight_bytes=_nbytes(impl.weights), out_bytes=out_bytes,
            out_shape=shapes[0] if shapes else []))
    return out


def summarize_roofline(program, batch: int = 1, spec: ChipSpec = H100,
                       dtype: str = "bfloat16", top: int = 10) -> str:
    """Human-readable roofline table + speed-of-light total."""
    costs = roofline_report(
        program, batch, dtype_bytes=4 if dtype == "float32" else 2)
    costs.sort(key=lambda c: -c.min_time_us(spec, dtype))
    sol_us = sum(c.min_time_us(spec, dtype) for c in costs)
    total_flops = sum(c.flops for c in costs)
    lines = [
        f"model: {len(costs)} ops, {total_flops / 1e9:.2f} GFLOP/batch{batch},"
        f" speed-of-light {sol_us / 1e3:.3f} ms on {spec.name} ({dtype})",
        f"{'op':28s} {'type':18s} {'GFLOP':>8s} {'MB':>8s} {'int.':>7s} "
        f"{'bound':>9s} {'SoL us':>8s}",
    ]
    for c in costs[:top]:
        lines.append(
            f"{c.name[:28]:28s} {c.type[:18]:18s} {c.flops / 1e9:8.3f} "
            f"{c.bytes_total / 1e6:8.2f} {c.intensity:7.1f} "
            f"{c.bound(spec, dtype):>9s} {c.min_time_us(spec, dtype):8.1f}")
    return "\n".join(lines)


def _device_of(args, device) -> torch.device:
    """The device a timer reads: `device` when given, else that of the
    first tensor among args (a dict's values, a list's items), else the
    CPU."""
    if device is not None:
        return torch.device(device)
    stack = list(args)
    while stack:
        a = stack.pop(0)
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (QuantizedTensor, QuantizedActivation)):
            return a.data.device
        if isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
    return torch.device("cpu")


def _flush_buffer(device):
    """A buffer twice the card's L2, zeroed before a launch to evict it."""
    props = torch.cuda.get_device_properties(device)
    return torch.empty(2 * props.L2_cache_size, dtype=torch.uint8,
                       device=device)


def _host_seconds(dev, fn, *args) -> float:
    """Host seconds of one fn(*args) call that ends synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _holder(dev, seconds: float):
    """A function that queues a spin kernel holding the card for about
    `seconds` (1.25x, and a millisecond more), its rate measured against
    CUDA events here: the launches of one call queued behind it reach
    the card back to back, so events around them time the card's work
    and not the host's launches (the JAX package's two-point loop
    cancels its dispatch cost for the same reason). One call at a time:
    the card's queue of pending launches is about a thousand deep, and
    the host waits once it is full."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = 1e7 / start.elapsed_time(end) * (1.25 * seconds * 1e3 + 1.0)
    return lambda: torch.cuda._sleep(int(cycles))


def measure_device_time(fn, *args, iters: int = 20, warmup: bool = True,
                        flush_l2: bool = False, device=None) -> float:
    """Seconds per fn(*args) call on the device its arguments lie on
    (or `device`), robust to the host's launch cost.

    On a card: the mean of `iters` calls after a warm-up call, each
    between its own CUDA events and queued behind a spin kernel that
    holds the card while the host launches it (_holder), so a call of
    many small launches is timed at the card's pace, not the host's
    (unless fn itself waits for the card). With flush_l2 a buffer twice
    the L2 is zeroed before each call, as a caller would find its
    inputs cold. On the CPU: the host clock around `iters` calls."""
    dev = _device_of(args, device)
    if warmup:
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    hold = _holder(dev, _host_seconds(dev, fn, *args))
    flush = _flush_buffer(dev) if flush_l2 else None
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        hold()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    return sum(s.elapsed_time(e) for s, e in events) / 1e3 / iters


# The reference GEMM of chip_speed_factor: 4096^3 bf16 torch.matmul,
# 2 * 4096^3 = 137.4 GFLOP a call. Its healthy reading,
# _REF_HEALTHY_TFLOPS, is chip_smoke.py's `tooling` phase on an NVIDIA
# H100 80GB HBM3 at 700.00 W (PERF.md): 864.4 TFLOP/s, 87% of the data
# sheet's 989
_REF_N = 4096
_REF_HEALTHY_TFLOPS = 864.0
_REF_HEALTHY_S = 2 * _REF_N ** 3 / (_REF_HEALTHY_TFLOPS * 1e12)


def chip_speed_factor(iters: int = 40, device="cuda") -> float:
    """The card's speed now against its healthy reading, from the
    reference GEMM (4096^3 bf16 torch.matmul, measure_device_time).

    1.0 = healthy; 0.5 = the card delivers half its known rate now (a
    lower power limit, a neighbour, clocks held down). Report it beside
    any number of a run, and compare runs only at similar factors. The
    healthy reading is a card's, so there is no CPU answer: a device
    that is not a card raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("chip_speed_factor reads a CUDA card; its "
                           f"healthy reading means nothing on {dev}")
    a = torch.ones((_REF_N, _REF_N), dtype=torch.bfloat16, device=dev)
    dt = measure_device_time(torch.matmul, a, a, iters=iters)
    return _REF_HEALTHY_S / dt


@contextlib.contextmanager
def trace(logdir: str | None = None, cuda: bool | None = None,
          warmup: int = 0):
    """torch.profiler around a block, CPU activity and, where a card is
    present (or `cuda`), CUDA activity; yields the profile. With a
    logdir, its Chrome trace goes to logdir/trace.json (Perfetto or
    chrome://tracing). With `warmup`, the block's first `warmup` steps
    (the caller calls prof.step() after each) are traced and thrown
    away, and the capture is what follows them: the first records of a
    session, while CUPTI starts up, stay out of it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if cuda is None:
        cuda = torch.cuda.is_available()
    if cuda:
        # Kineto tears CUPTI down after each session unless told not to;
        # a kernel library that ctypes loads after such a teardown (its
        # own static CUDA runtime) then loses launches in the next
        # session (on the H100, PERF.md §7). Set before the first session
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    sched = (schedule(wait=0, warmup=warmup, active=1, repeat=1)
             if warmup else None)
    with profile(activities=acts, schedule=sched) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# The keys of a kernel_stats row (times in us over the whole capture)
KERNEL_STAT_KEYS = ("kernel_name", "category", "occurrences",
                    "total_self_time", "avg_self_time",
                    "total_self_time_percent", "model_flop_rate")

# The port's own kernels by their symbols in csrc/ (the longer names
# first: si_matmul_int4w_kernel is matmul_int4w.cu's), then the
# library's by the words their names carry
_CATEGORIES = (
    (("Memcpy", "Memset"), "copy"),
    (("si_int4w", "si_matmul_int4w"), "si:matmul_int4w"),
    (("si_matmul",), "si:matmul"),
    (("si_s8s8",), "si:matmul_s8s8"),
    (("si_flash",), "si:flash_attention"),
    (("si_decode",), "si:decode_attention"),
    (("c3_tc_kernel", "c3_s8_tap", "c3_quantize", "c3_fp_kernel"),
     "si:c3_block"),
    (("si_conv3x3",), "si:conv3x3"),
    (("si_stem",), "si:stem"),
    (("fprop", "dgrad", "wgrad", "conv", "Conv"), "conv"),
    (("gemm", "Gemm", "xmma", "cutlass", "cublas", "Kernel2"), "gemm"),
    (("elementwise", "Elementwise", "vectorized", "reduce", "Reduce",
      "softmax", "Softmax", "CatArray", "index", "Index", "copy",
      "fill", "Fill"), "elementwise"),
)


def kernel_category(name: str) -> str:
    """gemm / conv / si:<kernel> (the port's own, by csrc/ symbol) /
    elementwise / copy / other, from a CUDA kernel's name."""
    for words, cat in _CATEGORIES:
        if any(w in name for w in words):
            return cat
    return "other"


def kernel_stats(prof, flops: dict | None = None,
                 cuda: bool = True) -> list:
    """Rows of a torch.profiler capture: one per CUDA kernel (self
    device time; copies and memsets too), or with cuda=False one per
    CPU op (self CPU time: a capture on the CPU). Keys
    KERNEL_STAT_KEYS, times in us over the capture, sorted by total
    self time; a capture with no CUDA activity gives no CUDA rows.
    `flops` maps a category or a kernel-name substring to the FLOPs its
    kernels did over the capture; each matching row's model_flop_rate
    is then its GFLOP/s (shared out by self time where several rows
    match), else None."""
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              == cuda and not e.key.startswith("ProfilerStep")]
    rows = []
    for e in events:
        if cuda:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            cat = kernel_category(e.key)
        else:
            us, cat = e.self_cpu_time_total, "cpu"
        rows.append({"kernel_name": e.key, "category": cat,
                     "occurrences": int(e.count),
                     "total_self_time": float(us),
                     "avg_self_time": float(us) / max(e.count, 1),
                     "total_self_time_percent": 0.0,
                     "model_flop_rate": None})
    total = sum(r["total_self_time"] for r in rows)
    for r in rows:
        r["total_self_time_percent"] = 100.0 * r["total_self_time"] / max(
            total, 1e-9)
    for key, f in (flops or {}).items():
        match = [r for r in rows
                 if r["category"] == key or key in r["kernel_name"]]
        us = sum(r["total_self_time"] for r in match)
        for r in match:
            if us > 0:
                # its share of the FLOPs, by time: GFLOP/s = FLOP / ns
                r["model_flop_rate"] = f / (us * 1e3)
    rows.sort(key=lambda r: -r["total_self_time"])
    return rows


def _hand_launches() -> int:
    """Launches of the port's own kernels so far (their wrappers'
    counters)."""
    from .kernels import (attention, c3block, conv3x3, decode_attn,
                          matmul, stem)

    return (matmul.launches + matmul.launches_int4w + matmul.launches_s8s8
            + attention.launches + decode_attn.launches + c3block.launches
            + conv3x3.launches + stem.launches)


def device_profile(fn, *args, iters: int = 10, logdir: str | None = None,
                   device=None, flops: dict | None = None,
                   captures: int = 3, info: dict | None = None) -> list:
    """Trace `iters` calls of fn(*args) after an untraced warm-up call
    (a kernel library's build and first launch stay outside the
    capture) and one traced and discarded (trace's warmup), and return
    kernel_stats rows over the capture, divided by nothing:
    format_kernel_stats(rows, iters=iters) gives the times a call. The
    device is that of args' tensors (or `device`). On a card the rows
    are CUDA kernels, and the capture must hold every launch of the
    port's own kernels that their wrappers counted in it: CUPTI has
    dropped some (on the H100, PERF.md §7), so an incomplete capture is
    taken again, up to `captures` in all, and then raises, as a capture
    with no device time does, instead of answering from the host or
    with the kernels left out; on the CPU the rows are CPU ops. `flops`:
    kernel_stats' FLOPs over the capture. `info`, where given, gets the
    captures taken and the launches counted and recorded in each."""
    dev = _device_of(args, device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    fn(*args)
    sync()
    taken = []
    for _ in range(max(1, captures) if cuda else 1):
        with trace(logdir, cuda=cuda, warmup=1) as prof:
            fn(*args)
            sync()
            prof.step()
            launched = _hand_launches()
            for _ in range(iters):
                fn(*args)
            sync()
            launched = _hand_launches() - launched
        rows = kernel_stats(prof, flops, cuda)
        recorded = sum(r["occurrences"] for r in rows
                       if r["category"].startswith("si:"))
        taken.append({"launched": launched, "recorded": recorded})
        if not cuda or recorded >= launched:
            break
    if info is not None:
        info.update(captures=len(taken), launches=taken)
    if cuda and sum(r["total_self_time"] for r in rows) <= 0:
        raise RuntimeError(
            "torch.profiler recorded no CUDA device time for the traced "
            "calls (CUPTI tracing unavailable?); time with CUDA events "
            "instead (measure_device_time)")
    if cuda and recorded < launched:
        raise RuntimeError(
            f"torch.profiler recorded {recorded} of the {launched} "
            f"launches of the port's own kernels in the traced calls, in "
            f"each of {len(taken)} captures ({taken}; CUPTI dropped "
            f"records, see trace)")
    return rows


def format_kernel_stats(rows: list, top: int = 30, iters: int = 1) -> str:
    """Render kernel_stats rows: per-category rollup + top kernels by
    self time. `iters` divides totals down to per-iteration time."""
    total = sum(r["total_self_time"] or 0.0 for r in rows)
    by_cat: dict = {}
    for r in rows:
        c = by_cat.setdefault(r["category"] or "?", [0.0, 0])
        c[0] += r["total_self_time"] or 0.0
        c[1] += int(r["occurrences"] or 0)
    lines = [f"device self time: {total / iters / 1e3:.3f} ms/iter "
             f"({iters} iters)", "",
             f"{'category':<26s} {'us/iter':>9s} {'%':>6s} {'#/iter':>7s}"]
    for cat, (us, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{cat[:26]:<26s} {us / iters:9.1f} "
                     f"{100 * us / max(total, 1e-9):6.1f} {n / iters:7.1f}")
    lines += ["", f"{'kernel':<48s} {'category':<20s} {'us/iter':>8s} "
              f"{'%':>5s} {'#/iter':>6s} {'GFLOP/s':>8s}"]
    for r in rows[:top]:
        rate = r["model_flop_rate"]
        lines.append(
            f"{(r['kernel_name'] or '?')[:48]:<48s} "
            f"{(r['category'] or '?')[:20]:<20s} "
            f"{(r['total_self_time'] or 0.0) / iters:8.1f} "
            f"{r['total_self_time_percent'] or 0.0:5.1f} "
            f"{(r['occurrences'] or 0) / iters:6.1f} "
            f"{'-' if rate is None else f'{rate:.0f}':>8s}")
    return "\n".join(lines)


def _leaves(out, n_outputs: int) -> list:
    return [out] if n_outputs == 1 else list(out)


def _sync_all(leaves) -> None:
    for v in leaves:
        d = v.data if isinstance(v, QuantizedActivation) else v
        if isinstance(d, torch.Tensor) and d.device.type == "cuda":
            torch.cuda.synchronize(d.device)
            return


def timed_run(program, weights, inputs, sync: bool = True) -> list:
    """Execute the program op by op, timing each op on the host clock,
    with torch.cuda.synchronize after each op on a card (`sync`).
    Returns [(op_name, op_type, seconds)] in execution order: the
    counterpart of the reference's per-layer forward log. A synchronise
    per op forgoes the overlap of host launches with device work, so
    read the results as relative weights."""
    env = dict(inputs)
    rows = []
    with torch.inference_mode():
        for impl, in_names, out_names in program.plan:
            args = [env[n] for n in in_names]
            t0 = time.perf_counter()
            leaves = _leaves(impl.apply(weights[impl.name], *args),
                             impl.n_outputs)
            if sync:
                _sync_all(leaves)
            rows.append((impl.name, impl.type, time.perf_counter() - t0))
            for n, o in zip(out_names, leaves):
                env[n] = o
    return rows


def attribute_slices(program, weights, inputs, n_slices: int = 12,
                     iters: int = 12, verbose: bool = True,
                     cuts: list | None = None) -> list:
    """Per-SEGMENT attribution of one forward: where the milliseconds
    go, without the profiler.

        [(label, ops_in_segment, seg_seconds, seg_flops)]

    Cut points are chosen evenly in CUMULATIVE FLOPs (the roofline's
    estimator) so each segment carries comparable work, or given as plan
    prefix lengths (`cuts`: clipped, deduped, sorted; the whole plan
    always ends the last segment). The forward runs op by op `iters`
    times after a warm-up; on a card a CUDA event is recorded at every
    cut, each walk queued behind a spin kernel that holds the card
    while the host launches it (_holder), and a segment's time is the
    mean time between its two events: the card's own time for its ops,
    not the host's pace (the JAX package times prefix programs instead,
    since XLA fuses across ops; an eager walk has nothing to fuse or cut
    away). On the CPU the host clock stands at each cut."""
    plan = program.plan
    flops = [max(program.op_flops(impl), 0) for impl, _, _ in plan]
    total = sum(flops) or 1
    if cuts is None:
        cuts, acc, step = [], 0, total / n_slices
        next_mark = step
        for i, f in enumerate(flops):
            acc += f
            if acc >= next_mark and (i + 1) not in cuts:
                cuts.append(i + 1)
                next_mark += step
    else:
        cuts = sorted({min(max(int(c), 1), len(plan)) for c in cuts})
    if not cuts or cuts[-1] != len(plan):
        cuts.append(len(plan))
    dev = _device_of((inputs,), None)
    cuda = dev.type == "cuda"

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def walk():
        env = dict(inputs)
        marks, at = [mark()], set(cuts)
        for idx, (impl, in_names, out_names) in enumerate(plan):
            out = impl.apply(weights[impl.name],
                             *[env[n] for n in in_names])
            for n, o in zip(out_names, _leaves(out, impl.n_outputs)):
                env[n] = o
            if idx + 1 in at:
                marks.append(mark())
        return marks

    with torch.inference_mode():
        walk()
        hold = _holder(dev, _host_seconds(dev, walk)) if cuda else None
        runs = []
        for _ in range(iters):
            if hold is not None:
                hold()
            runs.append(walk())
    if cuda:
        torch.cuda.synchronize(dev)
        segs = [[s.elapsed_time(e) / 1e3 for s, e in zip(r, r[1:])]
                for r in runs]
    else:
        segs = [[e - s for s, e in zip(r, r[1:])] for r in runs]
    rows = []
    prev = 0
    for j, cut in enumerate(cuts):
        seg_ops = [plan[i][0] for i in range(prev, cut)]
        t = sum(s[j] for s in segs) / len(segs)
        label = (f"{seg_ops[0].name}..{seg_ops[-1].name}"
                 if seg_ops else "?")
        rows.append((label, [o.name for o in seg_ops], max(t, 0.0),
                     sum(flops[prev:cut])))
        if verbose:
            print(f"  ops[{prev:3d}:{cut:3d}] segment {t * 1e3:8.3f} ms  "
                  f"({label})", flush=True)
        prev = cut
    return rows
