#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simpleinfer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing JSON lines:
1. device and build: the card (torch and nvidia-smi), the nvcc build of
   every kernel source with `-Xptxas -v` registers and spills;
2. kernel vs plain version on the card: `matmul` and `matmul_int8w` at
   the YOLOv5s-640-b8 pointwise-conv shapes (taken from the main path)
   and at ragged shapes, x in bf16 and f32, every activation; then the
   kernel's time at the main path's shapes beside its plain version's,
   `torch.addmm`'s and the bound;
3. main path: YOLOv5s 640x640, batch 8, bf16 int8w through `Engine.run`,
   with the launch count per forward, output checks, a comparison with
   the same model run with kernels off, and throughput both ways;
4. fp32 int8w on the card vs the port on the CPU, on a small YOLOv5s.

The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Any failure (no CUDA device, a kernel
that does not build, launch or agree) exits non-zero without the ok
line. The phases are functions of a torch device, so the CPU tests
rehearse phases 3-4 at a tiny size with the plain versions.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks used for the bound (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# YOLOv5s pointwise convs that reach matmul_int8w per forward (the other
# 17 pointwise convs are cat-split sums)
YOLOV5S_POINTWISE = 22

RAGGED_SHAPES = [(100, 60, 50), (1, 256, 255), (37, 129, 131), (8, 16, 8)]
ACTIVATIONS = [None, "relu", "silu", "sigmoid", "hardsigmoid", "hardswish",
               "relu6", "tanh", "mish", "gelu", "gelu_tanh",
               "leaky_relu@0.1", "elu@1.0"]

# kernel vs plain version: f32 accumulation in another order; a bf16
# output may round one bf16 ulp (2^-7 relative) apart on top of that
KERNEL_ATOL = 1e-4
KERNEL_BF16_RTOL = 2.0 ** -7
# main path, kernels on vs off (cuDNN), bf16: the two paths round to
# bf16 at other places in each of ~60 layers
MAIN_MAX_TOL = 0.02
MAIN_MEAN_TOL = 1e-4
# fp32 int8w on the card vs on the CPU (TF32 off): summation order only
FP32_TOL = 1e-4
# ~0.5 ms of spinning at H100 clocks: longer than a wrapper's host time
SPIN_CYCLES = 1_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---- phase 1 ------------------------------------------------------------
def device_and_build(device) -> dict:
    """The card, and a fresh nvcc build of the kernel sources."""
    import torch
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    info = {"phase": "device", "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[device.index or 0]}
    emit(info)
    kmm.load_library(rebuild=True)
    # one line per template instance; keep the distinct ones
    ptxas = sorted({ln.split(":", 1)[-1].strip()
                    for ln in kmm.build_info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln})
    emit({"phase": "build", "source": str(kmm.SOURCE.relative_to(HERE)),
          "seconds": round(kmm.build_info["seconds"], 3),
          "ptxas": ptxas})
    return info


# ---- phase 2 ------------------------------------------------------------
def _inputs(gen, device, m, k, n, x_dtype):
    """Seeded x [M,K], w [K,N] (~unit-scale outputs), its int8
    quantization and an f32 bias, on `device`."""
    import torch
    from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel

    x = torch.randn(m, k, generator=gen, device=device).to(x_dtype)
    w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
    bias = 0.1 * torch.randn(n, generator=gen, device=device)
    q = quantize_per_channel(w.cpu().numpy(), axis=1)
    return x, w.to(x_dtype), q.data.to(device), q.scale.to(device), bias


def _close(got, ref):
    """max |got - ref| and whether every element is inside the stated
    tolerance: KERNEL_ATOL * max(1, max|ref|), plus one bf16 ulp of the
    reference for a bf16 output."""
    import torch

    d = (got.float() - ref.float()).abs()
    lim = KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
    if got.dtype == torch.bfloat16:
        lim = lim + KERNEL_BF16_RTOL * ref.float().abs()
    ok = (got.dtype == ref.dtype and bool((d <= lim).all())
          and bool(torch.isfinite(got.float()).all()))
    return float(d.max()), ok


def kernel_vs_plain(device, shapes, seed=0) -> float:
    """Every kernel against its plain version on the card, at `shapes`
    (M, K, N) plus the ragged ones, both x dtypes, every activation, with
    and without bias. Returns the largest max-abs error seen at the main
    path's own configuration (bf16 x, int8 w, bias, silu)."""
    import torch
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    gen = torch.Generator(device=device).manual_seed(seed)
    worst_main, n_checks = 0.0, 0
    failures = []
    for (m, k, n) in list(shapes) + RAGGED_SHAPES:
        for x_dtype in (torch.bfloat16, torch.float32):
            x, w, wq, scale, bias = _inputs(gen, device, m, k, n, x_dtype)
            for act in ACTIVATIONS:
                for use_bias in (True, False):
                    b = bias.to(x_dtype) if use_bias else None
                    cases = (
                        ("matmul", lambda: kmm.matmul(x, w, b, act),
                         lambda: kmm.matmul_ref(x, w, b, act)),
                        ("matmul_int8w",
                         lambda: kmm.matmul_int8w(x, wq, scale, b, act),
                         lambda: kmm.matmul_int8w_ref(x, wq, scale, b,
                                                      act)))
                    for name, kern, plain in cases:
                        with fp32_parity(True):  # no TF32 in the plain one
                            got = kern()
                            torch.cuda.synchronize(device)  # faults show here
                            ref = plain()
                        err, ok = _close(got, ref)
                        n_checks += 1
                        if not ok:
                            failures.append(dict(
                                entry=name, shape=[m, k, n],
                                x=str(x_dtype), act=act, bias=use_bias,
                                max_abs_err=err))
                        if (name == "matmul_int8w" and use_bias
                                and x_dtype == torch.bfloat16
                                and act == "silu" and (m, k, n) in shapes):
                            worst_main = max(worst_main, err)
            del x, w, wq, scale, bias
    emit({"phase": "kernel_vs_plain", "checks": n_checks,
          "failures": failures[:10], "n_failures": len(failures),
          "atol": f"{KERNEL_ATOL}*max(1,|ref|)",
          "bf16_out_rtol": KERNEL_BF16_RTOL,
          "max_abs_err_main_config": worst_main})
    if failures:
        raise AssertionError(f"{len(failures)} kernel-vs-plain mismatches")
    return worst_main


def _time_ms(device, fn, iters=10, flush=None) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events), the
    L2 cache flushed before each launch (the caller would find x cold).
    A spin kernel holds the card between the flush and the start event,
    so the launch is queued before the card reaches it and the events
    time the kernel, not the host's launch overhead."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize(device)
    return sum(s.elapsed_time(e) for s, e in times) / iters


def bound_ms(m, k, n, x_bytes, w_bytes, out_bytes, bias_bytes, scale,
             compute) -> tuple:
    """Least time the card could take: every input read once and the
    output written once over HBM, or the FLOPs at the peak of `compute`."""
    nbytes = (m * k * x_bytes + k * n * w_bytes + n * bias_bytes
              + (n * 4 if scale else 0) + m * n * out_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[compute] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, shape_counts: dict, seed=1) -> dict:
    """Time both entries at each main-path shape, main-path config (bf16
    x, bf16 bias, silu, bf16 out): kernel, plain version, torch.addmm on
    the weight dequantized to bf16 (no activation: addmm has none), and
    the bound. Returns per-forward sums weighted by launches per shape."""
    import torch
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    totals = {e: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      bytes_ms=0.0, ops_ms=0.0)
              for e in ("matmul", "matmul_int8w")}
    for (m, k, n), cnt in sorted(shape_counts.items()):
        x, w, wq, scale, bias = _inputs(gen, device, m, k, n, torch.bfloat16)
        b = bias.to(torch.bfloat16)
        w_deq = (wq.float() * scale).to(torch.bfloat16)
        row = {"shape": [m, k, n], "launches_per_forward": cnt}
        for entry in ("matmul", "matmul_int8w"):
            if entry == "matmul":
                kern = lambda: kmm.matmul(x, w, b, "silu")  # noqa: E731
                plain = lambda: kmm.matmul_ref(x, w, b, "silu")  # noqa
                lib = lambda: torch.addmm(b, x, w)  # noqa: E731
                bd, by = bound_ms(m, k, n, 2, 2, 2, 2, False, "bfloat16")
            else:
                kern = lambda: kmm.matmul_int8w(  # noqa: E731
                    x, wq, scale, b, "silu")
                plain = lambda: kmm.matmul_int8w_ref(  # noqa: E731
                    x, wq, scale, b, "silu")
                lib = lambda: torch.addmm(b, x, w_deq)  # noqa: E731
                bd, by = bound_ms(m, k, n, 2, 1, 2, 2, True, "bfloat16")
            t = {"ms": _time_ms(device, kern, flush=flush),
                 "plain_ms": _time_ms(device, plain, flush=flush),
                 "library_ms": _time_ms(device, lib, flush=flush),
                 "bound_ms": bd}
            row[entry] = dict(t, bound_by=by)
            for key, v in t.items():
                totals[entry][key] += cnt * v
            totals[entry]["bytes_ms" if by == "bytes" else "ops_ms"] += \
                cnt * bd
        emit(dict(phase="kernel_time", **row))
        del x, w, wq, scale, bias, b, w_deq
    for entry, t in totals.items():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    emit({"phase": "kernel_time_per_forward", "note":
          "sums over the main path's launches of one forward; library = "
          "torch.addmm (no activation)", **{
              e: {k: v for k, v in t.items()
                  if k not in ("bytes_ms", "ops_ms")}
              for e, t in totals.items()}})
    return totals


# ---- phase 3 ------------------------------------------------------------
def kernel_conv_names(graph) -> set:
    """Convs of a fused graph that dispatch to matmul_int8w: pointwise
    (1x1 s1 p0 d1 g1) with one input (cat-split convs take several)."""
    def p(op, key):
        return op.params[key].value

    return {op.name for op in graph.ops
            if op.type == "nn.Conv2d" and len(op.inputs) == 1
            and p(op, "kernel_size") == [1, 1] and p(op, "stride") == [1, 1]
            and p(op, "padding") == [0, 0] and p(op, "dilation") == [1, 1]
            and p(op, "groups") == 1}


def yolo_engine(device, batch, image, compute, use_kernels, seed=0):
    """A YOLOv5s int8w Engine on `device` (seeded random weights);
    returns (engine, input name, output name, fused graph)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_yolov5

    graph, in_name, out_name = build_yolov5("s", batch=batch,
                                            image_size=image, seed=seed)
    eng = Engine(EngineConfig(compute_dtype=compute, quant="int8w",
                              device=str(device), use_kernels=use_kernels))
    eng.load_model(None, graph=graph)  # fuses `graph` in place
    return eng, in_name, out_name, graph


def record_main_shapes(engine, feeds: dict) -> dict:
    """One warm-up forward with a recorder around matmul_int8w: the
    (M, K, N) shapes the main path gives the kernel, with their counts."""
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    counts: dict = {}
    orig = kmm.matmul_int8w

    def recorder(x, w_q, scale, bias=None, activation=None, **kw):
        key = (int(x.shape[0]), int(x.shape[1]), int(w_q.shape[1]))
        counts[key] = counts.get(key, 0) + 1
        return orig(x, w_q, scale, bias, activation, **kw)

    kmm.matmul_int8w = recorder
    try:
        engine.run(feeds)
    finally:
        kmm.matmul_int8w = orig
    return counts


def forward_times(engine, feeds: dict, iters=20) -> dict:
    """Device time of each of `iters` Engine.forward calls on staged
    inputs (CUDA events around each, back to back, after warm-up):
    median and max in ms."""
    import torch

    for k, v in feeds.items():
        engine.input(k, v)
    for _ in range(3):
        engine.forward()
    engine.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.forward()
        end.record()
        events.append((start, end))
    engine.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    return {"median_ms": statistics.median(ms), "max_ms": ms[-1], "n": iters}


def profile_forward(engine, feeds: dict, forward_ms: float, iters=3,
                    top=12) -> dict:
    """Where a forward's device time goes: torch.profiler over `iters`
    forwards; the device kernels by self time, per forward, and their sum
    as a share of `forward_ms` (the forward's time without the profiler,
    whose own host overhead stretches the wall time it sees)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for k, v in feeds.items():
        engine.input(k, v)
    engine.forward()
    engine.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.forward()
        engine.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3 / iters, e.count / iters, e.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return {"profiled_wall_ms_per_forward": wall_ms,
            "device_ms_per_forward": busy,
            "forward_ms": forward_ms,
            "busy_share": busy / forward_ms,
            "si_matmul_ms_per_forward": sum(
                k[0] for k in kernels if "si_matmul" in k[2]),
            "top_kernels": [[round(ms, 4), cnt, name]
                            for ms, cnt, name in kernels[:top]]}


def main_path(device, batch=8, image=640, n_batches=4, engines=None,
              seed=0) -> dict:
    """YOLOv5s bf16 int8w through Engine.run, kernels on; held against
    the same model with kernels off on the same device."""
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    on, in_name, out_name, graph = engines[0] if engines else yolo_engine(
        device, batch, image, "bfloat16", True)
    off = (engines[1] if engines else yolo_engine(
        device, batch, image, "bfloat16", False))[0]
    rng = np.random.default_rng(seed)
    feeds = [rng.integers(0, 256, (batch, image, image, 3), dtype=np.uint8)
             for _ in range(n_batches)]
    expected = len(kernel_conv_names(graph))
    if expected != YOLOV5S_POINTWISE:
        raise AssertionError(f"{expected} kernel convs in the graph, "
                             f"expected {YOLOV5S_POINTWISE}")

    kmm.launches = 0
    outs = [on.run({in_name: f})[out_name] for f in feeds]
    launches = kmm.launches
    if device.type == "cuda" and launches != expected * n_batches:
        raise AssertionError(f"{launches} kernel launches over {n_batches} "
                             f"forwards, expected {expected} per forward")
    want_shape = (batch, 3 * sum((image // s) ** 2 for s in (8, 16, 32)),
                  85)  # [8, 25200, 85] at 640
    ref = [off.run({in_name: f})[out_name] for f in feeds]
    worst_max = worst_mean = 0.0
    for got, want in zip(outs, ref):
        if got.shape != want_shape or not np.isfinite(got).all():
            raise AssertionError(f"output {got.shape} (want {want_shape})"
                                 f" finite={np.isfinite(got).all()}")
        scale = max(1.0, float(np.abs(want).max()))
        d = np.abs(got - want)
        worst_max = max(worst_max, float(d.max()) / scale)
        worst_mean = max(worst_mean, float(d.mean()) / scale)
    if worst_max > MAIN_MAX_TOL or worst_mean > MAIN_MEAN_TOL:
        raise AssertionError(f"kernels on vs off: max {worst_max}, mean "
                             f"{worst_mean} (x scale)")
    res = {"phase": "main_path", "model": "yolov5s", "batch": batch,
           "image": image, "compute": "bfloat16", "quant": "int8w",
           "forwards": n_batches, "launches": launches,
           "launches_per_forward": launches / n_batches,
           "kernel_convs_per_forward": expected,
           "output_shape": list(outs[0].shape),
           "vs_kernels_off": {"max_abs_over_scale": worst_max,
                              "mean_abs_over_scale": worst_mean,
                              "tol": [MAIN_MAX_TOL, MAIN_MEAN_TOL]}}
    if device.type == "cuda":
        import torch

        # on, off, on: two versions compared within one call, in turns
        torch.cuda.reset_peak_memory_stats(device)
        t_on = forward_times(on, {in_name: feeds[0]})
        res["peak_mem_bytes_kernels_on"] = torch.cuda.max_memory_allocated(
            device)
        t_off = forward_times(off, {in_name: feeds[0]})
        t_on2 = forward_times(on, {in_name: feeds[0]})
        ms_on = statistics.median([t_on["median_ms"], t_on2["median_ms"]])
        res.update(forward_kernels_on=[t_on, t_on2],
                   forward_kernels_off=t_off,
                   img_per_s_kernels_on=batch * 1e3 / ms_on,
                   img_per_s_kernels_off=batch * 1e3 / t_off["median_ms"])
    emit(res)
    if device.type == "cuda":
        emit({"phase": "profile_kernels_on", **profile_forward(
            on, {in_name: feeds[0]}, ms_on)})
        emit({"phase": "profile_kernels_off", **profile_forward(
            off, {in_name: feeds[0]}, t_off["median_ms"])})
    return res


# ---- phase 4 ------------------------------------------------------------
def fp32_card_vs_cpu(device, batch=2, image=64, seed=0) -> dict:
    """fp32 int8w YOLOv5s on `device` (kernels on) against the port on
    the CPU (plain versions), same seed: ties the card to the CPU tests."""
    import torch

    card, in_name, out_name, _ = yolo_engine(device, batch, image,
                                             "float32", True)
    cpu = yolo_engine(torch.device("cpu"), batch, image, "float32",
                      True)[0]
    x = np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32) / 3
    got = card.run({in_name: x})[out_name]
    want = cpu.run({in_name: x})[out_name]
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    res = {"phase": "fp32_card_vs_cpu", "shape": list(got.shape),
           "max_abs_err": err, "scale": scale,
           "tol": f"{FP32_TOL}*scale + {FP32_TOL}*|ref|"}
    emit(res)
    np.testing.assert_allclose(got, want, atol=FP32_TOL * scale,
                               rtol=FP32_TOL)
    return res


# ---- driver -------------------------------------------------------------
def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "simpleinfer_tpu_torch")):
        print("chip_smoke.py: simpleinfer_tpu_torch/ not found beside the "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    info = device_and_build(device)

    on = yolo_engine(device, 8, 640, "bfloat16", True)
    off = yolo_engine(device, 8, 640, "bfloat16", False)
    rng = np.random.default_rng(123)
    warm = rng.integers(0, 256, (8, 640, 640, 3), dtype=np.uint8)
    shape_counts = record_main_shapes(on[0], {on[1]: warm})
    emit({"phase": "main_path_shapes", "shapes": [
        [*k, c] for k, c in sorted(shape_counts.items())]})
    max_err = kernel_vs_plain(device, list(shape_counts))
    totals = time_kernels(device, shape_counts)
    main = main_path(device, engines=(on, off))
    del on, off
    fp32_card_vs_cpu(device)

    t = totals["matmul_int8w"]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": [{
        "name": "matmul_int8w",
        "route": "cuda",
        "source": "simpleinfer_tpu_torch/csrc/matmul.cu",
        "replaces": "simpleinfer_tpu/kernels/matmul.py:183",
        "launches": main["launches"],
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
