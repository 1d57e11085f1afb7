#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simpleinfer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing JSON lines:
1. device and build: the card (torch and nvidia-smi), the nvcc build of
   every kernel source (one nvcc each, started together) with
   `-Xptxas -v` registers and spills; then the tensor-core instructions
   (HMMA / HGMMA / IMMA / IGMMA) of each function of matmul_int4w.cu,
   flash_attention.cu, matmul.cu, conv3x3.cu, matmul_s8s8.cu,
   c3block.cu (its bf16 stages and its s8-tap 3x3) and stem.cu in the
   built SASS (cuobjdump -sass), which fails if a bf16 route has no
   HMMA / HGMMA or an s8 route no IMMA / IGMMA;
2. kernel vs plain version on the card: `matmul` and `matmul_int8w` at
   the YOLOv5s-640-b8 pointwise-conv shapes (taken from the main path)
   and at ragged shapes, x in bf16 and f32, every activation; then the
   kernel's time at the main path's shapes beside its plain version's,
   `torch.addmm`'s and the bound;
3. main path: YOLOv5s 640x640, batch 8, bf16 int8w through `Engine.run`,
   with the launch count per forward, output checks, a comparison with
   the same model run with kernels off, and throughput both ways (both
   matmul entries take csrc/matmul.cu's bf16 tensor-core route there);
4. fp32 int8w on the card vs the port on the CPU, on a small YOLOv5s;
4a. the detection pipeline (zoo/detect.py): `host_native`, the port's
   native host library (csrc/si_host.cpp, built by g++ at first use)
   loaded, its letterbox_batch against letterbox_one (bytes) and the
   numpy route, and its NMS against the numpy one; the device decode
   (decode_device: f32, stable sorts, the fixed-point NMS batched over
   the images) against the host decode (decode_predictions) on a
   planted head [2, 4000, 85] with suppression chains and exact ties,
   f32 and bf16; `detect_v5` / `detect_v8`: YOLOv5s / YOLOv8s-640-b8
   bf16 int8w through `detect_images` on 8 seeded images of mixed sizes,
   with matmul_int8w's launches in one call (22 / 11, counts set to 0
   just before), the device decode against the host decode on the
   engine's own head (kept-row floors), the device decode's kernel
   launches and NMS rounds at pre_topk 512 and 1024, and each route's
   time a batch split into letterbox, staging, forward, decode + fetch
   (device decode or host decode, float or uint8 staging; hooks on the
   steps of detect_images itself), img/s end to end and bytes staged
   and fetched; for YOLOv8s also head="auto", matmul_int8w against its
   plain version and timed at the path's shapes, kernels on vs off (box
   and scores each over its own scale, V8_ONOFF_TOL) and fp32 on the
   card vs the CPU port at 64 px (DetectV8's DFL and anchors);
   `engine_warmup`: Engine.warmup((1, 2, 4, 8, 16, 32)) on YOLOv5s-640
   bf16 int8w with the kernel libraries unloaded first, seconds per
   batch size, the first forward after it building and loading nothing
   (calls to kernels/build.py's build, libraries loaded), and
   Engine.temp_bytes per batch size (rising with the batch, under the
   free memory); `segment`: build_unet 128 px b8 bf16 int8w through
   zoo.segment, matmul_int8w's launches, the kernel against its plain
   version and timed at the path's shape, the device argmax against the
   host argmax of the same logits, pixel for pixel, and the logits
   against a use_kernels=False engine (UNET_ONOFF_TOL);
4b. static int8 (`yolo_int8`): yolov5l-640-b16 (full width and depth),
   bf16, quant="int8", c3_fusion, calibrated by Engine.calibrate on 2
   seeded batches (wall time printed); the launches of `matmul_s8s8` (5
   per forward), `c3_block` (INT8_C3_BLOCKS at the H100's C3_MIN_WORK,
   one with s8 taps, every one on the tensor-core route) and
   `matmul_int8w` (3: the pointwise convs outside the int8 gate) with
   the counts set to 0 just before the forwards, no matmul_s8s8 call
   that had to lay its weight out K-major (Engine.place_weights did,
   once) and no C3 weight converted or copied per call;
   matmul_s8s8 and c3_block against their plain versions at ragged
   shapes (w row-major, K-major and both operands misaligned; fp and s8
   taps, both shortcut
   forms, tiles across images, a dyadic-grid block that must agree to
   f32 rounding), and all three at every call a forward made, on its
   own inputs; their times beside plain, library (`torch._int_mm` for
   matmul_s8s8, `torch.addmm` for matmul_int8w, none for a C3 block)
   and bound, a line per C3 block with the times of c3_block, of the bf16
   library chain ops/c3.c3_chain and of c3_block_reference, and the time
   of the fused blocks below c3_profitable, which run c3_chain (held
   to c3_block's bf16 limit of the plain version); the C3 gate sweep:
   all 8 fused blocks through c3_block (C3_MIN_WORK 0 for one recorded
   forward, the taps still the JAX package's choice), a line per block
   with c3_block, c3_chain, plain and bound by its work h*w*hid*T, and
   the gate the readings give beside the committed one; forward times kernels
   on, off, on; profiles (the kernels-off one must run no float64
   kernel: its s8 products are torch._int_mm's); kernels on vs off, box
   and scores each against its own scale, within limits set between the
   sound reading and a fault's (scripts/torch_onoff_control.py --int8);
5. llama kernels vs plain: matmul_int4w, flash_attention and
   decode_attention at ragged shapes, f32 and bf16 (int4w: the down
   projection's K 5456 and the MLP's N 5456 at M 17; decode: lengths 0,
   1, straddling a tile and full, at the edges of the split's shares,
   with a max_len under L, and at the service's decode shape; bf16, f32
   and int8 leaves; each decode case run twice and required bit-equal;
   flash: causal, non-causal, banded, head_dim 128 at L 2048); then the
   flash
   gate: flash_attention against the unblocked path at [12, 32, L, 64]
   bf16 for L from 256 to 2048;
6. the llama main path: llama "base" (16 layers, width 2048, vocab
   32000), bf16 int4w, GenerationService(slots=16, kv bf16) serving 48
   greedy requests (seeded prompt lengths uniform in 32..1900, 64 new
   tokens each) as streams: time to first token, decode tokens/s, the
   launches of each kernel (counts reset just before); then each kernel
   against its plain version at the shapes the run recorded, and its
   time beside its plain version's, a torch library call's and the
   bound (matmul_int4w per decode step and per admission wave, with a
   line per projection shape of the wave); a decode step's profile, and
   the KERNEL_MIN_SLOTS sweep: the frozen-cache attention with the
   decode kernel against the torch route at 1 to 16 slots;
7. kernels on vs off: the llama engine against one of the same graph
   with use_kernels=False; prefill logits at width 2048 and one
   decode-block step's logits, each side also against an fp32 engine of
   the same int4 weights;
8. fp32 int4w llama (2 layers, window 256) on the card: logits against
   a float64 numpy reference of the same int4 model (`llama_ref64`),
   the forward rerun bit-equal, and greedy tokens through the decode
   kernel equal to the port's on the CPU;
9. `conv_kernels`: conv3x3_s1_same and stem_s2d, which no op dispatches
   (in the JAX package either), driven through their own entry points
   at the main shapes with the counts set to 0 just before: every
   distinct 3x3 s1 p1 conv of the fused ResNet-50-224-b128 (relu) and
   YOLOv5s-640-b8 (silu) graphs on their own folded weights, x bf16,
   and the stem at N 8 and 1 with the YOLOv5s (OC 32) and yolov5l (OC
   64) folded stem weights on a seeded image; each against its plain
   version there and (conv3x3) at ragged shapes, x bf16 and f32, every
   activation, with and without bias; times beside plain, library
   (F.conv2d, channels-last bf16, + bias + activation) and bound, a line
   per main shape;
10. `resnet_int8`, this slice's main path: ResNet-50-224-b128 (torchvision
   widths and depths, 25.6 M parameters) bf16 static int8 per-tensor,
   calibrated by Engine.calibrate on 2 seeded batches (wall time
   printed); launches of matmul_int8w (33 pointwise s1 convs) and
   matmul_s8s8 (13 3x3 convs with ic >= 128 and the fc) per forward
   with the counts set to 0 just before, no weight laid out K-major per
   call; both kernels against their
   plain versions at every call of a forward; their times (a line per
   pointwise conv: kernel / torch.addmm / bound); forwards on, off, on;
   profiles (no float64 kernel with kernels off); logits on vs off
   within limits set between the sound reading and a fault's
   (scripts/torch_onoff_control.py --resnet), top-1 agreement reported;
   classify_images top-5 of 8 seeded 256x320 images; fp32 ResNet-18 on
   the card vs the CPU port.

The line before the last two is the card's nvidia-smi name and power
limit, then {"kernels": [...]}, then {"ok": true, "device": {...}}. Any
failure (no CUDA device, a kernel that does not build, launch or agree)
exits non-zero without the ok line. `--phases` runs a subset (a
debugging aid, which prints no ok line). The phases are functions of a
torch device, so the CPU tests rehearse them at a tiny size with the
plain versions.
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

# every kernel source of the port, built in phase 1
SOURCES = ("matmul.cu", "matmul_int4w.cu", "flash_attention.cu",
           "decode_attention.cu", "matmul_s8s8.cu", "c3block.cu",
           "conv3x3.cu", "stem.cu")

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
    """The card, and a fresh nvcc build of every kernel source (one nvcc
    per source, all started together)."""
    import torch
    from simpleinfer_tpu_torch.kernels import build

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
    t0 = time.perf_counter()
    built = build.build(SOURCES, rebuild=True)
    for source, b in built.items():
        # one line per template instance; keep the distinct ones, and
        # name the functions that spill
        ptxas = sorted({ln.split(":", 1)[-1].strip()
                        for ln in b["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln})
        spills, fn = {}, None
        for ln in b["ptxas"].splitlines():
            if "Function properties for" in ln:
                fn = ln.rsplit(" ", 1)[-1].strip()
            elif fn and "spill stores" in ln and not ln.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                spills[fn] = ln.strip()
        emit({"phase": "build", "source": f"simpleinfer_tpu_torch/csrc/"
              f"{source}", "seconds": round(b["seconds"], 3),
              "ptxas": ptxas, "spills": dict(zip(
                  _demangle(list(spills)), spills.values()))})
    emit({"phase": "build_all", "seconds": round(time.perf_counter() - t0,
                                                 3)})
    return info


# tensor-core kernels: (source, function name part, the instructions
# one of which each instance must hold: HMMA / HGMMA for the bf16
# routes, IMMA / IGMMA for the s8 one)
BF16_MMA, S8_MMA = ("HMMA", "HGMMA"), ("IMMA", "IGMMA")
MMA_KERNELS = (("matmul_int4w.cu", "si_int4w_mma_kernel", BF16_MMA),
               ("flash_attention.cu", "si_flash_mma_kernel", BF16_MMA),
               ("matmul.cu", "si_matmul_mma_kernel", BF16_MMA),
               ("conv3x3.cu", "si_conv3x3_mma_kernel", BF16_MMA),
               ("matmul_s8s8.cu", "si_s8s8_wgmma_kernel", S8_MMA),
               ("c3block.cu", "c3_tc_kernel", BF16_MMA),
               ("c3block.cu", "c3_s8_tap_kernel", S8_MMA),
               ("stem.cu", "si_stem_kernel", BF16_MMA))


def _tool(name) -> str:
    import shutil

    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found")


def _demangle(names) -> list:
    """C++ names as cu++filt prints them (as given where it is missing)."""
    if not names:
        return []
    try:
        return subprocess.run([_tool("cu++filt")], input="\n".join(names),
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        return list(names)


def sass_mma_counts() -> dict:
    """The tensor-core instructions (HMMA / HGMMA / IMMA / IGMMA) of
    every kernel function in the built libraries of MMA_KERNELS, read
    from their SASS (cuobjdump -sass). Fails if a tensor-core route's
    function is missing or an instance has none of its kind."""
    from simpleinfer_tpu_torch.kernels import build

    ops = BF16_MMA + S8_MMA
    counts = {}
    for source in dict.fromkeys(src for src, _, _ in MMA_KERNELS):
        sass = subprocess.run(
            [_tool("cuobjdump"), "-sass", str(build.library_path(source))],
            capture_output=True, text=True, check=True).stdout
        fn = None
        for ln in sass.splitlines():
            ln = ln.strip()
            if ln.startswith("Function :"):
                fn = ln.split(":", 1)[1].strip()
                counts[fn] = {"source": source, **dict.fromkeys(ops, 0)}
            elif fn is not None:
                op = ln.split("*/", 1)[-1].strip().split(" ")[0]
                # the longer names first: HGMMA also starts with H
                for name in ("HGMMA", "IGMMA", "HMMA", "IMMA"):
                    if op.startswith(name):
                        counts[fn][name] += 1
                        break
    names = sorted(counts)
    rows = {p: counts[n] for n, p in zip(names, _demangle(names))}
    emit({"phase": "sass_tensor_core", "functions": rows})
    for source, part, kinds in MMA_KERNELS:
        mine = [r for n, r in counts.items() if part in n]
        if not mine or not all(sum(r[k] for k in kinds) for r in mine):
            raise AssertionError(f"{part} ({source}): no {'/'.join(kinds)} "
                                 f"instruction in its SASS")
    return rows


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


def kernel_vs_plain(device, shapes, seed=0, ragged=True,
                    phase="kernel_vs_plain") -> float:
    """Every kernel against its plain version on the card, at `shapes`
    (M, K, N) plus (`ragged`) the ragged ones, both x dtypes, every
    activation, with and without bias. Returns the largest max-abs error
    seen at the main path's own configuration (bf16 x, int8 w, bias,
    silu)."""
    import torch
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    gen = torch.Generator(device=device).manual_seed(seed)
    worst_main, n_checks = 0.0, 0
    failures = []
    for (m, k, n) in list(shapes) + (RAGGED_SHAPES if ragged else []):
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
    emit({"phase": phase, "checks": n_checks,
          "failures": failures[:10], "n_failures": len(failures),
          "atol": f"{KERNEL_ATOL}*max(1,|ref|)",
          "bf16_out_rtol": KERNEL_BF16_RTOL,
          "max_abs_err_main_config": worst_main})
    if failures:
        raise AssertionError(f"{len(failures)} kernel-vs-plain mismatches")
    return worst_main


def _time_ms(device, fn, iters=10, flush=None, spin=SPIN_CYCLES) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events), the
    L2 cache flushed before each launch (the caller would find x cold).
    A spin kernel of `spin` cycles holds the card between the flush and
    the start event, so the launch is queued before the card reaches it
    and the events time the kernel, not the host's launch overhead (a fn
    of many torch calls needs a longer spin)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
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


class Recorder:
    """Wraps kernel wrappers for the length of a `with` block: `wrappers`
    maps each wrapper's name to the module that holds it (module
    attributes, so every caller goes through the wrap). Each call keeps
    `keep[name](*args, **kw)` in `calls[name]`, by default the call's
    own (args, kw): references to the tensors the path made, nothing
    copied or synchronised. A `keep` that returns a shape key makes
    `count(name)` the shapes with their counts."""

    def __init__(self, wrappers: dict, keep: dict | None = None):
        self.mods = wrappers
        self.keep = keep or {}
        self.orig = {k: getattr(m, k) for k, m in self.mods.items()}
        self.calls = {k: [] for k in self.mods}

    def __enter__(self):
        def wrap(name):
            keep = self.keep.get(name, lambda *args, **kw: (args, kw))
            orig, calls = self.orig[name], self.calls[name]

            def fn(*args, **kw):
                calls.append(keep(*args, **kw))
                return orig(*args, **kw)
            return fn

        for name, m in self.mods.items():
            setattr(m, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, m in self.mods.items():
            setattr(m, name, self.orig[name])

    def count(self, name) -> dict:
        counts: dict = {}
        for key in self.calls[name]:
            counts[key] = counts.get(key, 0) + 1
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
    f64 = [k for k in kernels if "f64" in k[2] or "dgemm" in k[2]]
    return {"profiled_wall_ms_per_forward": wall_ms,
            "device_ms_per_forward": busy,
            "forward_ms": forward_ms,
            "busy_share": busy / forward_ms,
            "si_matmul_ms_per_forward": sum(
                k[0] for k in kernels if "si_matmul" in k[2]),
            "f64_kernels_per_forward": sum(k[1] for k in f64),
            "f64_ms_per_forward": sum(k[0] for k in f64),
            "hand_kernels_ms_per_forward": {
                name: sum(k[0] for k in kernels if name in k[2])
                for name in ("si_s8s8", "c3_tc_kernel", "c3_s8_tap_kernel",
                             "c3_quantize_kernel", "c3_fp_kernel")},
            "top_kernels": [[round(ms, 4), cnt, name]
                            for ms, cnt, name in kernels[:top]]}


def check_no_f64(prof, what) -> None:
    """Static int8 with kernels off takes torch._int_mm's s32 product
    (ops/conv.matmul_s8s8_library): its profile has no float64 kernel."""
    if prof["f64_kernels_per_forward"]:
        n = prof["f64_kernels_per_forward"]
        raise AssertionError(f"{what} kernels off: {n} float64 kernels per "
                             f"forward")


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


# ---- yolov5l static int8 with the C3 collapse -------------------------
# yolov5l-640-b16 (ultralytics v6.0 widths and depths), bf16, quant="int8",
# c3_fusion: per forward, the five 3x3 s2 convs with ic >= 128
# (int8_min_channels) reach matmul_s8s8, and the six fused C3 blocks that
# pass c3_profitable at the H100's C3_MIN_WORK reach c3_block, C3_1 (hid
# 64) with s8 taps (the JAX package's choice: the only block with hid <
# 128 at or above its threshold)
INT8 = dict(variant="l", batch=16, image=640, seed=0)
INT8_S8S8_CONVS = 5
INT8_C3_BLOCKS = 6
INT8_C3_S8_BLOCKS = 1
# the fused C3 blocks below c3_profitable (the two 20x20 ones: they run
# c3_chain on the card) and the pointwise convs outside the int8 gate and
# the C3 blocks, which run weight-only through matmul_int8w
INT8_C3_PLAIN_BLOCKS = 2
INT8_INT8W_CONVS = 3
INT8_CALIB_BATCHES = 2
# c3_block vs its plain version: f32 with fp taps elementwise within
# KERNEL_ATOL-class rounding (C3_F32_ATOL x max(1, |ref|)); with bf16
# intermediates or s8 taps an intermediate that lands within rounding of
# a bf16 or int8 step takes the next step on one side, and the residual
# chain carries it on: max within C3_MAX_TOL x scale and mean within
# C3_MEAN_TOL x scale (an indexing or quantization fault moves most
# outputs by O(scale))
C3_F32_ATOL = 1e-5
C3_MAX_TOL = 0.05
C3_MEAN_TOL = 5e-4
# (n, h, w, c, hid, oc, T, shortcut): ragged tile edges (M and the
# channel widths not multiples of 64), several images per tile and
# tiles straddling images, both shortcut forms; hid off 16 (the s8
# taps' element staging) and widths off 8 (bf16 on the f32-FMA tile)
C3_RAGGED = [(2, 9, 7, 16, 8, 16, 2, True), (2, 32, 24, 16, 8, 16, 2, False),
             (3, 20, 20, 64, 72, 48, 1, False), (1, 16, 16, 128, 64, 128, 3,
                                                  True),
             (3, 11, 13, 40, 40, 24, 3, False), (2, 7, 5, 12, 20, 12, 2, True)]
# kernels on vs off over the whole int8 forward (bf16; off runs C3_1 on
# fp taps), each part of a detection row against its own scale: the box
# (x, y, w, h, in pixels) and the scores (objectness and classes, in
# [0, 1]). Limits (max, mean) x scale between the sound reading and the
# fault stand-ins' (scripts/torch_onoff_control.py --int8). On an H100:
# sound box 0.0017 / 3.9e-5, scores 0.0038 / 3.8e-4; a K tile lost in
# matmul_s8s8 box 0.0070 / 2.7e-4, scores 0.026 / 2.9e-3; in
# matmul_int8w box 0.0064 / 1.2e-4, scores 0.0075 / 1.0e-3; mirrored
# 3x3 taps in c3_block box 0.014 / 6.4e-4, scores 0.068 / 6.8e-3
# (PERF.md). Every limit is >= 1.7x sound; each fault exceeds at least
# three of the four
INT8_ONOFF_PARTS = {"box": slice(0, 4), "scores": slice(4, None)}
INT8_ONOFF_TOL = {"box": (0.0035, 7e-5), "scores": (0.01, 6.5e-4)}
INT8_PEAK_OPS = 1979e12      # H100 SXM int8 dense (NVIDIA data sheet)


def int8_engine(device, use_kernels, variant=INT8["variant"],
                batch=INT8["batch"], image=INT8["image"], seed=INT8["seed"],
                compute="bfloat16"):
    """The slice's engine: YOLOv5 `variant`, static int8 with c3_fusion,
    on `device` (seeded random weights); (engine, input, output)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_yolov5

    graph, in_name, out_name = build_yolov5(variant, batch=batch,
                                            image_size=image, seed=seed)
    eng = Engine(EngineConfig(compute_dtype=compute, quant="int8",
                              c3_fusion=True, device=str(device),
                              use_kernels=use_kernels))
    eng.load_model(None, graph=graph)
    return eng, in_name, out_name


def int8_recorder() -> Recorder:
    """A Recorder of every call the int8 path makes to its kernels:
    matmul_s8s8, c3_block and matmul_int8w (the pointwise convs outside
    the int8 gate run weight-only), and of the chains ops/c3.py runs for
    the fused blocks below c3_profitable: c3_chain (bf16 on the card) or
    c3_block_reference (on a CPU tensor c3_block runs it too)."""
    from simpleinfer_tpu_torch.kernels import c3block as kc3
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.ops import c3 as oc3

    return Recorder({"matmul_s8s8": kmm, "matmul_int8w": kmm,
                     "c3_block": kc3, "c3_block_reference": kc3,
                     "c3_chain": oc3})


def _c3_args(gen, device, n, h, w, c, hid, oc, t, s8, dtype, grid=False):
    """Seeded x and weights of a C3 block on `device` (taps int8 with
    their scales when s8). grid=True puts every value on a dyadic grid
    small enough that the f32 sums of the block's first stages are exact
    in any order."""
    import torch
    from simpleinfer_tpu_torch.kernels import c3block as kc3

    def r(*s):
        if grid:
            return torch.randint(-2, 3, s, generator=gen,
                                 device=device).float() / 8
        return torch.randn(*s, generator=gen, device=device) * 0.2

    ws = [r(c, hid), r(hid), r(c, hid), r(hid), r(hid, oc), r(hid, oc),
          r(oc), r(t, hid, hid), r(t, hid), r(t, 9, hid, hid), r(t, hid)]
    scale = None
    if s8:
        wq, wsc = kc3.quantize_taps(ws[9].cpu().numpy())
        ws[9] = torch.from_numpy(wq).to(device)
        scale = torch.from_numpy(wsc).to(device)
    return r(n, h, w, c).to(dtype), ws, scale


def c3_close(got, ref, elementwise: bool):
    """(max |got - ref|, mean, scale, ok) under the c3 limits."""
    d = (got.float() - ref.float()).abs()
    scale = max(1.0, float(ref.float().abs().max()))
    finite = torch_isfinite(got) and got.dtype == ref.dtype
    if elementwise:
        ok = bool((d <= C3_F32_ATOL * scale).all())
    else:
        ok = (float(d.max()) <= C3_MAX_TOL * scale
              and float(d.mean()) <= C3_MEAN_TOL * scale)
    return float(d.max()), float(d.mean()), scale, ok and finite


def int8_kernel_checks(device, rec=None, seed=11, ragged=True,
                       phase="int8_kernel_vs_plain") -> dict:
    """The int8 path's kernels against their plain versions on `device`:
    matmul_s8s8 and c3_block at ragged shapes (matmul: every dim off the
    tiles, f32 and bf16 out, scalar and vector scales, w row-major,
    K-major and both operands misaligned; c3: fp and s8
    taps, f32 and bf16, both shortcut forms, tiles across images, and a
    dyadic-grid block with one bottleneck and no activation whose result
    must agree to f32 rounding), then every call the main path recorded
    (`rec`) to matmul_s8s8, matmul_int8w and c3_block, with its own
    inputs; and the recorded c3_chain calls (the library route below the
    gate) against c3_block_reference within c3_block's bf16 limit.
    Returns the largest max-abs error of each kernel at the main path's
    calls. ragged=False checks the recorded calls only."""
    import torch
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.kernels import c3block as kc3
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.ops import c3 as oc3

    gen = torch.Generator(device=device).manual_seed(seed)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    worst = {"matmul_s8s8": 0.0, "matmul_int8w": 0.0, "c3_block": 0.0}
    failures, n_checks = [], 0
    # each main-path C3 call's distance from the plain version, over its
    # scale: the margin to the bf16 limit, per block
    c3_main = []
    # kernel wrappers and plain versions by the recorder's names (the
    # module attributes, looked up after the recorder has restored them)
    mms = {"matmul_s8s8": (kmm.matmul_s8s8, kmm.matmul_s8s8_ref),
           "matmul_int8w": (kmm.matmul_int8w, kmm.matmul_int8w_ref)}
    c3, c3_ref = kc3.c3_block, kc3.c3_block_reference
    chain = oc3.c3_chain

    def check_mm(name, args, kw, case, main):
        nonlocal n_checks
        kern, plain = mms[name]
        with fp32_parity(True):
            got = kern(*args, **kw)
            sync()
            ref = plain(*args, **kw)
        err, ok = _close(got, ref)
        n_checks += 1
        if not ok:
            failures.append(dict(kernel=name, case=case, max_abs_err=err))
        if main:
            worst[name] = max(worst[name], err)

    def offset_view(t, rows, cols):
        """t's values in a [rows, cols] view one byte past a 16-byte
        boundary (t row-major, or K-major when rows, cols = N, K and the
        caller transposes)."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=device)
        v = buf[1:1 + t.numel()].view(rows, cols)
        v.copy_(t)
        return v

    for (m, k, n) in (RAGGED_SHAPES + [(300, 1152, 200)]) * ragged:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                           dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=device) * 1e-3
        b = torch.randn(n, generator=gen, device=device)
        # w row-major (the wrapper lays it out K-major first), K-major,
        # and both operands at misaligned addresses (element staging)
        layouts = {"row": (xq, wq), "k_major": (xq, kmm.to_k_major(wq)),
                   "offset": (offset_view(xq, m, k),
                              offset_view(wq.t(), n, k).t())}
        for lay, (x_, w_) in layouts.items():
            for od in (torch.bfloat16, torch.float32):
                for act, bias, scale in (("silu", b, sc),
                                         (None, None, torch.tensor(1e-3))):
                    check_mm("matmul_s8s8", (x_, w_, scale, bias, act),
                             {"out_dtype": od},
                             [m, k, n, lay, str(od)[6:], act], False)
    for (n, h, w, c, hid, oc, t, sc_) in C3_RAGGED * ragged:
        for dt in (torch.float32, torch.bfloat16):
            for s8 in (False, True):
                x, ws, scale = _c3_args(gen, device, n, h, w, c, hid, oc, t,
                                        s8, dt)
                with fp32_parity(True):
                    got = c3(x, *ws, btl_b_scale=scale, shortcut=sc_)
                    sync()
                    ref = c3_ref(x, *ws, btl_b_scale=scale, shortcut=sc_)
                err, mean, scl, ok = c3_close(
                    got, ref, dt == torch.float32 and not s8)
                n_checks += 1
                if not ok:
                    failures.append(dict(kernel="c3_block", case=[
                        n, h, w, c, hid, oc, t, sc_, str(dt)[6:], s8],
                        max_abs_err=err, mean_abs_err=mean, scale=scl))
    for (n, h, w, c, hid, oc) in ((2, 9, 7, 16, 8, 16),
                                  (3, 12, 11, 32, 64, 24)) * ragged:
        for s8 in (False, True):
            x, ws, scale = _c3_args(gen, device, n, h, w, c, hid, oc, 1, s8,
                                    torch.float32, grid=True)
            with fp32_parity(True):
                got = c3(x, *ws, btl_b_scale=scale, activation=None)
                sync()
                ref = c3_ref(x, *ws, btl_b_scale=scale, activation=None)
            d = (got - ref).abs()
            scl = max(1.0, float(ref.abs().max()))
            n_checks += 1
            if not bool((d <= 1e-6 * scl).all()):
                failures.append(dict(kernel="c3_block", case=[
                    "grid", n, h, w, c, hid, oc, s8],
                    max_abs_err=float(d.max()), scale=scl))
    for name, calls in (rec.calls.items() if rec else ()):
        if name == "c3_block_reference":
            continue            # the plain version itself
        for args, kw in calls:
            if name == "c3_chain":
                with fp32_parity(True):
                    got = chain(*args, **kw)
                    ref = c3_ref(*args, **kw)
                err, mean, scl, ok = c3_close(got, ref, False)
                n_checks += 1
                c3_main.append({"route": "c3_chain",
                                "x": list(args[0].shape),
                                "max_over_scale": err / scl,
                                "mean_over_scale": mean / scl})
                if not ok:
                    failures.append(dict(route="c3_chain", case=[
                        *args[0].shape], max_abs_err=err, mean_abs_err=mean,
                        scale=scl))
                continue
            if name in mms:
                check_mm(name, args, kw,
                         [*args[0].shape, args[1].shape[1]], True)
                continue
            with fp32_parity(True):
                got = c3(*args, **kw)
                sync()
                ref = c3_ref(*args, **kw)
            err, mean, scl, ok = c3_close(
                got, ref, args[0].dtype == torch.float32
                and kw.get("btl_b_scale") is None)
            n_checks += 1
            worst["c3_block"] = max(worst["c3_block"], err)
            c3_main.append({"route": "c3_block", "x": list(args[0].shape),
                            "s8": kw.get("btl_b_scale") is not None,
                            "max_over_scale": err / scl,
                            "mean_over_scale": mean / scl})
            if not ok:
                failures.append(dict(kernel="c3_block", case=[
                    *args[0].shape, kw.get("btl_b_scale") is not None],
                    max_abs_err=err, mean_abs_err=mean, scale=scl))
            del got, ref
    emit({"phase": phase, "checks": n_checks,
          "failures": failures[:10], "n_failures": len(failures),
          "matmul_tol": f"{KERNEL_ATOL}*max(1,|ref|) + bf16 ulp",
          "main_calls": {k: len(v) for k, v in (rec.calls.items()
                                                if rec else ())},
          "c3_tol": {"f32_fp_taps": f"{C3_F32_ATOL}*max(1,|ref|)",
                     "bf16_or_s8": [C3_MAX_TOL, C3_MEAN_TOL],
                     "grid": "1e-6*max(1,|ref|)"},
          "c3_main_calls": c3_main, "max_abs_err_main": worst})
    if failures:
        raise AssertionError(f"{len(failures)} int8 kernel-vs-plain "
                             f"mismatches")
    return worst


def c3_flops(n, h, w, c, hid, oc, t) -> tuple:
    """(1x1 FLOPs, 3x3 FLOPs) of one C3 block."""
    px = n * h * w
    return (2 * px * (2 * c * hid + t * hid * hid + 2 * hid * oc),
            2 * px * 9 * t * hid * hid)


def c3_block_times(device, args, kw, iters, flush) -> dict:
    """One C3 block on its recorded inputs: c3_block, the bf16 library
    chain ops/c3.c3_chain and c3_block_reference (ms, CUDA events, L2
    flushed before each launch) beside the bound: x, its weights and the
    output moved once against the 1x1 FLOPs at the bf16 (or f32) peak
    plus the 3x3 ops at the int8 peak with s8 taps."""
    from simpleinfer_tpu_torch.kernels import c3block as kc3
    from simpleinfer_tpu_torch.ops import c3 as oc3

    x = args[0]
    n, h, w, c = x.shape
    hid, oc, t_ = args[1].shape[1], args[5].shape[1], args[8].shape[0]
    s8 = kw.get("btl_b_scale") is not None
    f1, f3 = c3_flops(n, h, w, c, hid, oc, t_)
    peak = PEAK_FLOPS[str(x.dtype)[6:]]
    t_o = (f1 / peak + f3 / (INT8_PEAK_OPS if s8 else peak)) * 1e3
    wbytes = sum(a.numel() * a.element_size() for a in args[1:])
    nbytes = x.numel() * x.element_size() * (1 + oc / c) + wbytes
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    return {"x": [n, h, w, c], "hid": hid, "oc": oc, "T": t_, "s8": s8,
            "shortcut": kw.get("shortcut", True), "work": h * w * hid * t_,
            "ms": _time_ms(device, lambda: kc3.c3_block(*args, **kw), iters,
                           flush),
            "plain_ms": _time_ms(device, lambda: kc3.c3_block_reference(
                *args, **kw), 2, flush),
            "chain_ms": _time_ms(device, lambda: oc3.c3_chain(*args, **kw),
                                 iters, flush),
            "bound_ms": max(t_b, t_o), "bytes_ms": t_b, "ops_ms": t_o,
            "gflop": (f1 + f3) / 1e9,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def c3_gate_sweep(device, engine, feeds, iters=5) -> dict:
    """The C3 dispatch gate measured on the card: one forward of the
    kernels-on `engine` with C3_MIN_WORK set to 0, so every fused block
    that c3_supported takes reaches c3_block (its taps still the JAX
    package's choice), each recorded block timed on its own inputs
    (`c3_block_times`), a line per block by its work h*w*hid*T. The gate
    the readings give is the least work from which c3_block beats
    c3_chain at every block at or above it; it is printed beside the
    committed C3_MIN_WORK and the blocks per forward that takes."""
    import torch
    from simpleinfer_tpu_torch.kernels import c3block as kc3

    prev = kc3.C3_MIN_WORK
    kc3.C3_MIN_WORK = 0
    try:
        with Recorder({"c3_block": kc3}) as rec:
            engine.run(feeds)
    finally:
        kc3.C3_MIN_WORK = prev
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    rows = sorted((c3_block_times(device, args, kw, iters, flush)
                   for args, kw in rec.calls["c3_block"]),
                  key=lambda r: r["work"])
    del rec
    for r in rows:
        r["kernel_wins"] = r["ms"] < r["chain_ms"]
        emit({"phase": "c3_gate_sweep_block", **{k: r[k] for k in (
            "work", "x", "hid", "oc", "T", "s8", "ms", "chain_ms",
            "plain_ms", "bound_ms", "bound_by", "kernel_wins")}})
    implied = None
    for r in reversed(rows):
        if not r["kernel_wins"]:
            break
        implied = r["work"]
    res = {"phase": "c3_gate_sweep", "blocks": len(rows),
           "kernel_wins": sum(r["kernel_wins"] for r in rows),
           "implied_min_work": implied, "C3_MIN_WORK": kc3.C3_MIN_WORK,
           "JAX_C3_MIN_WORK": kc3.JAX_C3_MIN_WORK,
           "kernel_blocks_at_gate": sum(r["work"] >= kc3.C3_MIN_WORK
                                        for r in rows),
           "ms_kernel_at_gate": sum(r["ms"] if r["work"] >= kc3.C3_MIN_WORK
                                    else r["chain_ms"] for r in rows),
           "ms_chain_all": sum(r["chain_ms"] for r in rows)}
    emit(res)
    return res


def time_int8_kernels(device, rec, iters=5, s8s8_in_bytes=None,
                      tag="") -> dict:
    """Each kernel at every call one forward recorded, on that call's
    inputs: kernel, plain version and library call ms (CUDA events, L2
    flushed before each launch) beside the bound, summed per forward.
    Library: torch._int_mm on the same int8 operands (s32 out, no
    epilogue) for matmul_s8s8, torch.addmm for matmul_int8w; no single
    PyTorch call computes a C3 block. Bounds: matmul_s8s8 reads the
    conv's own int8 input (not its im2col copy) and weight and writes
    its output, against 2MNK int8 ops; matmul_int8w as in phase 2;
    c3_block reads x and its weights and writes its output, against its
    1x1 FLOPs at the bf16 (or f32) peak plus its 3x3 ops at the int8
    peak with s8 taps. Then the fused blocks below c3_profitable, which
    run the plain version: their count and ms per forward.
    `s8s8_in_bytes`, one per recorded matmul_s8s8 call, replaces the
    3x3-stride-2 estimate of the conv's own input bytes; `tag` prefixes
    the phase names; the C3 parts run where the recorder has them. One
    line per matmul_int8w call (kernel / addmm / bound) and per C3 block
    (kernel / c3_chain / c3_block_reference)."""
    import torch
    from simpleinfer_tpu_torch.kernels import c3block as kc3
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.ops import c3 as oc3

    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    out = {}
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, launches=0)
    lib_err = None
    for i, (args, kw) in enumerate(rec.calls["matmul_s8s8"]):
        xq, wq = args[0], args[1]
        m, k = xq.shape
        n = wq.shape[1]
        od = kw.get("out_dtype", torch.bfloat16)
        # the conv's own int8 input, not its im2col copy: the yolov5l
        # path's calls are 3x3 stride-2 convs, K = 9 IC, N*H*W = 4 M
        in_bytes = (s8s8_in_bytes[i] if s8s8_in_bytes is not None
                    else 4 * m * (k // 9))
        nbytes = in_bytes + k * n + n * 4 + n * 2 + m * n * od.itemsize
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = 2.0 * m * n * k / INT8_PEAK_OPS * 1e3
        wcol = wq.t().contiguous().t()

        def lib():
            try:
                return torch._int_mm(xq, wq)
            except RuntimeError:
                return torch._int_mm(xq, wcol)
        try:
            lib_ms = _time_ms(device, lib, iters, flush)
        except RuntimeError as e:     # reported, not a failure
            lib_ms, lib_err = None, str(e)[:200]
        t = {"ms": _time_ms(device, lambda: kmm.matmul_s8s8(*args, **kw),
                            iters, flush),
             "plain_ms": _time_ms(device, lambda: kmm.matmul_s8s8_ref(
                 *args, **kw), iters, flush),
             "library_ms": lib_ms, "bound_ms": max(t_b, t_o)}
        rows.append({"shape": [m, k, n], **t,
                     "bound_by": "bytes" if t_b >= t_o else "operations"})
        for key in ("ms", "plain_ms", "bound_ms"):
            tot[key] += t[key]
        tot["library_ms"] = (None if lib_ms is None or tot["library_ms"]
                             is None else tot["library_ms"] + lib_ms)
        tot["bytes_ms"] += t_b
        tot["ops_ms"] += t_o
        tot["launches"] += 1
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] \
        else "operations"
    out["matmul_s8s8"] = tot
    emit({"phase": f"{tag}kernel_time_s8s8", "unit": "one forward", **tot,
          "library": "torch._int_mm (s32 out, no epilogue)",
          "library_error": lib_err, "calls": rows})

    # matmul_int8w: the pointwise convs outside the int8 gate, which run
    # weight-only; bound and library as in phase 2 (torch.addmm on the
    # weight dequantized to x's dtype, no activation)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, launches=0)
    rows = []
    for args, kw in rec.calls["matmul_int8w"]:
        x, wq, scale = args[:3]
        bias = args[3] if len(args) > 3 else kw.get("bias")
        m, k = x.shape
        n = wq.shape[1]
        od = kw.get("out_dtype") or x.dtype
        bd, by = bound_ms(m, k, n, x.element_size(), 1, od.itemsize,
                          0 if bias is None else bias.element_size(), True,
                          str(x.dtype)[6:])
        w_deq = (wq.float() * scale).to(x.dtype)
        b = None if bias is None else bias.to(x.dtype)
        lib = ((lambda: torch.addmm(b, x, w_deq)) if b is not None
               else (lambda: torch.mm(x, w_deq)))
        t = {"ms": _time_ms(device, lambda: kmm.matmul_int8w(*args, **kw),
                            iters, flush),
             "plain_ms": _time_ms(device, lambda: kmm.matmul_int8w_ref(
                 *args, **kw), iters, flush),
             "library_ms": _time_ms(device, lib, iters, flush),
             "bound_ms": bd}
        rows.append({"shape": [m, k, n], **t, "bound_by": by})
        emit({"phase": f"{tag}int8w_call_time", "shape": [m, k, n],
              "out": str(od)[6:], **t, "bound_by": by})
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += t[key]
        tot["bytes_ms" if by == "bytes" else "ops_ms"] += bd
        tot["launches"] += 1
        del w_deq, b
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] \
        else "operations"
    out["matmul_int8w"] = tot
    emit({"phase": f"{tag}kernel_time_int8w_int8_path",
          "unit": "one forward", **tot,
          "library": "torch.addmm (no activation)", "calls": rows})
    if "c3_block" not in rec.calls:
        return out

    c3 = dict(ms=0.0, plain_ms=0.0, chain_ms=0.0, library_ms=None,
              bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, launches=0)
    rows = []
    for args, kw in rec.calls["c3_block"]:
        t = c3_block_times(device, args, kw, iters, flush)
        rows.append(t)
        for key in ("ms", "plain_ms", "chain_ms", "bound_ms", "bytes_ms",
                    "ops_ms"):
            c3[key] += t[key]
        c3["launches"] += 1
    c3["bound_by"] = "bytes" if c3["bytes_ms"] >= c3["ops_ms"] \
        else "operations"
    out["c3_block"] = c3
    emit({"phase": "kernel_time_c3", "unit": "one forward", **c3,
          "library": "none: no single PyTorch call computes a C3 block; "
          "chain_ms: ops/c3.c3_chain, the bf16 library chain",
          "calls": rows})
    for r in rows:      # one line per block: kernel beside the chains
        emit({"phase": "c3_block_time", **{k: r[k] for k in (
            "x", "hid", "oc", "T", "s8", "ms", "chain_ms", "plain_ms",
            "bound_ms")}})

    # the fused blocks below c3_profitable: ops/c3.py runs them through
    # c3_chain on the card (bf16), c3_block_reference elsewhere; both
    # timed, the recorded route first
    below = []
    for name in ("c3_chain", "c3_block_reference"):
        for args, kw in rec.calls[name]:
            n, h, w, c = args[0].shape
            row = {"x": [n, h, w, c], "hid": args[1].shape[1],
                   "T": args[8].shape[0], "route": name,
                   "ms": _time_ms(device, lambda: getattr(
                       oc3 if name == "c3_chain" else kc3, name)(
                           *args, **kw), iters, flush),
                   "chain_ms": _time_ms(device, lambda: oc3.c3_chain(
                       *args, **kw), iters, flush),
                   "plain_ms": _time_ms(device, lambda: kc3.c3_block_reference(
                       *args, **kw), 2, flush)}
            below.append(row)
            emit({"phase": "c3_below_gate_block", **row})
    out["c3_below_gate"] = {"blocks": len(below),
                            "ms": sum(b["ms"] for b in below),
                            "plain_ms": sum(b["plain_ms"] for b in below)}
    emit({"phase": "c3_below_gate", "unit": "one forward",
          **out["c3_below_gate"]})
    return out


def int8_main_path(device, engines, n_forwards=2, calib_batches=None,
                   seed=5) -> dict:
    """The slice's main path on `engines` = (kernels on, kernels off,
    input name, output name): calibrate the kernels-on engine on seeded
    batches (wall time reported), install the same scales in the
    kernels-off engine, record one forward's kernel calls, then
    `n_forwards` forwards with every launch count set to 0 just before
    and read just after; the outputs (finite, shape) against the
    kernels-off engine's on the same inputs. Returns the readings and
    the recorder."""
    import tempfile

    import torch
    from simpleinfer_tpu_torch.kernels import c3block as kc3
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    on, off, in_name, out_name = engines
    batch, _h, image, _c = on.program.inputs[0].shape
    rng = np.random.default_rng(seed)

    def feed():
        return {in_name: rng.integers(0, 256, (batch, image, image, 3),
                                      dtype=np.uint8)}

    calib = [feed() for _ in range(calib_batches or INT8_CALIB_BATCHES)]
    t0 = time.perf_counter()
    scales = on.calibrate(calib)
    on.synchronize()
    calib_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "calib.npz")
        on.save_calibration(path)
        off.load_calibration(path)
    feeds = [feed() for _ in range(n_forwards)]
    with int8_recorder() as rec:
        on.run(feeds[0])
    kmm.launches = kmm.launches_s8s8 = kc3.launches = 0
    kmm.transposes_s8s8 = kc3.tc_launches = kc3.weight_copies = 0
    outs = [on.run(f)[out_name] for f in feeds]
    launches = {"matmul_s8s8": kmm.launches_s8s8,
                "c3_block": kc3.launches, "matmul_int8w": kmm.launches}
    transposes = kmm.transposes_s8s8
    c3_tc, c3_copies = kc3.tc_launches, kc3.weight_copies
    if any(o.shape != (batch, 3 * sum((image // s) ** 2
                                      for s in (8, 16, 32)), 85)
           or not np.isfinite(o).all() for o in outs):
        raise AssertionError(f"int8 outputs {[o.shape for o in outs]}, "
                             f"finite={[np.isfinite(o).all() for o in outs]}")
    onoff_ = int8_onoff(off, out_name, feeds, outs)
    c3_calls = rec.calls["c3_block"]
    res = {"phase": "int8_main_path", **INT8, "batch": batch,
           "image": image, "compute": "bfloat16", "quant": "int8",
           "c3_fusion": True, "calibration_batches": len(calib),
           "calibration_s": calib_s, "scales": len(scales),
           "forwards": n_forwards, "launches": launches,
           "s8s8_weight_transposes": transposes,
           "c3_tensor_core_launches": c3_tc,
           "c3_weight_copies": c3_copies,
           "s8s8_convs_per_forward": len(rec.calls["matmul_s8s8"]),
           "int8w_convs_per_forward": len(rec.calls["matmul_int8w"]),
           "c3_kernel_blocks_per_forward": len(c3_calls),
           "c3_s8_blocks_per_forward": sum(
               kw.get("btl_b_scale") is not None for _, kw in c3_calls),
           "c3_plain_blocks_per_forward": len(
               rec.calls["c3_block_reference"]) + len(rec.calls["c3_chain"]),
           "c3_chain_blocks_per_forward": len(rec.calls["c3_chain"]),
           "fused_c3_ops": sum(i.type == "si.FusedC3"
                               for i in on.program.impls),
           "output_shape": list(outs[0].shape),
           "vs_kernels_off": onoff_}
    emit(res)
    if device.type == "cuda":
        check_no_transposes(transposes, "yolov5l int8")
        if c3_copies or c3_tc != launches["c3_block"]:
            raise AssertionError(
                f"c3_block: {c3_copies} weight operands converted or "
                f"copied per call, {c3_tc} of {launches['c3_block']} "
                f"launches on the tensor-core route")
        for name, per in (("matmul_s8s8", INT8_S8S8_CONVS),
                          ("matmul_int8w", INT8_INT8W_CONVS),
                          ("c3_block", INT8_C3_BLOCKS)):
            if launches[name] != per * n_forwards:
                raise AssertionError(
                    f"{name}: {launches[name]} launches over {n_forwards} "
                    f"forwards, expected {per} per forward")
        for key, want in (("c3_s8_blocks_per_forward", INT8_C3_S8_BLOCKS),
                          ("c3_plain_blocks_per_forward",
                           INT8_C3_PLAIN_BLOCKS)):
            if res[key] != want:
                raise AssertionError(f"{key}: {res[key]}, expected {want}")
    return {"res": res, "recorder": rec, "feeds": feeds}


def check_no_transposes(n, what) -> None:
    """Every static-int8 weight of a path reaches matmul_s8s8 K-major
    (Engine.place_weights): the wrapper copied none."""
    if n:
        raise AssertionError(f"{what}: {n} matmul_s8s8 calls had to lay "
                             f"their weight out K-major")


def int8_onoff(off, out_name, feeds, outs) -> dict:
    """Kernels on (`outs`, the kernels-on engine's outputs for `feeds`)
    vs `off`, an engine of the same graph and scales with
    use_kernels=False (matmul_s8s8_ref, the C3 reference chain with fp
    taps): per part of a detection row (INT8_ONOFF_PARTS), max and mean
    |diff| over that part's own scale, max(1, max|off part|)."""
    worst = {part: [0.0, 0.0] for part in INT8_ONOFF_PARTS}
    for f, got in zip(feeds, outs):
        r = parts_onoff(got, off.run(f)[out_name], INT8_ONOFF_TOL)
        for part, w in worst.items():
            w[0] = max(w[0], r[part]["max_abs_over_scale"])
            w[1] = max(w[1], r[part]["mean_abs_over_scale"])
    return {part: {"max_abs_over_scale": mx, "mean_abs_over_scale": mn,
                   "tol": list(INT8_ONOFF_TOL[part])}
            for part, (mx, mn) in worst.items()}


def parts_onoff(got, want, tol: dict, parts=INT8_ONOFF_PARTS) -> dict:
    """Kernels on (`got`) vs off (`want`), per part of the last axis
    (`parts`, all of it for a part not named there): max and mean |diff|
    over that part's own scale, max(1, max|want part|), beside its
    (max, mean) limit in `tol`."""
    out = {}
    for part, lim in tol.items():
        sl = parts.get(part, slice(None))
        w = want[..., sl]
        scale = max(1.0, float(np.abs(w).max()))
        d = np.abs(got[..., sl] - w)
        out[part] = {"max_abs_over_scale": float(d.max()) / scale,
                     "mean_abs_over_scale": float(d.mean()) / scale,
                     "scale": scale, "tol": list(lim)}
    return out


def check_parts(r: dict, what: str) -> None:
    """Fail if a part of a parts_onoff reading is past its limits."""
    for part, v in r.items():
        max_tol, mean_tol = v["tol"]
        if (not v["max_abs_over_scale"] <= max_tol
                or not v["mean_abs_over_scale"] <= mean_tol):
            raise AssertionError(f"{what}, {part}: {r}")


def check_int8_onoff(res) -> None:
    check_parts(res["vs_kernels_off"], "int8 kernels on vs off")


def yolo_int8_phase(device, kernels: dict) -> dict:
    """yolov5l-640-b16 bf16 int8 with the C3 collapse on the card: build
    and calibrate, kernel vs plain (ragged and the recorded main-path
    calls), launches per forward, the C3 gate sweep, forward times (on,
    off, on), a profile, kernels on vs off, and the two kernels' entries
    of the kernels line."""
    import torch

    t0 = time.perf_counter()
    on = int8_engine(device, True)
    off = int8_engine(device, False)
    emit({"phase": "int8_engines", "config": INT8, "load_s":
          time.perf_counter() - t0,
          "weight_bytes_on_card": torch.cuda.memory_allocated(device)})
    engines = (on[0], off[0], on[1], on[2])
    run = int8_main_path(device, engines)
    check_int8_onoff(run["res"])
    rec = run["recorder"]
    worst = int8_kernel_checks(device, rec)
    times = time_int8_kernels(device, rec)
    feeds = {on[1]: run["feeds"][0][on[1]]}
    sweep = c3_gate_sweep(device, on[0], feeds)
    t_on = forward_times(on[0], feeds)
    t_off = forward_times(off[0], feeds)
    t_on2 = forward_times(on[0], feeds)
    ms_on = statistics.median([t_on["median_ms"], t_on2["median_ms"]])
    batch = INT8["batch"]
    emit({"phase": "int8_forward_time", "forward_kernels_on": [t_on, t_on2],
          "forward_kernels_off": t_off,
          "img_per_s_kernels_on": batch * 1e3 / ms_on,
          "img_per_s_kernels_off": batch * 1e3 / t_off["median_ms"]})
    emit({"phase": "int8_profile_kernels_on", **profile_forward(
        on[0], feeds, ms_on, iters=1, top=15)})
    prof_off = profile_forward(off[0], feeds, t_off["median_ms"], iters=1,
                               top=10)
    emit({"phase": "int8_profile_kernels_off", **prof_off})
    check_no_f64(prof_off, "yolov5l int8")
    launches = run["res"]["launches"]
    entries = {}
    for name, src, repl in (
            ("matmul_s8s8", "matmul_s8s8.cu",
             "simpleinfer_tpu/kernels/matmul.py:428"),
            ("c3_block", "c3block.cu",
             "simpleinfer_tpu/kernels/c3block.py:325"),
            ("matmul_int8w", "matmul.cu",
             "simpleinfer_tpu/kernels/matmul.py:183")):
        t = times[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"simpleinfer_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    # matmul_int8w's entry is phase 3's (YOLOv5s) when that ran; this
    # path's own readings go beside it
    entries["c3_block"]["gate_sweep"] = {
        k: sweep[k] for k in ("implied_min_work", "C3_MIN_WORK",
                              "kernel_blocks_at_gate", "ms_kernel_at_gate",
                              "ms_chain_all")}
    int8w = entries.pop("matmul_int8w")
    kernels.setdefault("matmul_int8w", int8w)["yolo_int8"] = {
        k: v for k, v in int8w.items()
        if k not in ("name", "route", "source", "replaces")}
    kernels.update(entries)
    del rec, run
    return {"ms_on": ms_on, "ms_off": t_off["median_ms"]}


def yolo_int8_rehearsal(device, image=64, batch=2) -> dict:
    """The int8 phase's main path and kernel checks at a tiny size (the
    CPU tests run it with the plain versions): yolov5l at `image`, with
    both c3_profitable thresholds (the H100's and the JAX package's)
    scaled by (image / 640)^2 so the same blocks take the kernel and the
    same one its s8 taps."""
    from simpleinfer_tpu_torch.kernels import c3block as kc3

    prev = kc3.C3_MIN_WORK, kc3.JAX_C3_MIN_WORK
    kc3.C3_MIN_WORK = int(prev[0] * (image / 640) ** 2)
    kc3.JAX_C3_MIN_WORK = int(prev[1] * (image / 640) ** 2)
    try:
        on = int8_engine(device, True, batch=batch, image=image)
        off = int8_engine(device, False, batch=batch, image=image)
        run = int8_main_path(device, (on[0], off[0], on[1], on[2]),
                             n_forwards=1, calib_batches=1)
        check_int8_onoff(run["res"])
        int8_kernel_checks(device, run["recorder"])
    finally:
        kc3.C3_MIN_WORK, kc3.JAX_C3_MIN_WORK = prev
    return run["res"]


# ---- conv3x3_s1_same and stem_s2d ---------------------------------------
# no op dispatches either kernel (nor its Pallas original in the JAX
# package): the phase drives each through its own entry point at the
# shapes of the models the port runs
CONV_MODELS = (("resnet50", dict(batch=128, image_size=224), "relu"),
               ("yolov5s", dict(variant="s", batch=8, image_size=640),
                "silu"))
# (n, h, w, c, oc): H x W of 1x1, 5x7 and 3x33; C and OC off 8 and 64
CONV_RAGGED = [(2, 1, 1, 3, 5), (2, 5, 7, 13, 17), (1, 3, 33, 70, 131),
               (3, 5, 7, 129, 66)]
# (N, variant): the stem at the YOLOv5s-640 (OC 32) and yolov5l-640
# (OC 64) widths
STEM_CASES = ((8, "s"), (1, "s"), (8, "l"), (1, "l"))


def spatial_sizes(graph) -> dict:
    """(H, W) of every operand up to the head of a CNN graph, from the
    input's declared shape through convs, pools and upsamples (other ops
    keep their first input's size)."""
    hw = {}
    for op in graph.ops:
        p = {k: v.value for k, v in op.params.items()}
        if op.type == "pnnx.Input":
            hw[op.outputs[0].name] = tuple(op.outputs[0].shape[2:4])
            continue
        if not op.inputs or op.inputs[0].name not in hw:
            continue
        h, w = hw[op.inputs[0].name]
        if op.type in ("nn.Conv2d", "nn.MaxPool2d"):
            (kh, kw), (sh, sw) = p["kernel_size"], p["stride"]
            (ph, pw), (dh, dw) = p["padding"], p.get("dilation", [1, 1])
            h = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            w = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        elif op.type == "nn.Upsample":
            h, w = int(h * p["scale_factor"][0]), int(w * p["scale_factor"][1])
        for r in op.outputs:
            hw[r.name] = (h, w)
    return hw


def fused_graph(name, kw):
    """A zoo graph after the port's load-time fusions (conv+bn folded,
    activations tagged), without loading it into an engine."""
    from simpleinfer_tpu_torch.config import EngineConfig
    from simpleinfer_tpu_torch.ir.expression import expand_expression
    from simpleinfer_tpu_torch.ir.passes import run_inference_fusions
    from simpleinfer_tpu_torch import zoo

    build = zoo.build_resnet50 if name == "resnet50" else zoo.build_yolov5
    graph = build(**kw)[0]
    expand_expression(graph)
    run_inference_fusions(graph, EngineConfig(device="cpu"))
    return graph


def conv3x3_main_convs(models=CONV_MODELS) -> list:
    """Every distinct (model, N, H, W, C, OC, activation) of a 3x3 stride-1
    pad-1 ungrouped zero-padded conv in the fused graphs, with the folded
    fp32 HWIO weight and bias of its first conv."""
    out, seen = [], set()
    for name, kw, want_act in models:
        graph = fused_graph(name, kw)
        hw = spatial_sizes(graph)
        for op in graph.ops:
            p = {k: v.value for k, v in op.params.items()}
            if (op.type != "nn.Conv2d" or len(op.inputs) != 1
                    or p["kernel_size"] != [3, 3] or p["stride"] != [1, 1]
                    or p["padding"] != [1, 1] or p["dilation"] != [1, 1]
                    or p["groups"] != 1 or p["padding_mode"] != "zeros"):
                continue
            act = p.get("si_fused_act")
            h, w = hw[op.inputs[0].name]
            key = (name, kw["batch"], h, w, p["in_channels"],
                   p["out_channels"], act)
            if key in seen:
                continue
            if act != want_act:
                raise AssertionError(f"{name} {op.name}: activation {act}")
            seen.add(key)
            w_hwio = np.ascontiguousarray(
                op.attrs["weight"].array().transpose(2, 3, 1, 0))
            out.append((*key, w_hwio, op.attrs["bias"].array()))
    return out


def stem_weights(variant):
    """The folded stem conv (OIHW [OC, 3, 6, 6], bias, activation) of a
    fused YOLOv5-640 graph."""
    graph = fused_graph("yolov5", dict(variant=variant, batch=1,
                                       image_size=640))
    op = next(o for o in graph.ops if o.type == "nn.Conv2d")
    return (op.attrs["weight"].array(), op.attrs["bias"].array(),
            op.params["si_fused_act"].value)


def conv_bound(nbytes, flops) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def conv_kernels_phase(device, convs=None, stem_cases=STEM_CASES,
                       seed=21) -> dict:
    """conv3x3_s1_same and stem_s2d through their own entry points at the
    main shapes (counts set to 0 just before, read just after), then
    each against its plain version there and (conv3x3) at ragged shapes,
    then their times beside plain, library and bound on a card. Returns
    the two entries of the kernels line."""
    import torch
    import torch.nn.functional as F
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.kernels import conv3x3 as kc
    from simpleinfer_tpu_torch.kernels import stem as ks
    from simpleinfer_tpu_torch.kernels.matmul import resolve_activation

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = conv3x3_main_convs() if convs is None else convs
    # (args of the entry point, case): x bf16, w, bias, activation
    conv_in = [((torch.randn(n, h, w, c, generator=gen, device=device)
                 .to(torch.bfloat16), torch.from_numpy(w_hwio).to(device),
                 torch.from_numpy(bias).to(device), act),
                [model, n, h, w, c, oc, act])
               for (model, n, h, w, c, oc, act, w_hwio, bias) in convs]
    rng = np.random.default_rng(seed)
    stems, stem_in = {}, []
    for n, variant in stem_cases:
        if variant not in stems:
            stems[variant] = stem_weights(variant)
        w_oihw, bias, act = stems[variant]
        img = rng.integers(0, 256, (n, 640, 640, 3), dtype=np.uint8)
        x_img = img.astype(np.float32) / 255
        args = (torch.from_numpy(ks.pack_stem_input(x_img)).to(
                    device, torch.bfloat16),
                torch.from_numpy(ks.pack_stem_weights(w_oihw)).to(device),
                torch.from_numpy(bias).to(device), act)
        stem_in.append((args, [n, w_oihw.shape[0], act], x_img, w_oihw))

    # the path: each kernel through its entry point at the main shapes
    kc.launches = ks.launches = 0
    conv_out = [kc.conv3x3_s1_same(*args) for args, _ in conv_in]
    stem_out = [ks.stem_s2d(*args) for args, _, _, _ in stem_in]
    sync()
    launches = {"conv3x3_s1_same": kc.launches, "stem_s2d": ks.launches}
    if cuda and launches != {"conv3x3_s1_same": len(conv_in),
                             "stem_s2d": len(stem_in)}:
        raise AssertionError(f"conv kernel launches {launches}, expected "
                             f"{len(conv_in)} and {len(stem_in)}")

    failures, n_checks = [], 0
    worst = {"conv3x3_s1_same": 0.0, "stem_s2d": 0.0}

    def check(name, got, ref, case, main):
        nonlocal n_checks
        err, ok = _close(got, ref)
        n_checks += 1
        if not ok:
            failures.append(dict(kernel=name, case=case, max_abs_err=err))
        if main:
            worst[name] = max(worst[name], err)

    with fp32_parity(True):   # no TF32 in the plain versions' convs
        for (args, case), got in zip(conv_in, conv_out):
            check("conv3x3_s1_same", got, kc.conv3x3_s1_same_ref(*args),
                  case, True)
        for (n, h, w, c, oc) in CONV_RAGGED:
            for x_dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(n, h, w, c, generator=gen,
                                device=device).to(x_dtype)
                wt = torch.randn(3, 3, c, oc, generator=gen,
                                 device=device) / math.sqrt(9 * c)
                bias = 0.1 * torch.randn(oc, generator=gen, device=device)
                for act in ACTIVATIONS:
                    for b in (bias, None):
                        got = kc.conv3x3_s1_same(x, wt, b, act)
                        sync()
                        check("conv3x3_s1_same", got,
                              kc.conv3x3_s1_same_ref(x, wt, b, act),
                              [n, h, w, c, oc, str(x_dtype)[6:], act,
                               b is not None], False)
        for (args, case, _, _), got in zip(stem_in, stem_out):
            check("stem_s2d", got, ks.stem_s2d_ref(*args), case, True)
            got = ks.stem_s2d(*args[:3])
            sync()
            check("stem_s2d", got, ks.stem_s2d_ref(*args[:3]),
                  case[:2] + [None], False)
    emit({"phase": "conv_kernel_vs_plain", "checks": n_checks,
          "failures": failures[:10], "n_failures": len(failures),
          "atol": f"{KERNEL_ATOL}*max(1,|ref|)",
          "bf16_out_rtol": KERNEL_BF16_RTOL,
          "main_shapes": {"conv3x3_s1_same": [c for _, c in conv_in],
                          "stem_s2d": [s[1] for s in stem_in]},
          "launches": launches, "max_abs_err_main": worst})
    if failures:
        raise AssertionError(f"{len(failures)} conv kernel-vs-plain "
                             f"mismatches")
    entries = {
        name: {"name": name, "route": "cuda",
               "source": f"simpleinfer_tpu_torch/csrc/{src}",
               "replaces": repl, "launches": launches[name],
               "max_abs_err": worst[name]}
        for name, src, repl in (
            ("conv3x3_s1_same", "conv3x3.cu",
             "simpleinfer_tpu/kernels/conv3x3.py:118"),
            ("stem_s2d", "stem.cu", "simpleinfer_tpu/kernels/stem.py:141"))}
    if not cuda:
        return entries

    # times, each main shape once (the unit of the kernels line: one
    # launch per main shape, summed). Library: F.conv2d on the
    # channels-last bf16 tensor (the stem's on the unpacked image, pad 2)
    # + bias + activation
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0) for k in entries}
    rows = []

    def timed(name, case, kern, plain, lib_x, lib_w, lib_b, act, stride,
              pad, nbytes, flops):
        fa = resolve_activation(act)
        w_lib, b_lib = lib_w.to(torch.bfloat16), lib_b.to(torch.bfloat16)
        bd, by = conv_bound(nbytes, flops)
        t = {"ms": _time_ms(device, kern, flush=flush),
             "plain_ms": _time_ms(device, plain, flush=flush),
             "library_ms": _time_ms(device, lambda: fa(F.conv2d(
                 lib_x.permute(0, 3, 1, 2), w_lib, b_lib, stride=stride,
                 padding=pad)), flush=flush),
             "bound_ms": bd}
        rows.append({"kernel": name, "case": case, **t, "bound_by": by})
        emit({"phase": f"{name}_shape_time", "case": case, **t,
              "bound_by": by})
        for k, v in t.items():
            tot[name][k] += v
        tot[name]["bytes_ms" if by == "bytes" else "ops_ms"] += bd

    for args, case in conv_in:
        x, w, b, act = args
        n, h, wd, c = x.shape
        oc = w.shape[3]
        timed("conv3x3_s1_same", case, lambda: kc.conv3x3_s1_same(*args),
              lambda: kc.conv3x3_s1_same_ref(*args), x,
              w.permute(3, 2, 0, 1).contiguous(), b, act, 1, 1,
              2 * n * h * wd * (c + oc) + 18 * c * oc + 4 * oc,
              2.0 * n * h * wd * 9 * c * oc)
    for args, case, x_img, w_oihw in stem_in:
        xp, wp, b, act = args
        n, oc = case[:2]
        timed("stem_s2d", case, lambda: ks.stem_s2d(*args),
              lambda: ks.stem_s2d_ref(*args),
              torch.from_numpy(x_img).to(device, torch.bfloat16),
              torch.from_numpy(w_oihw).to(device), b, act, 2, 2,
              xp.numel() * 2 + wp.numel() * 2 + 4 * oc
              + n * 320 * 320 * oc * 2, 2.0 * n * 320 * 320 * 108 * oc)
    for name, t in tot.items():
        by = "bytes" if t.pop("bytes_ms") >= t.pop("ops_ms") else \
            "operations"
        entries[name].update(t, bound_by=by)
    emit({"phase": "conv_kernel_time", "unit": "one launch per main shape",
          "library": "F.conv2d on the channels-last bf16 tensor (for the "
          "stem the unpacked image, pad 2) + bias + activation",
          "rows": rows, "per_unit": {k: {kk: v for kk, v in e.items()
                                         if kk.endswith("ms")}
                                     for k, e in entries.items()}})
    return entries


# ---- ResNet-50 static int8: the CNN classification path ------------------
# ResNet-50-224-b128 (torchvision's widths and depths, 25.6 M parameters,
# nothing cut), bf16, quant="int8" per-tensor. Per forward, by the gates
# of ops/conv.py: the 33 pointwise stride-1 convs are outside the int8
# gate (kernel_area 1) and run weight-only through matmul_int8w; the 13
# 3x3 convs with ic >= 128 (10 stride 1, 3 stride 2) and the fc
# (nn.Linear, every static-int8 product) reach matmul_s8s8; the stem,
# stage 1's 3x3s (ic 64) and the 3 strided downsample 1x1s run cuDNN
RESNET = dict(batch=128, image_size=224, num_classes=1000, seed=0)
RESNET_INT8W_CONVS = 33
RESNET_S8S8_CALLS = 14
RESNET_CALIB_BATCHES = 2
# kernels on vs off (off: matmul_s8s8_ref and cuDNN), the logits over
# their scale max(1, max|off|): (max, mean) limits between the sound
# reading and the fault stand-in's (scripts/torch_onoff_control.py
# --resnet; PERF.md)
RESNET_ONOFF_TOL = (0.05, 0.01)
RESNET_CLASSIFY_IMAGES = 8


def resnet_engine(device, use_kernels, batch=RESNET["batch"],
                  image=RESNET["image_size"], compute="bfloat16",
                  quant="int8", **build_kw):
    """ResNet-50 (seeded random weights) in an Engine on `device`;
    (engine, input name, output name)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_resnet50

    kw = {**RESNET, "batch": batch, "image_size": image, **build_kw}
    graph, in_name, out_name = build_resnet50(**kw)
    eng = Engine(EngineConfig(compute_dtype=compute, quant=quant,
                              device=str(device), use_kernels=use_kernels))
    eng.load_model(None, graph=graph)
    return eng, in_name, out_name


def resnet_onoff(off, out_name, feeds, outs) -> dict:
    """Kernels-on logits `outs` against `off` on the same feeds: max and
    mean |diff| over max(1, max|off|), and top-1 agreement (reported,
    not gated: random weights leave near-ties)."""
    worst, agree, rows = [0.0, 0.0], 0, 0
    for f, got in zip(feeds, outs):
        want = off.run(f)[out_name]
        scale = max(1.0, float(np.abs(want).max()))
        d = np.abs(got - want)
        worst = [max(worst[0], float(d.max()) / scale),
                 max(worst[1], float(d.mean()) / scale)]
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        rows += got.shape[0]
    return {"max_abs_over_scale": worst[0], "mean_abs_over_scale": worst[1],
            "top1_agreement": agree / rows, "tol": list(RESNET_ONOFF_TOL)}


def check_resnet_onoff(r) -> None:
    if (r["max_abs_over_scale"] > RESNET_ONOFF_TOL[0]
            or r["mean_abs_over_scale"] > RESNET_ONOFF_TOL[1]):
        raise AssertionError(f"resnet int8 kernels on vs off: {r}")


def resnet_main_path(device, engines, n_forwards=2, calib_batches=None,
                     seed=9) -> dict:
    """The slice's main path on `engines` = (kernels on, kernels off,
    input name, output name): calibrate the kernels-on engine on seeded
    batches (wall time reported), install the same scales in the other,
    record one forward's kernel calls, then `n_forwards` forwards with
    the launch counts set to 0 just before and read just after; logits
    (finite, shape) against the kernels-off engine's."""
    import tempfile

    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.ops import conv as tconv
    from simpleinfer_tpu_torch.quant.tensor import QuantizedActivation

    on, off, in_name, out_name = engines
    batch, image = on.program.inputs[0].shape[:2]
    rng = np.random.default_rng(seed)

    def feed():     # ImageNet-normalized scale
        return {in_name: rng.standard_normal(
            (batch, image, image, 3), dtype=np.float32)}

    calib = [feed() for _ in range(calib_batches or RESNET_CALIB_BATCHES)]
    t0 = time.perf_counter()
    scales = on.calibrate(calib)
    on.synchronize()
    calib_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "calib.npz")
        on.save_calibration(path)
        off.load_calibration(path)
    feeds = [feed() for _ in range(n_forwards)]

    def conv_in_bytes(x, *a, **kw):     # the int8 conv's own input
        t = x.data if isinstance(x, QuantizedActivation) else x
        return int(t.numel())
    with Recorder({"matmul_s8s8": kmm, "matmul_int8w": kmm}) as rec, \
            Recorder({"conv2d_int8_static": tconv},
                     keep={"conv2d_int8_static": conv_in_bytes}) as crec:
        on.run(feeds[0])
    kmm.launches = kmm.launches_s8s8 = kmm.transposes_s8s8 = 0
    outs = [on.run(f)[out_name] for f in feeds]
    launches = {"matmul_int8w": kmm.launches,
                "matmul_s8s8": kmm.launches_s8s8}
    transposes = kmm.transposes_s8s8
    if any(o.shape != (batch, RESNET["num_classes"])
           or not np.isfinite(o).all() for o in outs):
        raise AssertionError(f"resnet outputs {[o.shape for o in outs]}")
    conv_bytes = crec.calls["conv2d_int8_static"]
    in_bytes = conv_bytes + [int(args[0].numel()) for args, _ in
                             rec.calls["matmul_s8s8"][len(conv_bytes):]]
    res = {"phase": "resnet_int8_main_path", **RESNET, "batch": batch,
           "image_size": image, "compute": "bfloat16", "quant": "int8",
           "act_per_channel": False, "calibration_batches": len(calib),
           "calibration_s": calib_s, "scales": len(scales),
           "forwards": n_forwards, "launches": launches,
           "s8s8_weight_transposes": transposes,
           "predicted_per_forward": {"matmul_int8w": RESNET_INT8W_CONVS,
                                     "matmul_s8s8": RESNET_S8S8_CALLS},
           "int8w_calls_per_forward": len(rec.calls["matmul_int8w"]),
           "s8s8_calls_per_forward": len(rec.calls["matmul_s8s8"]),
           "s8s8_conv_calls_per_forward": len(conv_bytes),
           "output_shape": list(outs[0].shape),
           "vs_kernels_off": resnet_onoff(off, out_name, feeds, outs)}
    emit(res)
    if device.type == "cuda":
        check_no_transposes(transposes, "ResNet-50 int8")
    for name, per in (("matmul_int8w", RESNET_INT8W_CONVS),
                      ("matmul_s8s8", RESNET_S8S8_CALLS)):
        calls = len(rec.calls[name])
        if calls != per or (device.type == "cuda"
                            and launches[name] != per * n_forwards):
            raise AssertionError(
                f"{name}: {calls} calls per forward, {launches[name]} "
                f"launches over {n_forwards} forwards; expected {per}")
    return {"res": res, "recorder": rec, "feeds": feeds,
            "s8s8_in_bytes": in_bytes}


def resnet_fp32_card_vs_cpu(device, batch=2, image=64, width=16,
                            seed=0) -> dict:
    """fp32 ResNet-18 on `device` against the port on the CPU (TF32 off
    on the card, as Engine.forward sets it): within FP32_TOL * scale."""
    import torch
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_resnet18

    outs = []
    x = np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32)
    for dev in (device, torch.device("cpu")):
        g, in_name, out_name = build_resnet18(batch=batch, image_size=image,
                                              width=width)
        eng = Engine(EngineConfig(device=str(dev))).load_model(None, graph=g)
        outs.append(eng.run({in_name: x})[out_name])
    got, want = outs
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    res = {"phase": "resnet_fp32_card_vs_cpu", "shape": list(got.shape),
           "max_abs_err": err, "scale": scale, "tol": f"{FP32_TOL}*scale"}
    emit(res)
    if not err <= FP32_TOL * scale:
        raise AssertionError(f"resnet18 fp32 card vs CPU: {res}")
    return res


def resnet_classify(engine, n=RESNET_CLASSIFY_IMAGES, seed=17) -> list:
    """classify_images on `n` seeded 256x320 u8 images: top-5 each."""
    from simpleinfer_tpu_torch.zoo.classify import classify_images

    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (256, 320, 3), dtype=np.uint8)
              for _ in range(n)]
    top = classify_images(engine, images, k=5)
    if len(top) != n or any(len(t) != 5 for t in top):
        raise AssertionError(f"classify_images gave {top}")
    emit({"phase": "resnet_classify_images", "images": n,
          "image_shape": [256, 320, 3],
          "top5": [[[c, round(p, 6)] for c, p in t] for t in top]})
    return top


def resnet_int8_phase(device, kernels: dict) -> dict:
    """ResNet-50-224-b128 bf16 static int8 on the card: build and
    calibrate, launches per forward, both kernels against their plain
    versions at every recorded call, their times, forwards on / off / on,
    a profile, on vs off, classify_images and the fp32 ResNet-18 check;
    adds the path's readings to the two kernels' entries."""
    import torch

    t0 = time.perf_counter()
    on = resnet_engine(device, True)
    off = resnet_engine(device, False)
    emit({"phase": "resnet_engines", "config": RESNET, "load_s":
          time.perf_counter() - t0,
          "weight_bytes_on_card": torch.cuda.memory_allocated(device)})
    run = resnet_main_path(device, (on[0], off[0], on[1], on[2]))
    check_resnet_onoff(run["res"]["vs_kernels_off"])
    rec = run["recorder"]
    worst = int8_kernel_checks(device, rec, ragged=False,
                               phase="resnet_kernel_vs_plain")
    times = time_int8_kernels(device, rec, s8s8_in_bytes=run["s8s8_in_bytes"],
                              tag="resnet_")
    del rec
    run.pop("recorder")
    torch.cuda.empty_cache()
    feeds = {on[1]: run["feeds"][0][on[1]]}
    t_on = forward_times(on[0], feeds)
    t_off = forward_times(off[0], feeds)
    t_on2 = forward_times(on[0], feeds)
    ms_on = statistics.median([t_on["median_ms"], t_on2["median_ms"]])
    batch = RESNET["batch"]
    emit({"phase": "resnet_forward_time", "forward_kernels_on": [t_on, t_on2],
          "forward_kernels_off": t_off,
          "img_per_s_kernels_on": batch * 1e3 / ms_on,
          "img_per_s_kernels_off": batch * 1e3 / t_off["median_ms"]})
    emit({"phase": "resnet_profile_kernels_on", **profile_forward(
        on[0], feeds, ms_on, iters=1, top=15)})
    prof_off = profile_forward(off[0], feeds, t_off["median_ms"], iters=1,
                               top=10)
    emit({"phase": "resnet_profile_kernels_off", **prof_off})
    check_no_f64(prof_off, "resnet-50 int8")
    resnet_classify(on[0])
    del on, off
    torch.cuda.empty_cache()
    resnet_fp32_card_vs_cpu(device)
    launches = run["res"]["launches"]
    for name, src, repl in (
            ("matmul_s8s8", "matmul_s8s8.cu",
             "simpleinfer_tpu/kernels/matmul.py:428"),
            ("matmul_int8w", "matmul.cu",
             "simpleinfer_tpu/kernels/matmul.py:183")):
        t = times[name]
        entry = {"launches": launches[name], "max_abs_err": worst[name],
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"]}
        # the entry of an earlier phase, when it ran; this path's
        # readings go beside it
        kernels.setdefault(name, {"name": name, "route": "cuda",
                                  "source": f"simpleinfer_tpu_torch/csrc/"
                                  f"{src}", "replaces": repl, **entry})[
            "resnet_int8"] = entry
    return {"ms_on": ms_on, "ms_off": t_off["median_ms"]}


def resnet_int8_rehearsal(device, image=64, batch=2) -> dict:
    """The resnet_int8 main path at a tiny size (the CPU tests run it
    with the plain versions): ResNet-50 at full width, `image` pixels."""
    on = resnet_engine(device, True, batch=batch, image=image)
    off = resnet_engine(device, False, batch=batch, image=image)
    run = resnet_main_path(device, (on[0], off[0], on[1], on[2]),
                           n_forwards=1, calib_batches=1)
    check_resnet_onoff(run["res"]["vs_kernels_off"])
    int8_kernel_checks(device, run["recorder"], ragged=False,
                       phase="resnet_kernel_vs_plain")
    resnet_classify(on[0], n=2)
    return run["res"]


# ---- llama generation path ----------------------------------------------
# llama "base" (16 layers, width 2048, 32 heads, 8 kv heads, SwiGLU 5456,
# vocab 32000), bf16 compute, int4w g128, served by GenerationService
LLAMA = dict(variant="base", seq_len=2048, vocab_size=32000, seed=0)
SERVICE = dict(slots=16, kv_dtype="bfloat16")
N_REQUESTS, PROMPT_RANGE, MAX_NEW = 48, (32, 1900), 64
# flash kernel vs plain in bf16: both round P to bf16 before P.V (the
# TPU body's semantics), the kernel its unnormalized P of each 64-key
# tile, the plain version the normalized P (as the JAX oracle does). Each
# rounding moves a row's output by at most 2^-8 (bf16's unit roundoff)
# times sum_j p_j |v_j|, so the two sides may differ by twice that: the
# check adds 2 x 2^-8 x sum_j p_j |v_j| per element
FLASH_BF16_P_ROUNDOFF = 2.0 ** -7
# kernels on vs off (two bf16 engines of the same int4 weights), over 16
# layers of random weights: the kernels dequantize in f32 and keep f32
# projection outputs and P, the torch paths round the dequantized
# weights, the projection outputs and P to bf16. On an H100 the two
# differ by 0.068 / 0.011 x scale (max / mean; PERF.md)
ONOFF_MAX_TOL = 0.15
ONOFF_MEAN_TOL = 0.02
# and against an fp32 engine of the same int4 weights: both sides read
# the same distance from fp32 on an H100 (ratio 1.0-1.1, PERF.md), so
# the kernels' side may be at most this much farther than the torch side
ONOFF_VS_FP32 = 1.25


def _ms_stats(xs) -> dict:
    xs = sorted(xs)
    return {"median_ms": statistics.median(xs),
            "p99_ms": xs[min(len(xs) - 1, math.ceil(0.99 * len(xs)) - 1)],
            "max_ms": xs[-1], "n": len(xs)}


def _close_tol(got, ref, atol, rtol=0.0):
    """max |got - ref|, whether every element is within atol + rtol *
    |ref| (both finite), and the largest share of that limit used."""
    d = (got.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    ok = bool((d <= lim).all()) and bool(torch_isfinite(got))
    if not d.numel():
        return 0.0, ok, 0.0
    return float(d.max()), ok, float((d / lim).max())


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def _int4_case(gen, device, m, k, n, x_dtype, group=128):
    """x [M, K] at x_dtype, a [K, N] weight (~unit-scale outputs)
    quantized to int4 on the host, an f32 bias; on `device`."""
    import torch
    from simpleinfer_tpu_torch.quant.tensor import quantize_int4_grouped

    x = torch.randn(m, k, generator=gen, device=device).to(x_dtype)
    w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
    q = quantize_int4_grouped(w.cpu().numpy(), group=group).to(device)
    bias = 0.1 * torch.randn(n, generator=gen, device=device)
    return x, q, bias


def _decode_case(gen, device, n, kvh, g, length, d, q_dtype, cache):
    """q [N, KV, G, D] and (k, v) cache leaves: bf16/f32 tensors, or int8
    (values, [.., 1] scales) tuples quantized like the decoder does."""
    import torch
    from simpleinfer_tpu_torch.zoo.generate import _kv_quantize

    q = torch.randn(n, kvh, g, d, generator=gen, device=device).to(q_dtype)
    k = torch.randn(n, kvh, length, d, generator=gen, device=device)
    v = torch.randn(n, kvh, length, d, generator=gen, device=device)
    if cache == "int8":
        return q, _kv_quantize(k), _kv_quantize(v)
    dt = getattr(torch, cache)
    return q, k.to(dt), v.to(dt)


def llama_kernel_checks(device, main_shapes=None, seed=3) -> dict:
    """matmul_int4w, flash_attention and decode_attention against their
    plain versions on `device`: at the main path's shapes (recorded from
    the service run, when given) and at ragged ones; f32 and bf16;
    decode lengths 0, 1, straddling a 64-position tile and full, at the
    edges of the split's shares, with a max_len under L, bf16, f32 and
    int8 leaves, and at the service's decode shape (16 rows, L 2048),
    every decode case run twice on the card and required bit-equal;
    flash causal, non-causal and banded. Returns the largest max-abs
    error of each kernel at the main path's configuration."""
    import torch
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.kernels import attention as kattn
    from simpleinfer_tpu_torch.kernels import decode_attn as kdec
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    gen = torch.Generator(device=device).manual_seed(seed)
    main_shapes = main_shapes or {}
    worst = {"matmul_int4w": 0.0, "flash_attention": 0.0,
             "decode_attention": 0.0}
    used = dict(worst)        # the largest share of a limit, main shapes
    failures, n_checks = [], 0

    def check(name, got, ref, atol, rtol, case, main):
        nonlocal n_checks
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # faults show here
        err, ok, share = _close_tol(got, ref, atol, rtol)
        n_checks += 1
        if not ok or got.dtype != ref.dtype:
            failures.append(dict(kernel=name, case=case, max_abs_err=err))
        if main:
            worst[name] = max(worst[name], err)
            used[name] = max(used[name], share)

    # matmul_int4w: (M, K, N, x dtype, out dtype, bias, act, main?)
    cases = [(m, k, n, xd, od, b, a, True)
             for (m, k, n, xd, od, b, a) in main_shapes.get("matmul_int4w",
                                                            [])]
    ragged = [(1, 200, 70, 128), (37, 129, 131, 64), (100, 256, 50, 128),
              (17, 384, 96, 128), (16, 2048, 33, 128), (64, 130, 64, 32)]
    if device.type == "cuda":   # the down projection's K, the MLP's N
        ragged.append((17, 5456, 5456, 128))
    for (m, k, n, group) in ragged:
        for xd in ("float32", "bfloat16"):
            cases.append((m, k, n, xd, "float32", True, "silu", False,
                          group))
            cases.append((m, k, n, xd, xd, False, None, False, group))
    for c in cases:
        m, k, n, xd, od, use_b, act, main = c[:8]
        group = c[8] if len(c) > 8 else 128
        x, q, bias = _int4_case(gen, device, m, k, n, getattr(torch, xd),
                                group)
        b = bias.to(getattr(torch, xd)) if use_b else None
        od_t = getattr(torch, od)
        with fp32_parity(True):
            got = kmm.matmul_int4w(x, q, b, act, out_dtype=od_t)
            ref = kmm.matmul_int4w_ref(x, q, b, act, out_dtype=od_t)
        lim = KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
        check("matmul_int4w", got, ref, lim,
              KERNEL_BF16_RTOL if od_t == torch.bfloat16 else 0.0,
              [m, k, n, xd, od, use_b, act, group], main)
        del x, q, bias

    # flash_attention: (B, H, Lq, Lk, D, dtype, causal, window, main?)
    fcases = [(b, h, l, l, d, dt, True, None, True)
              for (b, h, l, d, dt) in main_shapes.get("flash_attention", [])]
    for dt in ("float32", "bfloat16"):
        fcases += [(2, 3, 100, 100, 24, dt, True, None, False),
                   (1, 4, 77, 130, 64, dt, False, None, False),
                   (2, 2, 300, 300, 64, dt, True, 50, False),
                   (1, 2, 200, 200, 128, dt, True, 64, False),
                   (1, 2, 129, 129, 256, dt, True, None, False)]
        if device.type == "cuda":   # the main path's width, banded
            fcases.append((1, 32, 2048, 2048, 64, dt, True, 256, False))
    if device.type == "cuda":       # head_dim 128 at the main width
        fcases.append((1, 8, 2048, 2048, 128, "bfloat16", True, None, False))
    for (b, h, lq, lk, d, dt, causal, sw, main) in fcases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, h, l_, d, generator=gen, device=device)
                   .to(dtype) for l_ in (lq, lk, lk))
        with fp32_parity(True):
            got = kattn.flash_attention(q, k, v, causal=causal,
                                        sliding_window=sw)
            ref = kattn.flash_attention_ref(q, k, v, causal=causal,
                                            sliding_window=sw)
        lim = KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
        if dtype == torch.bfloat16:     # P's roundoff, both sides
            lim = lim + FLASH_BF16_P_ROUNDOFF * kattn.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal=causal,
                sliding_window=sw)
        check("flash_attention", got, ref, lim,
              KERNEL_BF16_RTOL if dtype == torch.bfloat16 else 0.0,
              [b, h, lq, lk, d, dt, causal, sw], main)
        del q, k, v, got, ref

    # decode_attention: (N, KV, G, L, D, q dtype, cache, lengths,
    # max_len, main?)
    dcases = [(n, kv, g, l, d, qd, c, lens, None, True)
              for (n, kv, g, l, d, qd, c, lens) in main_shapes.get(
                  "decode_attention", [])]
    for c in ("bfloat16", "float32", "int8"):
        for qd in ("bfloat16", "float32"):
            dcases.append((6, 8, 4, 2048, 64, qd, c,
                           [0, 1, 63, 64, 65, 2048], None, False))
        # the split's edges at L 2048 (4 blocks a row): shares of one and
        # two positions, one short of and one past a 512-position share;
        # then a bound under L (max_len 1000: 2 blocks a row)
        dcases.append((6, 8, 4, 2048, 64, "bfloat16", c,
                       [4, 5, 511, 513, 1000, 2047], None, False))
        dcases.append((4, 8, 4, 2048, 64, "bfloat16", c,
                       [0, 999, 1000, 517], 1000, False))
        dcases.append((3, 2, 3, 100, 24, "float32", c, [0, 37, 100], None,
                       False))
    if device.type == "cuda":   # the llama service's decode shape
        dcases.append((16, 8, 4, 2048, 64, "bfloat16", "bfloat16",
                       np.random.default_rng(seed).integers(
                           1, 2049, 16).tolist(), None, False))
    reruns = 0
    for (n, kvh, g, length, d, qd, cache, lens, max_len, main) in dcases:
        q, k_leaf, v_leaf = _decode_case(gen, device, n, kvh, g, length, d,
                                         getattr(torch, qd), cache)
        lens_t = torch.as_tensor(lens, dtype=torch.int32, device=device)
        scale = 1.0 / math.sqrt(d)
        with fp32_parity(True):
            got = kdec.decode_attention(q, k_leaf, v_leaf, lens_t,
                                        scale=scale, max_len=max_len)
            ref = kdec.decode_attention_ref(
                q, k_leaf, v_leaf, lens_t if max_len is None else
                torch.clamp(lens_t, max=max_len), scale=scale)
        case = [n, kvh, g, length, d, qd, cache,
                lens if len(lens) < 8 else "main", max_len]
        for part, gt, rf in zip("oml", got, ref):
            live = rf[rf > -1e29] if part == "m" else rf
            lim = KERNEL_ATOL * max(
                1.0, float(live.abs().max()) if live.numel() else 0.0)
            check("decode_attention", gt, rf, lim, 0.0, [*case, part], main)
        if device.type == "cuda":   # the fixed merge order: bit-equal
            again = kdec.decode_attention(q, k_leaf, v_leaf, lens_t,
                                          scale=scale, max_len=max_len)
            torch.cuda.synchronize(device)
            reruns += 1
            n_checks += 1
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                failures.append(dict(kernel="decode_attention", case=case,
                                     rerun="not bit-equal"))
        del q, k_leaf, v_leaf
    emit({"phase": "llama_kernel_vs_plain", "checks": n_checks,
          "decode_reruns_bit_equal": reruns,
          "failures": failures[:10], "n_failures": len(failures),
          "atol": f"{KERNEL_ATOL}*max(1,|ref|)",
          "bf16_out_rtol": KERNEL_BF16_RTOL,
          "flash_bf16_extra_atol":
              f"{FLASH_BF16_P_ROUNDOFF}*sum_j p_j|v_j|",
          "max_abs_err_main": worst, "limit_share_main": used})
    if failures:
        raise AssertionError(f"{len(failures)} llama kernel-vs-plain "
                             f"mismatches")
    return worst


FLASH_GATE_LENGTHS = (256, 512, 1024, 1536, 2048)


def flash_gate_sweep(device, rows=12, heads=32, d=64,
                     lengths=FLASH_GATE_LENGTHS, seed=9) -> dict:
    """The causal flash gate on the card: flash_attention against the
    unblocked path it replaces below the gate (ops/attention.
    causal_context with kernels off) at [rows, heads, L, d] bf16 for each
    L (CUDA events, L2 flushed). The crossover is the least L from which
    flash is faster at every longer L measured (kernels/attention.
    flash_profitable's default takes it, not below 256)."""
    import torch
    from simpleinfer_tpu_torch.kernels import attention as kattn
    from simpleinfer_tpu_torch.ops.attention import causal_context

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    scale = 1.0 / math.sqrt(d)
    sweep = []
    for l_ in lengths:
        q, k, v = (torch.randn(rows, heads, l_, d, generator=gen,
                               device=device).bfloat16() for _ in range(3))
        t = {"L": l_,
             "flash_ms": _time_ms(device, lambda: kattn.flash_attention(
                 q, k, v, causal=True, scale=scale), 5, flush),
             "unblocked_ms": _time_ms(device, lambda: causal_context(
                 q, k, v, scale, False), 3, flush)}
        t["speedup"] = t["unblocked_ms"] / t["flash_ms"]
        sweep.append(t)
        del q, k, v
        torch.cuda.empty_cache()
    cross = None
    for t in reversed(sweep):
        if t["speedup"] <= 1.0:
            break
        cross = t["L"]
    res = {"phase": "flash_gate_sweep", "shape": [rows, heads, "L", d],
           "dtype": "bfloat16", "sweep": sweep, "crossover_L": cross,
           "gate_min_lk": int(os.environ.get("SI_FLASH_MIN_LK", "0"))
           or kattn.FLASH_MIN_LK}
    emit(res)
    return res


def llama_engine(device, compute="bfloat16", quant="int4w", use_kernels=None,
                 **kw):
    """A llama Engine on `device` (seeded random weights); returns
    (engine, seconds to build the graph, seconds to load)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_llama

    t0 = time.perf_counter()
    graph, _, _ = build_llama(**{**LLAMA, **kw})
    t1 = time.perf_counter()
    eng = Engine(EngineConfig(compute_dtype=compute, quant=quant,
                              int4_group=128, device=str(device),
                              use_kernels=use_kernels))
    eng.load_model(None, graph=graph)
    return eng, t1 - t0, time.perf_counter() - t1


def llama_recorder() -> Recorder:
    """A Recorder of the three llama kernels' shape keys; the decode
    calls' lengths tensors go to its `decode_lengths` (device tensors:
    recording adds no synchronisation)."""
    from simpleinfer_tpu_torch.kernels import attention as kattn
    from simpleinfer_tpu_torch.kernels import decode_attn as kdec
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    lengths_seen: list = []

    def int4w(x, wq4, bias=None, activation=None, *, out_dtype=None):
        return (int(x.shape[0]), int(wq4.k), int(wq4.packed.shape[1]),
                str(x.dtype)[6:], str(out_dtype or x.dtype)[6:],
                bias is not None, activation)

    def flash(q, k, v, **kw):
        return (*map(int, q.shape), str(q.dtype)[6:])

    def decode(q, k_leaf, v_leaf, lengths, **kw):
        k = k_leaf[0] if isinstance(k_leaf, tuple) else k_leaf
        lengths_seen.append(lengths)
        return (*map(int, q.shape[:3]), int(k.shape[2]), int(q.shape[3]),
                str(q.dtype)[6:], str(k.dtype)[6:])

    rec = Recorder({"matmul_int4w": kmm, "flash_attention": kattn,
                    "decode_attention": kdec},
                   keep={"matmul_int4w": int4w, "flash_attention": flash,
                         "decode_attention": decode})
    rec.decode_lengths = lengths_seen
    return rec


def llama_prompts(n, lo, hi, vocab, seed=0) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(p)) for p in lens]


def service_run(engine, device, n_requests=N_REQUESTS,
                prompt_range=PROMPT_RANGE, max_new=MAX_NEW, seed=0,
                **service_kw) -> dict:
    """The main path: `n_requests` greedy requests (seeded prompt lengths
    uniform in `prompt_range`, max_new each, no eos) submitted at once to
    a GenerationService over `engine`, consumed as streams. Every kernel
    count is set to 0 just before and read just after; a Recorder notes
    the shapes. Returns the metrics, the counts and the recorder."""
    import threading

    import torch
    from simpleinfer_tpu_torch.kernels import attention as kattn
    from simpleinfer_tpu_torch.kernels import decode_attn as kdec
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.serving import GenerationService

    vocab = engine.program.weights[engine.program.plan[0][0].name][
        "weight"].shape[0]
    prompts = llama_prompts(n_requests, *prompt_range, vocab, seed)
    svc = GenerationService(engine, **{**SERVICE, **service_kw})
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0
    first = [None] * n_requests
    last = [None] * n_requests
    counts = [0] * n_requests
    results = [None] * n_requests
    errors = []

    def consume(i, handle, t_submit):
        try:
            for _tok in handle:
                now = time.perf_counter()
                if first[i] is None:
                    first[i] = now - t_submit
                last[i] = now
                counts[i] += 1
            results[i] = handle.result()
        except BaseException as e:      # surfaced below
            errors.append(repr(e))

    # admission time: each wave's prefill, synchronised (the service
    # fetches the wave's first tokens right after it anyway)
    prefill_s = []
    install = svc._dec.prefill_install

    def timed_install(*a, **kw):
        t = time.perf_counter()
        out = install(*a, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prefill_s.append(time.perf_counter() - t)
        return out

    svc._dec.prefill_install = timed_install
    kmm.launches = kmm.launches_int4w = 0
    kattn.launches = kdec.launches = 0
    with llama_recorder() as rec:
        svc.start()
        t_start = time.perf_counter()
        threads = []
        for i, p in enumerate(prompts):
            t_sub = time.perf_counter()
            h = svc.submit_stream(p, max_new=max_new)
            th = threading.Thread(target=consume, args=(i, h, t_sub))
            th.start()
            threads.append((th, t_sub))
        for th, _ in threads:
            th.join(timeout=1200)
        svc.stop()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_start
    launches = {"matmul_int8w": kmm.launches,
                "matmul_int4w": kmm.launches_int4w,
                "flash_attention": kattn.launches,
                "decode_attention": kdec.launches}
    if errors or any(r is None for r in results):
        raise AssertionError(f"service run failed: {errors[:3]}")
    for p, r, c in zip(prompts, results, counts):
        if len(r) != len(p) + max_new or c != max_new or \
                not np.array_equal(r[:len(p)], p) or \
                r.min() < 0 or r.max() >= vocab:
            raise AssertionError("a request's output has the wrong "
                                 "length, prompt or token range")
    # decode rate: the tokens after each request's first, over the run's
    # time outside admission prefills
    decode_tokens = sum(c - 1 for c in counts)
    long_prompts = sum(len(p) > 1024 for p in prompts)
    res = {"phase": "llama_service", "requests": n_requests,
           "prompt_lengths": [int(min(map(len, prompts))),
                              int(max(map(len, prompts)))],
           "prompts_over_1024": long_prompts, "max_new": max_new,
           "warmup_s": warm_s, "wall_s": wall,
           "ttft": _ms_stats([f * 1e3 for f in first]),
           "decode_tok_s": decode_tokens / (wall - sum(prefill_s)),
           "output_tok_s": sum(counts) / wall,
           "prefill_waves": len(prefill_s), "prefill_s": sum(prefill_s),
           "prefills": svc.stats.prefills, "decode_steps": svc.stats.steps,
           "mean_occupancy": svc.stats.mean_occupancy,
           "launches": launches,
           "shapes": {k: [[*key, c] for key, c in sorted(
               rec.count(k).items(), key=lambda kv: str(kv[0]))]
               for k in rec.calls}}
    emit(res)
    if device.type == "cuda":
        missing = [k for k in ("matmul_int4w", "flash_attention",
                               "decode_attention") if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
    return {"res": res, "recorder": rec, "prompts": prompts}


def decode_step_profile(engine, device, lengths, k_steps=1, blocks=8,
                        seed=0) -> dict:
    """Steady-state decode of a full pool (the service's decoder settings,
    its decode horizon, each row at the recorded median lengths): host
    wall time per step over `blocks` chained blocks, and torch.profiler's
    device kernel time per step, so the card's busy share shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    dec = CachedDecoder(engine, kv_dtype=SERVICE["kv_dtype"],
                        scratch_blocks=True, decode_attn="kernel")
    n = SERVICE["slots"]
    caches = dec.init_cache(n)
    pos = np.minimum(np.asarray(lengths), dec._window - k_steps - 1)
    zeros, ones = np.zeros(n, np.float32), np.ones(n, np.float32)
    topk = np.zeros(n, np.int64)
    tok = np.ones(n, np.int64)

    def run(nb):
        last = tok
        for _ in range(nb):
            _, last, _c = dec.decode_block(last, pos, caches, seed, 1, zeros,
                                           topk, ones, k_steps)
        torch.cuda.synchronize(device)

    run(2)
    t0 = time.perf_counter()
    run(blocks)
    wall_ms = (time.perf_counter() - t0) * 1e3 / (blocks * k_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(2)
    kernels = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3 / (2 * k_steps), e.count / (2 * k_steps),
                        e.key[:80]))
    kernels.sort(reverse=True)
    busy = sum(k_[0] for k_ in kernels)
    res = {"phase": "llama_decode_step", "slots": n, "k_steps": k_steps,
           "mean_length": float(np.mean(pos)), "wall_ms_per_step": wall_ms,
           "device_ms_per_step": busy, "busy_share": busy / wall_ms,
           "decode_tok_s": n * 1e3 / wall_ms,
           "top_kernels": [[round(ms, 4), cnt, name]
                           for ms, cnt, name in kernels[:10]]}
    emit(res)
    return res


DECODE_SWEEP_SLOTS = (1, 2, 4, 8, 16)


def decode_slots_sweep(engine, device, lengths, slots=DECODE_SWEEP_SLOTS,
                       seed=13) -> dict:
    """The KERNEL_MIN_SLOTS gate on the card: a decode step's attention
    over the frozen cache and one scratch slot
    (CachedDecoder._attend_frozen_scratch) with the decode kernel against
    the port's torch route (f32 matmuls over the whole window), at each
    pool size; the rows at the recorded lengths (cycled), seeded bf16
    cache contents; device time per step, one call per layer (CUDA
    events, the L2 flushed, a spin long enough to cover the host's
    enqueue of the route's ~20 calls). The crossover is the least pool
    size from which the kernel is faster at every larger size measured
    (serving/llm.GenerationService.KERNEL_MIN_SLOTS takes it)."""
    import torch
    from simpleinfer_tpu_torch.serving import GenerationService
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    dec = CachedDecoder(engine, kv_dtype=SERVICE["kv_dtype"],
                        scratch_blocks=True, decode_attn="kernel")
    _name, info = dec._mha_ops[0]
    heads, kvh, d = dec._geometry(info)
    layers = len(dec._mha_ops)
    scale = dec._scale(info, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    lengths = np.asarray(lengths)
    sweep = []
    for n in slots:
        k, v = (torch.randn(n, kvh, dec._window, d, generator=gen,
                            device=device).to(dec._kv_store)
                for _ in range(2))
        scr = tuple(torch.randn(n, kvh, 1, d, generator=gen, device=device)
                    .to(dec._kv_store) for _ in range(2))
        qh = torch.randn(n, heads, 1, d, generator=gen,
                         device=device).bfloat16()
        pos0 = torch.as_tensor(lengths[np.arange(n) % len(lengths)],
                               dtype=torch.long, device=device)

        def route(kernel):
            return lambda: dec._attend_frozen_scratch(
                qh, (k, v), scr, 0, pos0, heads // kvh, scale,
                torch.bfloat16, kernel)
        with torch.inference_mode():    # ~20 torch calls a route
            t = {"slots": n,
                 "kernel_ms": layers * _time_ms(device, route(True), 10,
                                                flush, 20 * SPIN_CYCLES),
                 "torch_ms": layers * _time_ms(device, route(False), 10,
                                               flush, 20 * SPIN_CYCLES)}
        t["speedup"] = t["torch_ms"] / t["kernel_ms"]
        sweep.append(t)
        del k, v, scr, qh
    cross = None
    for t in reversed(sweep):
        if t["speedup"] <= 1.0:
            break
        cross = t["slots"]
    res = {"phase": "decode_slots_sweep", "unit": "one decode step",
           "layers": layers, "window": dec._window,
           "mean_length": float(lengths.mean()), "sweep": sweep,
           "crossover_slots": cross,
           "gate_min_slots": GenerationService.KERNEL_MIN_SLOTS}
    emit(res)
    return res


def main_shapes_of(rec) -> dict:
    """The recorded shapes in llama_kernel_checks' case format; decode at
    the recorded lengths of the median-length call."""
    import torch

    shapes = {"matmul_int4w": [
        (m, k, n, xd, od, b, act) for (m, k, n, xd, od, b, act)
        in rec.count("matmul_int4w")],
        "flash_attention": [(b, h, l, d, dt) for (b, h, l, d, dt)
                            in rec.count("flash_attention")]}
    lens = median_lengths(rec)
    shapes["decode_attention"] = [
        (n, kv, g, l, d, qd, cd, lens.tolist())
        for (n, kv, g, l, d, qd, cd) in rec.count("decode_attention")]
    return shapes


def median_lengths(rec):
    """The lengths of the recorded decode call with the median mean
    length (host numpy)."""
    lens = [t.cpu().numpy() for t in rec.decode_lengths]
    order = sorted(range(len(lens)), key=lambda i: float(lens[i].mean()))
    return lens[order[len(order) // 2]]


def time_llama_kernels(device, rec, layers, slots=SERVICE["slots"],
                       seed=5) -> dict:
    """Each kernel's time at the main path's shapes beside its plain
    version's, a library call's and the bound (CUDA events, the L2
    flushed before each launch):
    - matmul_int4w: one decode step, i.e. the M = slots launches of a
      step (113 at llama-base), summed; library = torch.matmul on the
      weight dequantized to bf16;
    - flash_attention: one admission wave of the recorded shape with the
      most work (one launch per layer); library =
      F.scaled_dot_product_attention(is_causal=True);
    - decode_attention: one decode step (one launch per layer) at the
      recorded lengths of the median-length call; library = SDPA over
      the cache with a length mask."""
    import torch
    import torch.nn.functional as F
    from simpleinfer_tpu_torch.kernels import attention as kattn
    from simpleinfer_tpu_torch.kernels import decode_attn as kdec
    from simpleinfer_tpu_torch.kernels import matmul as kmm

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    out = {}
    peak = PEAK_FLOPS["bfloat16"]

    def int4w_sum(keys_per_unit, iters):
        """matmul_int4w at each recorded (shape, dtypes) key, weighted by
        its launches per unit (a decode step or a prefill wave)."""
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, launches=0)
        rows = []
        for key, per in sorted(keys_per_unit.items(), key=str):
            m, k, n, xd, od, has_b, act = key
            x, q, bias = _int4_case(gen, device, m, k, n, getattr(torch, xd))
            b = bias.to(x.dtype) if has_b else None
            od_t = getattr(torch, od)
            w_deq = q.dequantize(torch.bfloat16)
            xb = x.to(torch.bfloat16)
            nbytes = (x.numel() * x.element_size() + q.packed.numel()
                      + q.scale.numel() * 4 + m * n * od_t.itemsize
                      + (n * b.element_size() if b is not None else 0))
            t_b = nbytes / HBM_BYTES_PER_S * 1e3
            t_o = 2.0 * m * n * k / peak * 1e3
            t = {"ms": _time_ms(device, lambda: kmm.matmul_int4w(
                     x, q, b, act, out_dtype=od_t), iters, flush),
                 "plain_ms": _time_ms(device, lambda: kmm.matmul_int4w_ref(
                     x, q, b, act, out_dtype=od_t), iters, flush),
                 "library_ms": _time_ms(device, lambda: torch.matmul(
                     xb, w_deq), iters, flush),
                 "bound_ms": max(t_b, t_o)}
            rows.append({"shape": [m, k, n], "out": od, "per_unit": per,
                         **t})
            for kk, v in t.items():
                tot[kk] += per * v
            tot["bytes_ms"] += per * t_b
            tot["ops_ms"] += per * t_o
            tot["launches"] += per
            del x, q, bias, w_deq, xb
        tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] \
            else "operations"
        return tot, rows

    # matmul_int4w per decode step: decode steps = decode launches /
    # layers; a prefill's gathered last rows add a few M = slots calls of
    # the last layer's MLP and the head
    c4 = rec.count("matmul_int4w")
    steps = sum(rec.count("decode_attention").values()) / layers
    tot, rows = int4w_sum({k: round(c / steps) for k, c in c4.items()
                           if k[0] == slots}, 10)
    tot["launches_per_step"] = tot.pop("launches")
    out["matmul_int4w"] = tot
    emit({"phase": "kernel_time_int4w", "unit": "one decode step",
          **tot, "shapes": rows})

    # flash_attention per admission wave at the recorded shape
    fkey = max(rec.count("flash_attention"),
               key=lambda k_: k_[0] * k_[2] ** 2)
    # matmul_int4w over the full-width projections of that wave (its
    # rows x width; waves at that M = its flash launches / layers)
    wave_m = fkey[0] * fkey[2]
    waves = rec.count("flash_attention")[fkey] / layers
    ptot, prows = int4w_sum({k: round(c / waves) for k, c in c4.items()
                             if k[0] == wave_m}, 3)
    ptot["launches_per_wave"] = ptot.pop("launches")
    out["matmul_int4w_prefill"] = ptot
    for r in prows:     # one line per projection shape of the wave
        m, k, n = r["shape"]
        emit({"phase": "kernel_time_int4w_prefill_shape", **r,
              "tflops": 2.0 * m * k * n / (r["ms"] * 1e9),
              "library_tflops": 2.0 * m * k * n / (r["library_ms"] * 1e9)})
    emit({"phase": "kernel_time_int4w_prefill",
          "unit": "one admission wave's full-width projections",
          "rows": fkey[0], "width": fkey[2], **ptot, "shapes": prows})
    b_, h_, l_, d_, dt = fkey
    q, k, v = (torch.randn(b_, h_, l_, d_, generator=gen, device=device)
               .to(getattr(torch, dt)) for _ in range(3))
    pairs = l_ * (l_ + 1) // 2
    t_b = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S * 1e3
    t_o = 4.0 * b_ * h_ * d_ * pairs / peak * 1e3
    one = {"ms": _time_ms(device, lambda: kattn.flash_attention(
               q, k, v, causal=True), iters=3, flush=flush),
           "plain_ms": _time_ms(device, lambda: kattn.flash_attention_ref(
               q, k, v, causal=True), iters=3, flush=flush),
           "library_ms": _time_ms(device, lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True), iters=3, flush=flush),
           "bound_ms": max(t_b, t_o)}
    del q, k, v
    per_wave = layers
    out["flash_attention"] = dict(
        {kk: v * per_wave for kk, v in one.items()},
        bound_by="bytes" if t_b >= t_o else "operations",
        launches_per_wave=per_wave, shape=list(fkey))
    emit({"phase": "kernel_time_flash", "unit": "one admission wave",
          **out["flash_attention"], "per_launch": one,
          "per_row_ms": out["flash_attention"]["ms"] / b_})

    # decode_attention per decode step at the median recorded lengths
    dkey = next(iter(rec.count("decode_attention")))
    n, kvh, g, length, d, qd, cd = dkey
    lens = torch.as_tensor(median_lengths(rec), dtype=torch.int32,
                           device=device)
    cache = "int8" if cd == "int8" else cd
    q, k_leaf, v_leaf = _decode_case(gen, device, n, kvh, g, length, d,
                                     getattr(torch, qd), cache)
    kk_ = k_leaf[0] if isinstance(k_leaf, tuple) else k_leaf
    vv_ = v_leaf[0] if isinstance(v_leaf, tuple) else v_leaf
    live = int(torch.clamp(lens, 0, length).sum())
    nbytes = (2 * live * kvh * d * kk_.element_size()
              + (2 * live * kvh * 4 if isinstance(k_leaf, tuple) else 0)
              + q.numel() * q.element_size() + n * kvh * g * (d + 2) * 4)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 4.0 * live * kvh * g * d / peak * 1e3
    mask = (torch.arange(length, device=device)[None, :]
            < lens[:, None].long())[:, None, None, :]
    kd = kk_.to(q.dtype) if not isinstance(k_leaf, tuple) else None
    vd = vv_.to(q.dtype) if not isinstance(v_leaf, tuple) else None
    scale = 1.0 / math.sqrt(d)
    one = {"ms": _time_ms(device, lambda: kdec.decode_attention(
               q, k_leaf, v_leaf, lens, scale=scale), flush=flush),
           "plain_ms": _time_ms(device, lambda: kdec.decode_attention_ref(
               q, k_leaf, v_leaf, lens, scale=scale), flush=flush),
           "library_ms": (_time_ms(device, lambda:
                          F.scaled_dot_product_attention(
                              q, kd, vd, attn_mask=mask, scale=scale),
                          flush=flush) if kd is not None else None),
           "bound_ms": max(t_b, t_o)}
    per_step = layers
    out["decode_attention"] = dict(
        {kk: (v * per_step if v is not None else None)
         for kk, v in one.items()},
        bound_by="bytes" if t_b >= t_o else "operations",
        launches_per_step=per_step, shape=list(dkey),
        mean_length=float(lens.float().mean()))
    emit({"phase": "kernel_time_decode", "unit": "one decode step",
          **out["decode_attention"], "per_launch": one})
    return out


def onoff(engine, engine_off, device, reference, seed=7,
          prompt_lens=(2000, 1900)) -> dict:
    """Kernels on vs off: `engine` (kernels on) against `engine_off`, an
    engine of the same graph with use_kernels=False (the ops' torch
    paths): the prefill's last logits at the full window (int4 kernel +
    flash at width 2048 vs dense bf16 matmuls + unblocked attention),
    then one scratch decode-block step's logits over each side's cache
    (int4 kernel + decode kernel vs the torch paths). `reference` is an
    fp32 engine of the same weights (kernels on, TF32 off): each bf16
    side's distance from it is reported too. Returns the readings;
    `check_onoff` holds them to the limits."""
    import torch
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    dec = CachedDecoder(engine, kv_dtype=SERVICE["kv_dtype"],
                        scratch_blocks=True, decode_attn="kernel")
    dec_off = CachedDecoder(engine_off, kv_dtype=SERVICE["kv_dtype"],
                            scratch_blocks=True, decode_attn="torch")
    window = dec._window
    vocab = engine.program.weights[engine.program.plan[0][0].name][
        "weight"].shape[0]
    rng = np.random.default_rng(seed)
    n = len(prompt_lens)
    tokens = np.zeros((n, window), np.float32)
    for i, p in enumerate(prompt_lens):
        tokens[i, :p] = rng.integers(0, vocab, p)
    lengths = np.asarray(prompt_lens)

    def block_step(dec, caches, kernel_attn):
        # step 0 of a scratch decode block, with its logits: the
        # decoder's own block step (zoo/generate.py), called directly
        scr = {name: tuple(torch.zeros(
            (n, info["num_kv_heads"], 1, info["head_dim"]),
            dtype=dec._kv_store, device=device) for _ in range(2))
            for name, info in dec._mha_ops}
        pos = torch.as_tensor(lengths, device=device)
        tok = torch.as_tensor(tokens[np.arange(n), lengths - 1],
                              device=device)
        with torch.inference_mode():
            return dec._step_fn_scratch(tok[:, None], pos, caches, scr, 0,
                                        pos, kernel_attn)[:, 0, :]

    def compare(got, want):
        got, want = got.float(), want.float()
        scale = max(1.0, float(want.abs().max()))
        d = (got - want).abs()
        return {"max_abs_over_scale": float(d.max()) / scale,
                "mean_abs_over_scale": float(d.mean()) / scale,
                "scale": scale, "argmax_equal": int(
                    (got.argmax(-1) == want.argmax(-1)).sum())}

    on, caches = dec.prefill(tokens, lengths)
    step_on = block_step(dec, caches, True)
    del caches
    off, caches = dec_off.prefill(tokens, lengths)
    step_off = block_step(dec_off, caches, False)
    del caches
    rdec = CachedDecoder(reference, scratch_blocks=True,
                         decode_attn="kernel")
    with fp32_parity(True):
        truth, rcaches = rdec.prefill(tokens, lengths)
        step_truth = block_step(rdec, rcaches, True)
    res = {"phase": "llama_kernels_on_vs_off", "rows": n,
           "prompt_lens": list(prompt_lens), "width": window,
           "prefill_logits": compare(on, off),
           "decode_step_logits": compare(step_on, step_off),
           "vs_fp32": {
               "prefill_logits": {"on": compare(on, truth),
                                  "off": compare(off, truth)},
               "decode_step_logits": {"on": compare(step_on, step_truth),
                                      "off": compare(step_off, step_truth)}},
           "tol": [ONOFF_MAX_TOL, ONOFF_MEAN_TOL],
           "tol_vs_fp32": f"on <= {ONOFF_VS_FP32} x off"}
    emit(res)
    return res


def check_onoff(res) -> None:
    """Fails past the on-vs-off limits, or when the kernels' side is more
    than ONOFF_VS_FP32 times farther from fp32 than the torch side."""
    for part in ("prefill_logits", "decode_step_logits"):
        r, v = res[part], res["vs_fp32"][part]
        if (r["max_abs_over_scale"] > ONOFF_MAX_TOL
                or r["mean_abs_over_scale"] > ONOFF_MEAN_TOL):
            raise AssertionError(f"llama kernels on vs off, {part}: {r}")
        for key in ("max_abs_over_scale", "mean_abs_over_scale"):
            if v["on"][key] > ONOFF_VS_FP32 * v["off"][key]:
                raise AssertionError(f"llama kernels on are farther from "
                                     f"fp32 than off, {part}: {v}")


def llama_ref64(graph, ids, group: int = 128) -> np.ndarray:
    """Logits of a build_llama graph under int4w, in float64 numpy: the
    plain reference of the fp32 phase. Every projection weight takes the
    int4 round trip (quantize_int4_grouped, then its f32 dequantized
    values: the format's own numbers); everything else is written out
    here (RMSNorm, HF RoPE, GQA causal softmax attention, SwiGLU) and
    shares no compute with the port, nor any torch CPU library."""
    from simpleinfer_tpu_torch.quant.tensor import quantize_int4_grouped

    def w4(w):                        # [out, in] -> dequantized [in, out]
        q = quantize_int4_grouped(np.ascontiguousarray(w.T), group=group)
        return q.dequantize().numpy().astype(np.float64)

    env = {}
    for op in graph.ops:
        p = {k: v.value for k, v in op.params.items()}
        a = {k: v.array() for k, v in op.attrs.items()}
        xs = [env.get(r.name) for r in op.inputs]
        if op.type == "pnnx.Output":
            continue
        if op.type == "pnnx.Input":
            y = np.asarray(ids, np.int64)
        elif op.type == "nn.Embedding":
            y = a["weight"].astype(np.float64)[xs[0]]
        elif op.type == "nn.RMSNorm":
            x = xs[0]
            y = x / np.sqrt((x * x).mean(-1, keepdims=True) + p["eps"])
            y = y * a["weight"] if "weight" in a else y
        elif op.type == "nn.SiLU":
            y = xs[0] / (1.0 + np.exp(-xs[0]))
        elif op.type == "pnnx.Expression":
            y = {"add(@0,@1)": np.add, "mul(@0,@1)": np.multiply}[
                p["expr"]](*xs)
        elif op.type == "nn.Linear":
            y = xs[0] @ w4(a["weight"])
        elif op.type == "si.RotaryAttention":
            extra = set(p) - {"embed_dim", "num_heads", "num_kv_heads",
                              "rope_theta", "bias"}
            if extra or p["bias"]:
                raise ValueError(f"llama_ref64: {sorted(extra)} or bias "
                                 f"not in the reference")
            x = xs[0]
            n, l, e = x.shape
            h, kvh = p["num_heads"], p["num_kv_heads"]
            d = e // h

            def heads(key, nh):
                return (x @ w4(a[f"{key}_proj.weight"])).reshape(
                    n, l, nh, d).transpose(0, 2, 1, 3)

            half = d // 2
            ang = np.arange(l)[:, None] * (
                1.0 / p["rope_theta"] ** (np.arange(half) / half))
            cos = np.cos(np.concatenate([ang, ang], -1))
            sin = np.sin(np.concatenate([ang, ang], -1))

            def rope(t):
                return t * cos + np.concatenate(
                    [-t[..., half:], t[..., :half]], -1) * sin

            q, k = rope(heads("q", h)), rope(heads("k", kvh))
            k = np.repeat(k, h // kvh, axis=1)
            v = np.repeat(heads("v", kvh), h // kvh, axis=1)
            s = q @ k.transpose(0, 1, 3, 2) / math.sqrt(d)
            s = np.where(np.tril(np.ones((l, l), bool)), s, -np.inf)
            pr = np.exp(s - s.max(-1, keepdims=True))
            ctx = (pr / pr.sum(-1, keepdims=True)) @ v
            y = ctx.transpose(0, 2, 1, 3).reshape(n, l, h * d) @ w4(
                a["o_proj.weight"])
        else:
            raise ValueError(f"llama_ref64: no reference for {op.type}")
        env[op.outputs[0].name] = y
    (out,) = [r.name for op in graph.ops if op.type == "pnnx.Output"
              for r in op.inputs]
    return env[out]


def llama_fp32_card_vs_cpu(device, depth=2, seq_len=256, steps=16,
                           seed=0, **kw) -> dict:
    """fp32 int4w llama (full width, `depth` layers, window `seq_len`) on
    `device` against the plain reference: logits of a full-window
    forward within FP32_TOL * scale of `llama_ref64` (float64, TF32
    off), the same forward bit-equal when run twice, and greedy tokens
    of a scratch-block decode with the decode kernel equal to the
    port's on the CPU (plain versions). The port's fp32 CPU logits are
    reported beside the card's, each as its distance from the float64
    reference: an fp32 CPU forward is a host's own rounding, which
    differs from host to host, so it is no yardstick for the card. The
    flash gate is lowered to the window so the forward runs it."""
    import torch
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.engine import fp32_parity
    from simpleinfer_tpu_torch.zoo import build_llama
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    kw = {**LLAMA, "depth": depth, "seq_len": seq_len, **kw}
    engines = []
    for dev, uk in ((device, None), (torch.device("cpu"), True)):
        e = Engine(EngineConfig(compute_dtype="float32", quant="int4w",
                                device=str(dev), use_kernels=uk))
        engines.append(e.load_model(None, graph=build_llama(**kw)[0]))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, kw["vocab_size"], (1, seq_len)).astype(np.float32)
    prompt = ids[:, :seq_len // 2].astype(np.int64)
    prev = os.environ.get("SI_FLASH_MIN_LK")
    os.environ["SI_FLASH_MIN_LK"] = str(seq_len)
    try:
        outs, toks = [], []
        for e in engines:
            with fp32_parity(True):
                outs.append(e.run({e.input_names[0]: ids})[
                    e.output_names[0]])
                toks.append(CachedDecoder(
                    e, scratch_blocks=True, decode_attn="kernel").generate(
                    prompt, steps=steps, block=8))
        with fp32_parity(True):
            again = engines[0].run({engines[0].input_names[0]: ids})[
                engines[0].output_names[0]]
    finally:
        if prev is None:
            os.environ.pop("SI_FLASH_MIN_LK")
        else:
            os.environ["SI_FLASH_MIN_LK"] = prev
    got, cpu = outs
    ref = llama_ref64(build_llama(**kw)[0], ids)
    scale = max(1.0, float(np.abs(ref).max()))
    err = np.abs(got - ref)
    worst = np.unravel_index(int(err.argmax()), err.shape)
    res = {"phase": "llama_fp32_card_vs_cpu", "shape": list(got.shape),
           "depth": depth, "reference": "llama_ref64 (float64 numpy)",
           "max_abs_err": float(err.max()), "scale": scale,
           "worst_at": [int(i) for i in worst],
           "cpu_max_abs_err": float(np.abs(cpu - ref).max()),
           "card_vs_cpu_max_abs_err": float(np.abs(got - cpu).max()),
           "cpu_scale": float(np.abs(cpu).max()),
           "tol": f"{FP32_TOL}*scale",
           "rerun_bit_equal": bool(np.array_equal(got, again)),
           "tokens_equal": bool(np.array_equal(toks[0], toks[1])),
           "steps": steps}
    emit(res)
    if (res["max_abs_err"] > FP32_TOL * scale
            or not res["rerun_bit_equal"] or not res["tokens_equal"]):
        raise AssertionError(f"llama fp32 card vs CPU: {res}")
    return res


# ---- the detection pipeline (zoo/detect.py) ------------------------------
# 8 seeded uint8 HWC images of mixed sizes and aspect ratios (landscape,
# portrait, square, 16:9)
DETECT_SIZES = ((480, 640), (720, 1280), (640, 640), (1080, 810),
                (375, 500), (768, 1024), (600, 800), (427, 640))
DETECT = dict(batch=8, image=640, seed=0)
DETECT_MAX_DET = 300
DETECT_PRE_TOPK = 1024
DETECT_REPS = 5
# YOLOv8s pointwise convs that reach matmul_int8w per forward (the other
# pointwise convs are cat-split sums or below the int8 gate; the count is
# fixed by tests/test_torch_yolov8.py)
YOLOV8S_POINTWISE = 11
# device vs host decode of the same head output: the same rows, classes
# equal, boxes within DECODE_BOX_RTOL * max(1, |box|) and scores within
# DECODE_SCORE_RTOL * max(1, |score|) (both sides compute the same f32
# products; only the order of a reduction may differ)
DECODE_BOX_RTOL = 1e-4
DECODE_SCORE_RTOL = 1e-6
# kept-row floors of those comparisons, over all images of a check: the
# random-weight heads put every score in a narrow band (YOLOv5s ~0.27-0.29,
# YOLOv8s ~0.54), so the comparison's threshold keeps DETECT_PRE_TOPK
# candidates an image and NMS keeps 300 (v5) or ~60 (v8) of them (CPU
# runs at 320 px); the planted head keeps ~110 rows an image
DECODE_FLOOR = {"v5": 1200, "v8": 200, "planted": 150}
# kernels on vs off (bf16): YOLOv8s, each part of a detection row over
# its own scale (INT8_ONOFF_PARTS: the box in pixels, the 80 class
# scores in [0, 1]), and UNet-128's logits. Limits (max, mean) x scale
# between the sound reading and the fault stand-ins'
# (scripts/torch_onoff_control.py --detect). On an H100: YOLOv8s sound
# box 8.1e-5 / 5.7e-6, scores 6.1e-4 / 6.3e-5 (matmul_int8w as its plain
# version reads the same); a K tile lost in every matmul_int8w call box
# 2.0e-3 / 4.7e-4, scores 0.036 / 7.5e-3; lost in the three cls-branch
# 1x1s only: box as sound, scores 0.033 / 7.3e-3. Every limit is >= 6x
# sound, and each fault reads >= 4x every limit of the part it touches
# (the whole-row scale of 636 px would hide the second). UNet sound 4.4e-3
# (one bf16 ulp of the scale) / 3.1e-4; a lost K tile (K 32 -> 1) 1.0 /
# 0.14; limits 4.5x and 10x sound
V8_ONOFF_TOL = {"box": (5e-4, 5e-5), "scores": (5e-3, 6e-4)}
UNET_ONOFF_TOL = {"logits": (0.02, 3e-3)}
# Engine.warmup's batch sizes on YOLOv5s-640
WARMUP_BATCHES = (1, 2, 4, 8, 16, 32)
SEGMENT = dict(batch=8, image_size=128, seed=0)
# letterbox: the native route against the numpy one (the JAX package's
# two routes differ the same way: f32 sampling weights in C++, f64 in
# numpy; tests/test_host.py holds them to 2e-2): unnormalized within
# LETTERBOX_RAW_TOL, normalized within LETTERBOX_NORM_TOL
LETTERBOX_RAW_TOL = 1e-4
LETTERBOX_NORM_TOL = 1e-6


def seeded_images(seed=DETECT["seed"], sizes=DETECT_SIZES) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in sizes]


def detect_engine(device, head, compute, use_kernels, batch, image,
                  seed=0):
    """A YOLOv5s (head "v5") or YOLOv8s ("v8") int8w Engine on `device`;
    returns (engine, input name, output name, fused graph)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_yolov5, build_yolov8

    build = build_yolov8 if head == "v8" else build_yolov5
    graph, in_name, out_name = build("s", batch=batch, image_size=image,
                                     seed=seed)
    eng = Engine(EngineConfig(compute_dtype=compute, quant="int8w",
                              device=str(device), use_kernels=use_kernels))
    eng.load_model(None, graph=graph)
    return eng, in_name, out_name, graph


def max_class_scores(head_np, head) -> np.ndarray:
    if head == "v8":
        return head_np[..., 4:].max(-1)
    return (head_np[..., 5:] * head_np[..., 4:5]).max(-1)


def conf_for_topk(head_np, head, k=DETECT_PRE_TOPK) -> float:
    """The least f32 threshold that leaves at most k candidate rows in
    every image: the device decode's pre_topk cut then drops no row the
    host decode would see."""
    sc = max_class_scores(head_np, head).astype(np.float32)
    if sc.shape[1] <= k:
        return 0.0
    kth = np.float32(np.sort(sc, axis=1)[:, -(k + 1)].max())
    return float(np.nextafter(kth, np.float32(np.inf)))


def decode_vs_host(rows, head_np, head, conf, iou=0.45) -> dict:
    """Device-decoded rows [N, max_det, 6] against decode_predictions of
    the same head output, image by image."""
    from simpleinfer_tpu_torch.zoo.detect import decode_predictions

    kept = host_rows = differing = 0
    box_err = score_err = 0.0
    for i in range(head_np.shape[0]):
        want = decode_predictions(head_np[i], conf_thresh=conf,
                                  iou_thresh=iou, head=head)
        got = rows[i][rows[i][:, 4] >= 0]
        kept, host_rows = kept + len(got), host_rows + len(want)
        differing += abs(len(got) - len(want))
        for g, d in zip(got, want):
            box = np.asarray(d.box, np.float64)
            e = np.abs(g[:4] - box)
            box_err = max(box_err, float(e.max()))
            score_err = max(score_err, abs(float(g[4]) - d.score))
            if (int(g[5]) != d.class_id
                    or (e > DECODE_BOX_RTOL * np.maximum(1.0, np.abs(box))
                        ).any()
                    or abs(float(g[4]) - d.score)
                    > DECODE_SCORE_RTOL * max(1.0, abs(d.score))):
                differing += 1
    return {"kept_rows": kept, "host_rows": host_rows,
            "rows_differing": differing, "max_box_err": box_err,
            "max_score_err": score_err, "equal": differing == 0}


def check_decode(res, floor, what) -> None:
    if not res["equal"] or res["kept_rows"] < floor:
        raise AssertionError(f"{what}: device vs host decode {res} (floor "
                             f"{floor} kept rows)")


def planted_head(n=2, m=4000, nc=80, clusters=48, per=12, seed=5,
                 head="v5"):
    """A synthetic YOLOv5 head [n, m, 5+nc]: background rows under the
    0.25 threshold, and `clusters` clusters an image of `per` boxes that
    partly overlap (suppression chains), with exact score ties inside and
    across clusters (three objectness levels) and tied class maxima (the
    first index wins on both sides). head="v8": the same rows without
    the objectness column, its factor folded into the class scores."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((n, m, 5 + nc), np.float32)
    pred[..., :2] = rng.uniform(16, 624, (n, m, 2))
    pred[..., 2:4] = rng.uniform(8, 80, (n, m, 2))
    pred[..., 4] = rng.uniform(0, 0.2, (n, m))
    pred[..., 5:] = rng.dirichlet(np.ones(nc), (n, m))
    for i in range(n):
        rows = rng.permutation(m)[:clusters * per]
        for c in range(clusters):
            cx, cy = rng.uniform(60, 580, 2)
            w = rng.uniform(30, 90)
            cls = int(rng.integers(nc))
            for j in range(per):
                r = rows[c * per + j]
                pred[i, r, :2] = (cx + rng.uniform(-w / 4, w / 4),
                                  cy + rng.uniform(-w / 4, w / 4))
                pred[i, r, 2:4] = (w, w * rng.uniform(0.8, 1.2))
                pred[i, r, 4] = (0.9, 0.8, 0.7)[j % 3]
                pred[i, r, 5:] = 0.0
                pred[i, r, 5 + cls] = 1.0
                if j % 4 == 0:          # a tied class maximum
                    pred[i, r, 5 + (cls + 1) % nc] = 1.0
    if head == "v8":
        pred = np.concatenate([pred[..., :4],
                               pred[..., 5:] * pred[..., 4:5]], -1)
    return pred


def planted_checks(device) -> list:
    """decode_device on the planted head, f32 and bf16, on `device`
    against the host decode of the same values."""
    import torch
    from simpleinfer_tpu_torch.zoo.detect import decode_device

    out = []
    pred = planted_head()
    for dtype in (torch.float32, torch.bfloat16):
        head = torch.from_numpy(pred).to(device).to(dtype)
        rows = decode_device(head, 0.25, 0.45, DETECT_MAX_DET, "v5",
                             pre_topk=DETECT_PRE_TOPK).cpu().numpy()
        res = decode_vs_host(rows, head.float().cpu().numpy(), "v5", 0.25)
        res.update(phase="detect_planted", shape=list(pred.shape),
                   dtype=str(dtype).split(".")[-1])
        emit(res)
        check_decode(res, DECODE_FLOOR["planted"], f"planted {dtype}")
        out.append(res)
    return out


def decode_launches(device, raw, head, conf) -> dict:
    """Kernels the device decode launches on one head output (profiler),
    and its NMS rounds, at pre_topk 512 and 1024: the rounds follow the
    data's suppression chains, not K."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from simpleinfer_tpu_torch.zoo import detect

    res = {}
    orig = detect.nms_rounds
    rounds = []

    def counted(*a, **kw):
        out = orig(*a, **kw)
        rounds.append(out[2])
        return out

    detect.nms_rounds = counted
    try:
        for k in (512, DETECT_PRE_TOPK):
            detect.decode_device(raw, conf, 0.45, DETECT_MAX_DET, head,
                                 pre_topk=k)
            launches = None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    detect.decode_device(raw, conf, 0.45, DETECT_MAX_DET,
                                         head, pre_topk=k)
                    torch.cuda.synchronize(device)
                launches = sum(
                    e.count for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
            res[f"pre_topk_{k}"] = {"kernel_launches": launches,
                                    "nms_rounds": rounds[-1]}
    finally:
        detect.nms_rounds = orig
    return res


# detect_images' steps, as detect_breakdown times them: the hooked name
# (a function of zoo/detect.py, or an Engine method) -> its step
DETECT_STEPS = {"letterbox_images": "letterbox_host",
                "stage_for_engine": "letterbox_host", "input": "staging",
                "forward": "forward", "decode_device": "decode_device",
                "extract": "extract", "decode_predictions": "decode_host",
                "detections_from_decoded": "unmap"}


def detect_breakdown(engine, images, head, size, device_decode, stage_uint8,
                     reps) -> dict:
    """detect_images itself, its steps timed by hooks: each function of
    zoo/detect.py and Engine method it calls (DETECT_STEPS) runs to its
    end on the device before its time is taken. Letterbox (host) and
    staging (Engine.input), forward, then decode on the device, or the
    head's fetch (extract) and decode on the host; `rest` is the
    remainder of the call (the rows' fetch on the device route). Medians
    over `reps` batches, ms a batch; then detect_images without hooks
    end to end (img/s)."""
    from simpleinfer_tpu_torch.zoo import detect

    steps: dict = {}
    seen: dict = {}
    orig = {k: getattr(detect, k) for k in DETECT_STEPS
            if hasattr(detect, k)}

    def hooked(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            engine.synchronize()
            step = DETECT_STEPS[name]
            steps[step] = steps.get(step, 0.0) + time.perf_counter() - t
            if name == "input":
                seen["staged"] = a[1].nbytes
            if name == "extract":
                seen["fetched"] = out.nbytes if kw.get("as_numpy", True) \
                    else 0
            if name == "decode_device":
                seen["fetched"] = out.nelement() * out.element_size()
            return out
        return run

    per: dict = {}
    for k, fn in orig.items():
        setattr(detect, k, hooked(k, fn))
    for k in ("input", "forward", "extract"):
        setattr(engine, k, hooked(k, getattr(engine, k)))
    try:
        for _ in range(reps):
            steps.clear()
            t = time.perf_counter()
            dets = detect.detect_images(engine, images, size=size,
                                        device_decode=device_decode,
                                        stage_uint8=stage_uint8,
                                        head=head)
            total = time.perf_counter() - t
            steps["rest"] = total - sum(steps.values())
            for k, v in steps.items():
                per.setdefault(k, []).append(v * 1e3)
    finally:
        for k, fn in orig.items():
            setattr(detect, k, fn)
        for k in ("input", "forward", "extract"):
            delattr(engine, k)
    detect.detect_images(engine, images, size=size,
                         device_decode=device_decode,
                         stage_uint8=stage_uint8, head=head)
    engine.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        detect.detect_images(engine, images, size=size,
                             device_decode=device_decode,
                             stage_uint8=stage_uint8, head=head)
    e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    ms = {k: statistics.median(v) for k, v in per.items()}
    return {"device_decode": device_decode, "stage_uint8": stage_uint8,
            "ms_per_batch": ms, "sum_of_steps_ms": sum(ms.values()),
            "detect_images_ms": e2e_ms,
            "img_per_s": len(images) * 1e3 / e2e_ms,
            "bytes_staged": seen["staged"], "bytes_fetched": seen["fetched"],
            "detections": sum(len(d) for d in dets)}


def detect_path(device, head, kernels: dict, batch=DETECT["batch"],
                image=DETECT["image"], reps=DETECT_REPS,
                floor=None) -> dict:
    """One YOLO family through zoo.detect on `device`, bf16 int8w: the
    launches of matmul_int8w per forward (detect_images with the device
    decode, counts set to 0 just before), the device decode against the
    host decode on the engine's own head (threshold from conf_for_topk;
    at least `floor` kept rows, DECODE_FLOOR's by default),
    the device decode's launches and rounds, and the four routes' time
    breakdown (device / host decode, float / uint8 staging)."""
    import torch
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.zoo.detect import decode_device, detect_images

    floor = DECODE_FLOOR[head] if floor is None else floor
    t0 = time.perf_counter()
    eng, in_name, out_name, graph = detect_engine(device, head, "bfloat16",
                                                  True, batch, image)
    load_s = time.perf_counter() - t0
    images = seeded_images(sizes=DETECT_SIZES[:batch])
    pointwise = len(kernel_conv_names(graph))
    want = YOLOV8S_POINTWISE if head == "v8" else YOLOV5S_POINTWISE
    if pointwise != want:
        raise AssertionError(f"{head}: {pointwise} kernel convs, expected "
                             f"{want}")
    detect_images(eng, images, size=image, device_decode=True)   # warm
    kmm.launches = 0
    dets = detect_images(eng, images, size=image, device_decode=True)
    launches = kmm.launches
    if device.type == "cuda" and launches != pointwise:
        raise AssertionError(f"{head}: {launches} matmul_int8w launches in "
                             f"one detect_images, expected {pointwise}")
    # the device decode against the host decode of the same head output
    raw = eng.extract(out_name, as_numpy=False)
    head_np = raw.float().cpu().numpy()
    conf = conf_for_topk(head_np, head)
    rows = decode_device(raw, conf, 0.45, DETECT_MAX_DET, head,
                         pre_topk=DETECT_PRE_TOPK).cpu().numpy()
    cmp = decode_vs_host(rows, head_np, head, conf)
    res = {"phase": f"detect_{head}", "model": f"yolov{head[1]}s",
           "batch": batch, "image": image, "compute": "bfloat16",
           "quant": "int8w", "load_s": load_s,
           "image_sizes": [list(im.shape[:2]) for im in images],
           "matmul_int8w_launches": launches,
           "kernel_convs_per_forward": pointwise,
           "head_shape": list(raw.shape), "head_dtype": str(raw.dtype),
           "detections_at_0.25": [len(d) for d in dets],
           "decode_vs_host": dict(cmp, conf_thresh=conf, floor=floor),
           "decode_launches": decode_launches(device, raw, head, conf)}
    emit(res)
    check_decode(cmp, floor, f"{head} head")
    routes = [detect_breakdown(eng, images, head, image, dd, u8, reps)
              for dd in (True, False) for u8 in (False, True)]
    for r in routes:
        emit({"phase": f"detect_{head}_route", **r})
    res["routes"] = routes
    kernels.setdefault("matmul_int8w", {})[f"detect_{head}"] = {
        "launches": launches, "launches_per_forward": launches}
    res.update(engine=(eng, in_name, out_name, graph))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def v8_feed(batch, image) -> np.ndarray:
    """The YOLOv8s on-vs-off input: seeded uint8 NHWC pixels."""
    return np.random.default_rng(0).integers(
        0, 256, (batch, image, image, 3), dtype=np.uint8)


def detect_v8_extra(device, run, kernels: dict) -> dict:
    """YOLOv8s beyond detect_path: head="auto" picks v8; matmul_int8w
    against its plain version at the shapes the path gives it, and its
    time there; kernels on vs off (V8_ONOFF_TOL); fp32 on the card vs
    the CPU port at image 64 (DetectV8's DFL and anchors)."""
    import torch
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.zoo.detect import detect_images

    eng, in_name, out_name, _ = run.pop("engine")
    images = seeded_images(sizes=DETECT_SIZES[:run["batch"]])
    auto = detect_images(eng, images, size=run["image"], head="auto",
                         device_decode=True)
    v8 = detect_images(eng, images, size=run["image"], head="v8",
                       device_decode=True)
    if [[(d.box, d.class_id) for d in a] for a in auto] != \
            [[(d.box, d.class_id) for d in a] for a in v8]:
        raise AssertionError("detect_images(head='auto') did not pick v8")
    feed = v8_feed(run["batch"], run["image"])
    with Recorder({"matmul_int8w": kmm}, keep={
            "matmul_int8w": lambda x, w_q, *a, **kw: (
                int(x.shape[0]), int(x.shape[1]), int(w_q.shape[1]))}
            ) as rec:
        got = eng.run({in_name: feed})[out_name]
    shape_counts = rec.count("matmul_int8w")
    res = {"phase": "detect_v8_kernels", "head_auto": "v8", "shapes": [
        [*k, c] for k, c in sorted(shape_counts.items())]}
    entry = kernels.setdefault("matmul_int8w", {})["detect_v8"]
    if device.type == "cuda":
        entry["max_abs_err"] = kernel_vs_plain(
            device, list(shape_counts), ragged=False,
            phase="detect_v8_kernel_vs_plain")
        t = time_kernels(device, shape_counts)["matmul_int8w"]
        entry.update({k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})
    off = detect_engine(device, "v8", "bfloat16", False, run["batch"],
                        run["image"])[0]
    res["vs_kernels_off"] = parts_onoff(got, off.run({in_name: feed})[
        out_name], V8_ONOFF_TOL)
    del off
    emit(res)
    if not np.isfinite(got).all():
        raise AssertionError("yolov8s: a non-finite output")
    check_parts(res["vs_kernels_off"], "yolov8s kernels on vs off")
    # fp32 on the card vs the port on the CPU, small
    card, i_name, o_name, _ = detect_engine(device, "v8", "float32", True,
                                            2, 64)
    cpu = detect_engine(torch.device("cpu"), "v8", "float32", True, 2,
                        64)[0]
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32) / 3
    got = card.run({i_name: x})[o_name]
    want = cpu.run({i_name: x})[o_name]
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    emit({"phase": "detect_v8_fp32_card_vs_cpu", "shape": list(got.shape),
          "max_abs_err": err, "scale": scale,
          "tol": f"{FP32_TOL}*scale + {FP32_TOL}*|ref|"})
    np.testing.assert_allclose(got, want, atol=FP32_TOL * scale,
                               rtol=FP32_TOL)
    return res


def engine_warmup_phase(device, batches=WARMUP_BATCHES, image=640) -> dict:
    """Engine.warmup and Engine.temp_bytes on YOLOv5s bf16 int8w: seconds
    of warmup per batch size, with the kernel libraries unloaded first
    (build._libs cleared, as in a fresh process: warmup loads them);
    then the first forward after warmup must call kernels/build.py's
    `build` no time and load no library. temp_bytes per batch size must
    rise with the batch and stay below the card's free memory."""
    import torch
    from simpleinfer_tpu_torch.kernels import build

    eng, in_name, out_name, _ = detect_engine(device, "v5", "bfloat16",
                                              True, batches[0], image)
    calls = {"build": 0}
    orig_build = build.build

    def counted_build(*a, **kw):
        calls["build"] += 1
        return orig_build(*a, **kw)

    build._libs.clear()
    build.build = counted_build
    try:
        seconds = {}
        for bs in batches:
            t0 = time.perf_counter()
            eng.warmup((bs,))
            seconds[bs] = time.perf_counter() - t0
        loaded = sorted(build._libs)
        builds_in_warmup = calls["build"]
        x = np.random.default_rng(1).integers(
            0, 256, (batches[-1], image, image, 3), dtype=np.uint8)
        eng.input(in_name, x)
        eng.forward()
        eng.synchronize()
        after = {"build_calls": calls["build"] - builds_in_warmup,
                 "libraries_loaded": sorted(set(build._libs) - set(loaded))}
    finally:
        build.build = orig_build
    temp = {bs: eng.temp_bytes(bs) for bs in batches}
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" \
        else None
    res = {"phase": "engine_warmup", "model": "yolov5s", "image": image,
           "compute": "bfloat16", "quant": "int8w",
           "warmup_s": seconds, "libraries_loaded_by_warmup": loaded,
           "build_calls_in_warmup": builds_in_warmup,
           "first_forward_after_warmup": after,
           "temp_bytes": temp, "free_bytes": free}
    emit(res)
    if after["build_calls"] or after["libraries_loaded"]:
        raise AssertionError(f"the forward after warmup built or loaded: "
                             f"{after}")
    if device.type == "cuda":
        if "matmul.cu" not in loaded:
            raise AssertionError(f"warmup loaded {loaded}, not matmul.cu")
        vals = [temp[bs] for bs in batches]
        if any(b <= a for a, b in zip(vals, vals[1:])) or vals[-1] >= free:
            raise AssertionError(f"temp_bytes {temp} (free {free})")
    elif any(v is not None for v in temp.values()):
        raise AssertionError(f"temp_bytes on the CPU: {temp}")
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def segment_phase(device, kernels: dict, cfg=SEGMENT) -> dict:
    """build_unet bf16 int8w through zoo.segment: matmul_int8w's launches
    in one segment_images (counts set to 0 just before), the kernel
    against its plain version at the shapes the path gives it, and its
    time there; the device argmax against the host argmax of the same
    logits, and segment_images with either argmax; the logits against a
    use_kernels=False engine of the same graph (UNET_ONOFF_TOL)."""
    import torch
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.kernels import matmul as kmm
    from simpleinfer_tpu_torch.zoo import build_unet
    from simpleinfer_tpu_torch.zoo.common import fetch_nhwc
    from simpleinfer_tpu_torch.zoo.segment import (mask_from_logits,
                                                   segment_images)

    graph, in_name, out_name = build_unet(**cfg)
    engines = [Engine(EngineConfig(compute_dtype="bfloat16", quant="int8w",
                                   device=str(device), use_kernels=k)
                      ).load_model(None, graph=graph) for k in (True, False)]
    eng, off = engines
    images = seeded_images(seed=3, sizes=DETECT_SIZES[:cfg["batch"]])
    with Recorder({"matmul_int8w": kmm}, keep={
            "matmul_int8w": lambda x, w_q, *a, **kw: (
                int(x.shape[0]), int(x.shape[1]), int(w_q.shape[1]))}
            ) as rec:
        segment_images(eng, images)                   # warm
    shape_counts = rec.count("matmul_int8w")
    kmm.launches = 0
    dev = segment_images(eng, images)
    launches = kmm.launches
    want = len(kernel_conv_names(graph))
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"unet: {launches} matmul_int8w launches, "
                             f"expected {want}")
    logits = fetch_nhwc(eng, out_name, as_numpy=False)
    ids_dev = logits.argmax(dim=-1).int().cpu().numpy()
    logits_np = logits.float().cpu().numpy()
    ids_host = np.stack([mask_from_logits(v) for v in logits_np])
    host = segment_images(eng, images, device_argmax=False)
    masks_off = segment_images(off, images)
    logits_off = fetch_nhwc(off, out_name)
    res = {"phase": "segment", "model": "unet", **cfg,
           "compute": "bfloat16", "quant": "int8w",
           "matmul_int8w_launches": launches, "kernel_convs": want,
           "shapes": [[*k, c] for k, c in sorted(shape_counts.items())],
           "logits_shape": list(logits.shape),
           "same_logits_pixels_differing": int((ids_dev != ids_host).sum()),
           "mask_pixels": int(ids_dev.size),
           "classes_seen": int(len(np.unique(ids_dev))),
           "segment_images_pixels_differing": int(sum(
               (a != b).sum() for a, b in zip(dev, host))),
           "vs_kernels_off": parts_onoff(logits_np, logits_off,
                                         UNET_ONOFF_TOL),
           "mask_pixels_differing_vs_kernels_off": int(sum(
               (a != b).sum() for a, b in zip(dev, masks_off))),
           "image_pixels": int(sum(m.size for m in dev))}
    del engines, off
    entry = {"launches": launches, "launches_per_forward": launches}
    if device.type == "cuda":
        entry["max_abs_err"] = kernel_vs_plain(
            device, list(shape_counts), ragged=False,
            phase="segment_kernel_vs_plain")
        t = time_kernels(device, shape_counts)["matmul_int8w"]
        entry.update({k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})
    res["matmul_int8w"] = entry
    emit(res)
    if res["same_logits_pixels_differing"] or \
            res["segment_images_pixels_differing"]:
        raise AssertionError(f"device vs host argmax: {res}")
    if not np.isfinite(logits_np).all():
        raise AssertionError("unet: a non-finite logit")
    check_parts(res["vs_kernels_off"], "unet kernels on vs off")
    kernels.setdefault("matmul_int8w", {})["segment"] = entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def host_native_phase() -> dict:
    """The port's native host library (csrc/si_host.cpp, built by g++ at
    first use): loaded, letterbox_batch byte-equal to letterbox_one image
    by image and within LETTERBOX_*_TOL of the numpy route, and si_nms
    the numpy route's indices on the planted boxes."""
    from simpleinfer_tpu_torch import host
    from simpleinfer_tpu_torch.zoo.detect import (CLASS_OFFSET, letterbox,
                                                  nms)

    lib = host.library()
    images = seeded_images()
    res = {"phase": "host_native", "library": lib, "built": host.builds}
    if lib is None:
        emit(res)
        raise AssertionError("the native host library did not build/load")
    for norm, tol in ((False, LETTERBOX_RAW_TOL), (True, LETTERBOX_NORM_TOL)):
        t0 = time.perf_counter()
        batch = host.letterbox_batch(images, 640, normalize=norm)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        numpy_route = np.stack([letterbox(im, 640, normalize=norm,
                                          use_native=False)[0]
                                for im in images])
        numpy_ms = (time.perf_counter() - t0) * 1e3
        singles = np.stack([host.letterbox_one(im, 640, normalize=norm)
                            for im in images])
        err = float(np.abs(batch - numpy_route).max())
        res[f"letterbox_normalize_{norm}"] = {
            "batch_equals_singles": bool(np.array_equal(batch, singles)),
            "max_abs_vs_numpy": err, "tol": tol,
            "bytes_equal_to_numpy": bool(np.array_equal(batch, numpy_route)),
            "native_ms": native_ms, "numpy_ms": numpy_ms}
        if not np.array_equal(batch, singles) or err > tol:
            emit(res)
            raise AssertionError(f"native letterbox: {res}")
    pred = planted_head()[0]
    boxes = np.concatenate([pred[:, :2] - pred[:, 2:4] / 2,
                            pred[:, :2] + pred[:, 2:4] / 2], 1)
    cls = np.argmax(pred[:, 5:], 1)
    boxes = (boxes + cls[:, None] * CLASS_OFFSET).astype(np.float32)
    scores = (pred[:, 4] * pred[:, 5:].max(1)).astype(np.float32)
    native = nms(boxes, scores)
    plain = nms(boxes.astype(np.float64), scores.astype(np.float64))
    res["nms_native_equals_numpy"] = bool(np.array_equal(native, plain))
    res["nms_kept"] = int(len(native))
    emit(res)
    if not res["nms_native_equals_numpy"]:
        raise AssertionError("native nms differs from the numpy route")
    return res


def detect_rehearsal(device, image=64, batch=2) -> dict:
    """The detection phases at a tiny size (the CPU tests run them with
    the plain versions)."""
    kernels: dict = {}
    out = {"host_native": host_native_phase(),
           "planted": planted_checks(device)}
    for head in ("v5", "v8"):
        run = detect_path(device, head, kernels, batch=batch, image=image,
                          reps=1, floor=batch)
        if head == "v8":
            detect_v8_extra(device, run, kernels)
        run.pop("engine", None)
        out[head] = run
    out["warmup"] = engine_warmup_phase(device, batches=(1, 2), image=image)
    out["segment"] = segment_phase(device, kernels, dict(
        batch=batch, image_size=32, seed=0, width=8, depth=1))
    out["kernels"] = kernels
    return out


# ---- driver -------------------------------------------------------------
PHASES = ("yolo", "host_native", "detect_v5", "detect_v8", "engine_warmup",
          "segment", "yolo_int8", "conv_kernels", "resnet_int8",
          "llama_kernels", "llama_service", "llama_onoff", "llama_fp32")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (the default runs all; a subset prints no ok line)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
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
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    info = device_and_build(device)
    sass_mma_counts()
    kernels = {}

    if "yolo" in phases:
        on = yolo_engine(device, 8, 640, "bfloat16", True)
        off = yolo_engine(device, 8, 640, "bfloat16", False)
        rng = np.random.default_rng(123)
        warm = rng.integers(0, 256, (8, 640, 640, 3), dtype=np.uint8)
        from simpleinfer_tpu_torch.kernels import matmul as kmm

        # one warm-up forward: the (M, K, N) shapes the main path gives
        # matmul_int8w, with their counts
        with Recorder({"matmul_int8w": kmm}, keep={
                "matmul_int8w": lambda x, w_q, *a, **kw: (
                    int(x.shape[0]), int(x.shape[1]), int(w_q.shape[1]))}
                ) as rec:
            on[0].run({on[1]: warm})
        shape_counts = rec.count("matmul_int8w")
        emit({"phase": "main_path_shapes", "shapes": [
            [*k, c] for k, c in sorted(shape_counts.items())]})
        max_err = kernel_vs_plain(device, list(shape_counts))
        totals = time_kernels(device, shape_counts)
        main = main_path(device, engines=(on, off))
        del on, off
        fp32_card_vs_cpu(device)
        t = totals["matmul_int8w"]
        kernels["matmul_int8w"] = {
            "name": "matmul_int8w", "route": "cuda",
            "source": "simpleinfer_tpu_torch/csrc/matmul.cu",
            "replaces": "simpleinfer_tpu/kernels/matmul.py:183",
            "launches": main["launches"], "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # the dense entry `matmul` (bf16 w, the same kernel), timed at
            # the same shapes; no op dispatches it
            "matmul_dense": {k: totals["matmul"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
        torch.cuda.empty_cache()

    if "host_native" in phases:
        host_native_phase()
    if {"detect_v5", "detect_v8"} & set(phases):
        planted_checks(device)
    for head in ("v5", "v8"):
        if f"detect_{head}" in phases:
            run = detect_path(device, head, kernels)
            if head == "v8":
                detect_v8_extra(device, run, kernels)
            del run
            torch.cuda.empty_cache()
    if "engine_warmup" in phases:
        engine_warmup_phase(device)
    if "segment" in phases:
        segment_phase(device, kernels)
        torch.cuda.empty_cache()

    if "yolo_int8" in phases:
        yolo_int8_phase(device, kernels)
        torch.cuda.empty_cache()

    if "conv_kernels" in phases:
        kernels.update(conv_kernels_phase(device))
        torch.cuda.empty_cache()
    if "resnet_int8" in phases:
        resnet_int8_phase(device, kernels)
        torch.cuda.empty_cache()

    if "llama_kernels" in phases:
        llama_kernel_checks(device)
        flash_gate_sweep(device)
    if {"llama_service", "llama_onoff"} & set(phases):
        eng, build_s, load_s = llama_engine(device)
        emit({"phase": "llama_engine", "config": LLAMA,
              "compute": "bfloat16", "quant": "int4w", "int4_group": 128,
              "graph_build_s": build_s, "load_s": load_s,
              "weight_bytes_on_card": torch.cuda.memory_allocated(device)})
        layers = sum(impl.type == "si.RotaryAttention"
                     for impl in eng.program.impls)
        if "llama_service" in phases:
            run = service_run(eng, device)
            rec = run["recorder"]
            worst = llama_kernel_checks(device, main_shapes_of(rec))
            times = time_llama_kernels(device, rec, layers)
            decode_step_profile(eng, device, median_lengths(rec))
            decode_slots_sweep(eng, device, median_lengths(rec))
            launches = run["res"]["launches"]
            for name, src, repl in (
                    ("matmul_int4w", "matmul_int4w.cu",
                     "simpleinfer_tpu/kernels/matmul.py:325"),
                    ("flash_attention", "flash_attention.cu",
                     "simpleinfer_tpu/kernels/attention.py:159"),
                    ("decode_attention", "decode_attention.cu",
                     "simpleinfer_tpu/kernels/decode_attn.py:176")):
                t = times[name]
                kernels[name] = {
                    "name": name, "route": "cuda",
                    "source": f"simpleinfer_tpu_torch/csrc/{src}",
                    "replaces": repl, "launches": launches[name],
                    "max_abs_err": worst[name], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"],
                    **{u: t[u] for u in ("launches_per_step",
                                         "launches_per_wave") if u in t}}
            p = times["matmul_int4w_prefill"]   # per admission wave
            kernels["matmul_int4w"]["prefill"] = {
                u: p[u] for u in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "launches_per_wave")}
        if "llama_onoff" in phases:
            off, _, _ = llama_engine(device, use_kernels=False)
            ref, _, _ = llama_engine(device, compute="float32")
            check_onoff(onoff(eng, off, device, ref))
            del off, ref
        del eng
        torch.cuda.empty_cache()
    if "llama_fp32" in phases:
        llama_fp32_card_vs_cpu(device)

    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": list(kernels.values())})
    if phases != list(PHASES):
        return 0     # a partial run is a debugging aid: no ok line
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
