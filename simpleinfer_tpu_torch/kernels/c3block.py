"""Fused C3 block: the hand-written CUDA counterpart of the Pallas
`_c3_kernel` (simpleinfer_tpu/kernels/c3block.py).

`c3_block` computes a whole YOLOv5 C3 block (cv1 / cv2 1x1, T
bottlenecks of a 1x1 then a 3x3 "same" with an optional residual, cv3
over the never copied concat) in one call of csrc/c3block.cu, which
enqueues one kernel per stage over a workspace allocated here (the
source's header says why the stages are split). bf16 blocks whose
channel widths are multiples of 8 run on the bf16 tensor cores (cv1 and
cv2 one GEMM into [y1 | y2], cv3 one GEMM over it); f32 blocks run the
exact f32-FMA tile. With `btl_b_scale` the 3x3 taps are int8: each
bottleneck's activation is quantized once per IMAGE (its abs-max over
the whole image) and multiplied exactly on the int8 tensor cores. That
is the semantics of the JAX package's docstring and of its oracle
`c3_block_reference`; its TPU kernel takes the abs-max per row band
instead (ROADMAP.md §3).

`c3_block_reference` is the plain version: the same block as a chain of
torch ops (f32 sums; the s8 taps exact through float64), the CPU path
and the on-card oracle. The wrapper runs it only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. `launches` counts the
calls that launched csrc/c3block.cu (one per block), `tc_launches` those
of them that took the tensor-core route, and `weight_copies` the weight
operands the wrapper had to convert or copy before a launch (none on a
path whose weights were placed at x's dtype). `c3_block` is also the
custom op `torch.ops.simpleinfer.c3_block`, called while it is traced
(kernels/__init__.py).

The gates: `c3_supported` (channel widths and the JAX package's TPU
VMEM fit) and `c3_taps_s8_profitable` (hid < 128) are the JAX
package's; `c3_profitable` compares the work per image with
`C3_MIN_WORK`, measured on the H100 (chip_smoke.py's C3 gate sweep),
and with `min_work=JAX_C3_MIN_WORK` gives the JAX package's decision,
which alone decides where the taps are int8 (ops/c3.py): the s8 taps
are the reference's numerics, not a speed gate.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build, tracing
from .matmul import _act_code, _DTYPE_CODES, resolve_activation

# calls that launched csrc/c3block.cu since import (or since a reset),
# those of them on the tensor-core route, and weight operands converted
# or copied per call
launches = 0
tc_launches = 0
weight_copies = 0

SOURCE = "c3block.cu"

# the JAX package's VMEM cap of its TPU kernel, kept in c3_supported so
# both packages take the same blocks
_VMEM_CAP = 100 * 1024 * 1024
# c3_profitable's threshold on h*w*hid*T: the JAX package's default
# (TPU v5e), which decides the s8 taps, and the H100's, which decides
# kernel or chain. chip_smoke.py's C3 gate sweep over yolov5l-640-b16's 8
# fused blocks (bf16, NVIDIA H100 80GB HBM3 at 700 W; PERF.md): c3_block
# beats ops/c3.c3_chain by 1.2x and more from 1.23 M of work up; at the
# two 20x20 blocks (0.61 M) each was faster in some runs (chain 0.70-1.57
# ms, kernel 0.78-0.95 over four runs), so the gate lies between
JAX_C3_MIN_WORK = 2_000_000
C3_MIN_WORK = 1_000_000


def c3_vmem_bytes(h: int, w: int, c: int, hid: int, oc: int) -> int:
    """The JAX package's per-image VMEM estimate of its TPU kernel
    (bytes, bf16 data): double-buffered x/out blocks plus the largest
    concurrent set of intermediates."""
    hw = h * w
    return (2 * hw * c * 2 + 2 * hw * oc * 2 + 2 * hw * hid * 2
            + 2 * hw * hid * 4 + hw * oc * 4 + 9 * hid * hid * 2 * 4
            + (1 << 20))


def c3_profitable(h: int, w: int, hid: int, n_btl: int,
                  min_work: int | None = None) -> bool:
    """Work-size dispatch gate: h*w*hid*T >= `min_work`, by default
    C3_MIN_WORK (the H100's measurement); JAX_C3_MIN_WORK gives the JAX
    package's (TPU v5e: the fused kernel won at >= ~2M, yolov5l's large
    blocks, and lost at yolov5s's). Reads the constants at call time, so
    a caller that runs a model at a smaller image can scale them."""
    return h * w * hid * n_btl >= (C3_MIN_WORK if min_work is None
                                   else min_work)


def c3_taps_s8_profitable(hid: int) -> bool:
    """s8 taps only at narrow hid (the JAX package's TPU measurement)."""
    return hid < 128


def c3_supported(h: int, w: int, c: int, hid: int, oc: int) -> bool:
    """Dispatch eligibility of the JAX package: hid >= 64, channel
    widths multiples of 8, and its TPU VMEM fit."""
    return (hid >= 64 and hid % 8 == 0 and c % 8 == 0 and oc % 8 == 0
            and c3_vmem_bytes(h, w, c, hid, oc) <= _VMEM_CAP)


def quantize_taps(btl_b_w: np.ndarray):
    """Per-output-channel symmetric s8 quantization of the bottleneck 3x3
    taps [T, 9, hid, hid] -> (int8, scales [T, hid]), in numpy exactly as
    the JAX package's quantize_taps; load-time prep of the s8 tap path."""
    amax = np.maximum(np.abs(btl_b_w).max(axis=(1, 2)), 1e-8)  # [T, hid]
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(btl_b_w / scale[:, None, None, :]),
                -127, 127).astype(np.int8)
    return q, scale


def c3_block_reference(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2,
                       cv3_b, btl_a_w, btl_a_b, btl_b_w, btl_b_b,
                       btl_b_scale=None, activation: str | None = "silu",
                       shortcut: bool = True):
    """The C3 block as a chain of torch ops (the unfused convs' math):
    conv + bias + act per step, weights at x's dtype, f32 sums, results
    rounded to x's dtype. With btl_b_scale, the int8-static taps: per-
    image dynamic s8 activations x per-channel s8 weights, the s32 sum
    exact through float64, f32 dequant. TF32 is the caller's to switch
    off on the card (Engine.forward does in fp32)."""
    act = resolve_activation(activation) if activation else (lambda v: v)
    dt = x.dtype

    def conv1x1(t, wm, bias, keep_f32=False):
        y = t.float() @ wm.to(t.dtype).float() + bias.float()
        return act(y) if keep_f32 else act(y).to(t.dtype)

    def oihw(w9, dtype):
        hid_in, hid_out = w9.shape[1], w9.shape[2]
        return w9.to(dtype).reshape(3, 3, hid_in, hid_out).permute(3, 2, 0, 1)

    def conv3x3(t, w9, bias):
        y = F.conv2d(t.permute(0, 3, 1, 2).float(),
                     oihw(w9.to(t.dtype), torch.float32), padding=1)
        y = y.permute(0, 2, 3, 1) + bias.float()
        return act(y).to(t.dtype)

    def conv3x3_s8(t_f32, wq9, wscale, bias):
        # per-IMAGE dynamic activation quant
        amax = t_f32.abs().amax(dim=(1, 2, 3), keepdim=True)
        ascale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(t_f32 / ascale), -127.0, 127.0)
        zi = F.conv2d(q.permute(0, 3, 1, 2).double(),
                      oihw(wq9, torch.float64), padding=1)
        y = zi.permute(0, 2, 3, 1).float() * (ascale * wscale.float())
        return act(y + bias.float()).to(dt)

    y1 = conv1x1(x, cv1_w, cv1_b)
    for t in range(btl_a_w.shape[0]):
        if btl_b_scale is not None:
            af = conv1x1(y1, btl_a_w[t], btl_a_b[t], keep_f32=True)
            z = conv3x3_s8(af, btl_b_w[t], btl_b_scale[t], btl_b_b[t])
        else:
            a = conv1x1(y1, btl_a_w[t], btl_a_b[t])
            z = conv3x3(a, btl_b_w[t], btl_b_b[t])
        y1 = z + y1 if shortcut else z
    y2 = conv1x1(x, cv2_w, cv2_b)
    cat = torch.cat([y1, y2], dim=-1)
    return conv1x1(cat, torch.cat([cv3_w1.to(dt), cv3_w2.to(dt)], 0), cv3_b)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_c3_block.argtypes = ([vp, ci, ci] + [vp] * 17 + [ci] * 9
                                + [ctypes.c_float, ctypes.POINTER(ci), vp])
    lib.si_c3_block.restype = ci


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/c3block.cu (built at first use)."""
    return build.load(SOURCE, _bind, rebuild)


def c3_block(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b,
             btl_a_w, btl_a_b, btl_b_w, btl_b_b, btl_b_scale=None,
             activation: str | None = "silu", shortcut: bool = True):
    """Fused C3 block over NHWC input.

    x:        [N, H, W, C] (f32 or bf16; the output has its dtype)
    cv1_w:    [C, hid]   cv1_b: [hid]     (block-input 1x1 + act)
    cv2_w:    [C, hid]   cv2_b: [hid]     (parallel 1x1 + act)
    cv3_w1:   [hid, OC]  cv3_w2: [hid, OC]  cv3_b: [OC]
              (cv3's [2*hid, OC] weight split into its cat halves: rows
               [:hid] multiply the bottleneck branch, [hid:] cv2's)
    btl_a_w:  [T, hid, hid]   btl_a_b: [T, hid]    (bottleneck 1x1s)
    btl_b_w:  [T, 9, hid, hid] btl_b_b: [T, hid]   (3x3 taps, HWIO
              flattened h-major: tap = kh*3 + kw)
    shortcut=True adds the residual after every bottleneck (the backbone
    form); False is the PAN-head form.

    btl_b_scale [T, hid] (f32) switches the 3x3 taps to int8: btl_b_w
    must then be int8 (per-output-channel quantized with these scales,
    `quantize_taps`), and each bottleneck's activation is quantized per
    image in the kernel. The TPU wrapper's `band_rows` and `interpret`
    are its VMEM banding and its CPU mode and have no counterpart here.
    Weights are taken as given where they are contiguous and at x's
    dtype (btl_b_w int8 with btl_b_scale), the five biases where all are
    f32 or all bf16 (an engine places them at its compute dtype),
    btl_b_scale in f32; anything else is converted (counted in
    `weight_copies`). Returns [N, H, W, OC] in x.dtype."""
    if tracing(x):
        return torch.ops.simpleinfer.c3_block(
            x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b, btl_a_w,
            btl_a_b, btl_b_w, btl_b_b, btl_b_scale, activation, shortcut)
    return _c3_block(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b,
                     btl_a_w, btl_a_b, btl_b_w, btl_b_b, btl_b_scale,
                     activation, shortcut)


def _c3_block(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b,
              btl_a_w, btl_a_b, btl_b_w, btl_b_b, btl_b_scale, activation,
              shortcut):
    global launches, tc_launches, weight_copies
    if x.device.type == "cpu":
        return c3_block_reference(
            x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b, btl_a_w,
            btl_a_b, btl_b_w, btl_b_b, btl_b_scale, activation, shortcut)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA c3 kernel needs CUDA tensors, got "
                         f"{x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {dt} is not float32/bfloat16")
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    hid, oc, nb = cv1_w.shape[1], cv3_w1.shape[1], btl_a_w.shape[0]
    s8 = btl_b_scale is not None
    want = {"cv1_w": (c, hid), "cv1_b": (hid,), "cv2_w": (c, hid),
            "cv2_b": (hid,), "cv3_w1": (hid, oc), "cv3_w2": (hid, oc),
            "cv3_b": (oc,), "btl_a_w": (nb, hid, hid), "btl_a_b": (nb, hid),
            "btl_b_w": (nb, 9, hid, hid), "btl_b_b": (nb, hid)}
    given = dict(cv1_w=cv1_w, cv1_b=cv1_b, cv2_w=cv2_w, cv2_b=cv2_b,
                 cv3_w1=cv3_w1, cv3_w2=cv3_w2, cv3_b=cv3_b, btl_a_w=btl_a_w,
                 btl_a_b=btl_a_b, btl_b_w=btl_b_w, btl_b_b=btl_b_b)
    if s8:
        want["btl_b_scale"] = (nb, hid)
        given["btl_b_scale"] = btl_b_scale
    for k, shape in want.items():
        t = given[k]
        if tuple(t.shape) != shape:
            raise ValueError(f"c3_block: {k} {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != x.device:
            raise ValueError(f"c3_block: {k} is on {t.device}, x on "
                             f"{x.device}")
    if s8 and btl_b_w.dtype != torch.int8:
        raise TypeError("btl_b_scale given but btl_b_w is not int8")
    if n * h * w * max(c, hid, oc) >= 2 ** 31:
        raise ValueError(f"c3_block too large for the kernel: "
                         f"{tuple(x.shape)}, hid {hid}, oc {oc}")
    code, arg = _act_code(activation)
    x = x.contiguous()

    copies = 0

    def as_(t, dtype):
        nonlocal copies
        u = t.to(dtype).contiguous()
        copies += u.data_ptr() != t.data_ptr() or u.dtype != t.dtype
        return u

    biases = (cv1_b, cv2_b, cv3_b, btl_a_b, btl_b_b)
    bdt = (torch.bfloat16 if all(b.dtype == torch.bfloat16 for b in biases)
           else torch.float32)
    args = [as_(cv1_w, dt), as_(cv1_b, bdt), as_(cv2_w, dt),
            as_(cv2_b, bdt), as_(cv3_w1, dt), as_(cv3_w2, dt),
            as_(cv3_b, bdt), as_(btl_a_w, dt), as_(btl_a_b, bdt),
            as_(btl_b_w, torch.int8 if s8 else dt), as_(btl_b_b, bdt),
            as_(btl_b_scale, torch.float32) if s8 else None]
    m = n * h * w
    ybuf = torch.empty(m * 2 * hid, dtype=dt, device=x.device)
    abuf = torch.empty(m * hid, dtype=torch.float32, device=x.device)
    qbuf = (torch.empty(m * hid, dtype=torch.int8, device=x.device)
            if s8 else None)
    amax = torch.empty(n, dtype=torch.int32, device=x.device)
    out = torch.empty((n, h, w, oc), dtype=dt, device=x.device)
    route = ctypes.c_int(-1)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.si_c3_block(
            x.data_ptr(), _DTYPE_CODES[dt], _DTYPE_CODES[bdt],
            *[a.data_ptr() if a is not None else None for a in args],
            ybuf.data_ptr(), abuf.data_ptr(),
            qbuf.data_ptr() if s8 else None, amax.data_ptr(),
            out.data_ptr(), n, h, w, c, hid, oc, nb, int(shortcut), code,
            arg, ctypes.byref(route),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_c3_block launch failed with CUDA error {err}"
                           f" (x {tuple(x.shape)}, hid {hid}, oc {oc}, "
                           f"T {nb}, s8 {s8})")
    launches += 1
    tc_launches += route.value == 1
    weight_copies += copies
    return out


_T = torch.Tensor


@torch.library.custom_op("simpleinfer::c3_block", mutates_args=())
def _c3_block_op(x: _T, cv1_w: _T, cv1_b: _T, cv2_w: _T, cv2_b: _T,
                 cv3_w1: _T, cv3_w2: _T, cv3_b: _T, btl_a_w: _T, btl_a_b: _T,
                 btl_b_w: _T, btl_b_b: _T, btl_b_scale: Optional[_T],
                 activation: Optional[str], shortcut: bool) -> _T:
    return _c3_block(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b,
                     btl_a_w, btl_a_b, btl_b_w, btl_b_b, btl_b_scale,
                     activation, shortcut)


@_c3_block_op.register_fake
def _(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, *rest):
    return x.new_empty((*x.shape[:3], cv3_w1.shape[1]))
