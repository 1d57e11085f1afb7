"""The YOLOv5 6x6 stride-2 pad-2 stem conv: the hand-written CUDA
counterpart of the Pallas `_stem_kernel` behind `stem_s2d`
(simpleinfer_tpu/kernels/stem.py).

The input keeps the TPU's staged layout at the public function, so the
two packages compare like with like: `pack_stem_input` turns an
[N, 640, 640, 3] image into x_packed [N, 645, 6, 320] (H-padded rows x
W-parity*3 + channel x output column) and `pack_stem_weights` an OIHW
[OC, 3, 6, 6] weight into w_packed [128, OC] (patch row k = kh*18 + j*6
+ wl*3 + c; rows 108..127 zero). Both are host numpy, copies of the JAX
package's, byte for byte.

`stem_s2d(x_packed, w_packed, bias, activation)` returns the stem output
[N, 320, 320, OC] in bf16: the 108 patch taps of each output pixel as an
im2col GEMM in shared memory on the bf16 tensor cores (csrc/stem.cu),
x and w at bf16 (as the JAX package casts them: w_packed may be f32 or
bf16, and the kernel rounds an f32 one as it stages it, so no call
casts the weight), f32 sums, bias and the optional activation in f32.

No op dispatches it, in the JAX package or here: Conv2d runs the stem on
the library conv. chip_smoke.py drives it at the YOLOv5s / YOLOv5l-640
stems.

`stem_s2d_ref` is the plain version (the same patches as one f32 matmul
on the same packed inputs), the CPU path and the on-card oracle. The
wrapper runs it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. `launches` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .matmul import _act_code, resolve_activation

# kernel launches since import (or since a caller reset them to 0)
launches = 0

SOURCE = "stem.cu"

_K_PAD = 128   # 108 useful patch taps, zero-padded (the TPU's lane width)
_K_USED = 108
_HP = 645      # 640 + 2 top pad + 3 bottom (2 conv pad + 1 slice slack)
_OHW = 320
# w_packed dtypes the kernel stages (csrc/epilogue.cuh's DType codes)
_W_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_stem_weights(w_oihw: np.ndarray) -> np.ndarray:
    """OIHW [OC, 3, 6, 6] -> patch-matrix weights [128, OC] f32, row
    k = kh*18 + j*6 + wl*3 + c: tap (kh, kw) with kw = 2*j + wl reads
    input column 2*(m + j - 1) + wl."""
    oc, ic, kh_, kw_ = w_oihw.shape
    if (ic, kh_, kw_) != (3, 6, 6):
        raise ValueError(f"stem kernel expects [oc,3,6,6], got {w_oihw.shape}")
    wp = np.zeros((_K_PAD, oc), np.float32)
    for kh in range(6):
        for j in range(3):
            for wl in range(2):
                kw = 2 * j + wl
                for c in range(3):
                    wp[kh * 18 + j * 6 + wl * 3 + c] = w_oihw[:, c, kh, kw]
    return wp


def pack_stem_input(x_nhwc: np.ndarray) -> np.ndarray:
    """[N, 640, 640, 3] image -> the staged layout [N, 645, 6, 320] =
    H-padded rows x (w-parity*3 + channel) x output column (host numpy:
    one strided transpose and a pad)."""
    n, h, w, c = x_nhwc.shape
    if (h, w, c) != (640, 640, 3):
        raise ValueError(f"expected [N,640,640,3], got {x_nhwc.shape}")
    xk = np.ascontiguousarray(
        x_nhwc.reshape(n, h, w // 2, 2, c).transpose(0, 1, 3, 4, 2)
    ).reshape(n, h, 2 * c, w // 2)
    out = np.zeros((n, _HP, 2 * c, w // 2), x_nhwc.dtype)
    out[:, 2:2 + h] = xk
    return out


def stem_s2d_ref(x_packed, w_packed, bias, activation: Optional[str] = None):
    """The plain version on the same packed inputs: each output pixel's
    108 patch taps gathered from the staged rows and lanes (lanes -1 and
    320 zero), one f32 matmul against w_packed's first 108 rows (x and w
    at bf16 first), bias, activation, bf16."""
    xp = F.pad(x_packed.to(torch.bfloat16).float(), (1, 1))  # lanes -1, 320
    pieces = []
    for kh in range(6):
        rows = xp[:, kh:kh + 2 * _OHW:2]          # staged rows 2*oh + kh
        for j in range(3):
            pieces.append(rows[..., j:j + _OHW])  # lane m + j - 1
    n = x_packed.shape[0]
    patches = torch.stack(pieces, 2).reshape(n, _OHW, _K_USED, _OHW)
    w = w_packed[:_K_USED].to(torch.bfloat16).float()
    y = patches.transpose(2, 3) @ w + bias.float()
    return resolve_activation(activation)(y).to(torch.bfloat16)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_stem_s2d.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci,
                                ctypes.c_float, vp]
    lib.si_stem_s2d.restype = ci


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/stem.cu (built at first use)."""
    return build.load(SOURCE, _bind, rebuild)


def stem_s2d(x_packed, w_packed, bias, activation: Optional[str] = None):
    """Fused stem conv on the staged input.

    x_packed: [N, 645, 6, 320] (`pack_stem_input` of the image);
    w_packed: [128, OC] (`pack_stem_weights` of the OIHW weight);
    bias: [OC]. Returns [N, 320, 320, OC] bf16. On the card w_packed is
    read as given in f32 or bf16 (another dtype raises), x_packed at
    bf16 from a 16-byte aligned start (a misaligned view is copied). The
    TPU wrapper's `interpret` is its CPU mode and has no counterpart
    here."""
    global launches
    n = x_packed.shape[0]
    if tuple(x_packed.shape[1:]) != (_HP, 6, _OHW):
        raise ValueError(f"expected [N,{_HP},6,{_OHW}], got "
                         f"{tuple(x_packed.shape)}")
    if w_packed.ndim != 2 or w_packed.shape[0] != _K_PAD:
        raise ValueError(f"w_packed must be [{_K_PAD}, OC], got "
                         f"{tuple(w_packed.shape)}")
    oc = w_packed.shape[1]
    if tuple(bias.shape) != (oc,):
        raise ValueError(f"bias {tuple(bias.shape)}, expected ({oc},)")
    if x_packed.device.type == "cpu":
        return stem_s2d_ref(x_packed, w_packed, bias, activation)
    if x_packed.device.type != "cuda":
        raise ValueError(f"the CUDA stem kernel needs CUDA tensors, got "
                         f"{x_packed.device}")
    for name, t in (("w_packed", w_packed), ("bias", bias)):
        if t.device != x_packed.device:
            raise ValueError(f"{name} is on {t.device}, x_packed on "
                             f"{x_packed.device}")
    if n * _OHW * _OHW * max(oc, 64) >= 2 ** 31:
        raise ValueError(f"stem too large for the kernel: N={n}, OC={oc}")
    if w_packed.dtype not in _W_CODES:
        raise TypeError(f"w_packed dtype {w_packed.dtype} is not "
                        f"float32/bfloat16")
    code, arg = _act_code(activation)
    x = x_packed.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:           # the bulk copies start 16-byte aligned
        x = x.clone()
    w = w_packed.contiguous()
    b = bias.float().contiguous()
    out = torch.empty((n, _OHW, _OHW, oc), dtype=torch.bfloat16,
                      device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.si_stem_s2d(
            x.data_ptr(), w.data_ptr(), _W_CODES[w.dtype], b.data_ptr(),
            out.data_ptr(), n, oc, code, arg,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_stem_s2d launch failed with CUDA error {err} "
                           f"(N={n}, OC={oc})")
    launches += 1
    return out
