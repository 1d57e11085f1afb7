"""3x3 stride-1 "same" conv: the hand-written CUDA counterpart of the
Pallas `_kernel` behind `conv3x3_s1_same`
(simpleinfer_tpu/kernels/conv3x3.py).

`conv3x3_s1_same(x, w_hwio, bias, activation)` computes an NHWC conv
with stride 1 and zero padding 1 as an implicit GEMM (csrc/conv3x3.cu):
f32 sums, bias and activation in f32, one rounding to x's dtype. bf16 x
runs on the bf16 tensor cores (mma.sync, K walked tap-major), f32 x on
the exact f32-FMA tile. As in
the JAX package the weights are cast to x's dtype first, and a missing
bias is zeros. The TPU wrapper's VMEM budget (`conv3x3_vmem_ok` and its
ValueError) has no counterpart: the kernel takes any H, W, C and OC.

No op dispatches it, in the JAX package or here: Conv2d runs its 3x3
convs on the library conv (XLA's there, cuDNN here). chip_smoke.py
drives it at the ResNet-50 and YOLOv5s shapes.

`conv3x3_s1_same_ref` is the plain version (F.conv2d on the
channels-last view in f32 from the x-dtype operands), the CPU path and
the on-card oracle. The wrapper runs it only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. `launches` counts the
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .matmul import (MMA_BLOCK_M, _act_code, _DTYPE_CODES, mma_block_n,
                     resolve_activation)

# kernel launches since import (or since a caller reset them to 0)
launches = 0

SOURCE = "conv3x3.cu"


def conv3x3_s1_same_ref(x, w_hwio, bias=None,
                        activation: Optional[str] = None):
    """F.conv2d on the channels-last NCHW view, in f32 from the operands
    at x's dtype, then f32 bias and activation and the cast to x's dtype
    (TF32 is the caller's to switch off on the card)."""
    w = w_hwio.to(x.dtype).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=1)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    return resolve_activation(activation)(y).to(x.dtype)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_conv3x3.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                               ctypes.c_float, ci, vp]
    lib.si_conv3x3.restype = ci


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/conv3x3.cu (built at first use)."""
    return build.load(SOURCE, _bind, rebuild)


def conv3x3_s1_same(x, w_hwio, bias=None, activation: Optional[str] = None):
    """NHWC 3x3 stride-1 pad-1 conv with fused bias + activation.

    x: [N, H, W, C] (f32 or bf16; the output has its dtype);
    w_hwio: [3, 3, C, OC] (cast to x's dtype); bias: [OC] or None.
    The TPU wrapper's `interpret` is its CPU mode and has no
    counterpart here."""
    global launches
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    kh, kw, wc, oc = w_hwio.shape
    if (kh, kw) != (3, 3) or wc != c:
        raise ValueError(f"conv3x3 kernel needs [3,3,{c},OC] weights, "
                         f"got {tuple(w_hwio.shape)}")
    if bias is not None and tuple(bias.shape) != (oc,):
        raise ValueError(f"bias {tuple(bias.shape)}, expected ({oc},)")
    if x.device.type == "cpu":
        return conv3x3_s1_same_ref(x, w_hwio, bias, activation)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA conv3x3 kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype} is not float32/bfloat16")
    for name, t in (("w_hwio", w_hwio), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    # the tensor-core tile's M tiles ride gridDim.y (<= 65535)
    if (n * h * w * max(c, oc) >= 2 ** 31
            or (x.dtype == torch.bfloat16
                and -(-n * h * w // MMA_BLOCK_M) > 65535)):
        raise ValueError(f"conv3x3 too large for the kernel: "
                         f"{tuple(x.shape)} -> {oc}")
    code, arg = _act_code(activation)
    x = x.contiguous()
    wt = w_hwio.to(x.dtype).contiguous()
    b = (torch.zeros(oc, dtype=torch.float32, device=x.device)
         if bias is None else bias.float().contiguous())
    out = torch.empty((n, h, w, oc), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.si_conv3x3(
            x.data_ptr(), _DTYPE_CODES[x.dtype], wt.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, w, c, oc, code, arg, mma_block_n(oc),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_conv3x3 launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, oc {oc})")
    launches += 1
    return out
