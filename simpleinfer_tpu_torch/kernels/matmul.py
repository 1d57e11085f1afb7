"""Fused-epilogue GEMM: the hand-written CUDA counterpart of the Pallas
`_matmul_kernel` (simpleinfer_tpu/kernels/matmul.py).

Entry points with the JAX signatures:
- matmul(x, w, ...)               — dense weights [K, N]
- matmul_int8w(x, w_q, scale, ...) — int8 weights + per-column f32 scale
  (per-OUTPUT-channel symmetric quantization, quant/tensor.py); the
  dequant `acc * scale[n]` is folded into the epilogue.
- matmul_int4w(x, wq4, ...)       — a Quantized4Tensor (group-wise int4,
  nibble-packed; quant/tensor.py), the counterpart of the Pallas
  `_matmul_int4w_kernel`.
- matmul_s8s8(x_q, w_q, scale, ...) — static int8: int8 activations x
  int8 weights with an exact s32 sum, dequantized by scale[N] in the
  epilogue; the counterpart of the Pallas `_matmul_s8s8_kernel`.

The first three compute ``act(x @ w (dequantized) + bias?)`` with f32
accumulation for any M, N and K. `matmul` and `matmul_int8w` share ONE
CUDA source (csrc/matmul.cu), templated on the input, weight and output
dtypes: bf16 x with bf16 or int8 w runs on the bf16 tensor cores
(mma.sync, the int8 weight converted to bf16 in shared memory, the scale
applied to the f32 sum), any f32 operand on the exact f32-FMA tile;
`matmul_int4w` (csrc/matmul_int4w.cu) and `matmul_s8s8`
(csrc/matmul_s8s8.cu, wgmma on the s8 tensor cores) are their own. The
kernels are built with nvcc for sm_90a at first use, into `_build/`
beside this package, and bound with ctypes (kernels/build.py).

A wrapper runs its plain PyTorch version (`matmul_ref`,
`matmul_int8w_ref`, `matmul_int4w_ref`, `matmul_s8s8_ref`) only for
tensors on the CPU.
For CUDA tensors it launches the kernel or raises; there is no
fallback. `launches` counts the launches of csrc/matmul.cu,
`launches_int4w` those of csrc/matmul_int4w.cu and `launches_s8s8`
those of csrc/matmul_s8s8.cu, so a run can show that its path went
through each kernel; `transposes_s8s8` counts the row-major weights
`matmul_s8s8` had to lay out K-major before its launch (none on a path
whose engine placed its weights, Engine.place_weights).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import build

# kernel launches since import (or since a caller reset them to 0)
launches = 0
launches_int4w = 0
launches_s8s8 = 0
transposes_s8s8 = 0

SOURCE = "matmul.cu"
SOURCE_INT4W = "matmul_int4w.cu"
SOURCE_S8S8 = "matmul_s8s8.cu"

# dtype codes of csrc/matmul.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# activation codes of csrc/matmul.cu (enum Act)
_ACT_CODES = {
    None: 0, "relu": 1, "silu": 2, "sigmoid": 3, "hardsigmoid": 4,
    "hardswish": 5, "relu6": 6, "tanh": 7, "mish": 8, "gelu": 9,
    "gelu_tanh": 10, "leaky_relu": 11, "elu": 12,
}

_ACTIVATIONS: dict = {
    None: lambda x: x,
    "relu": F.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(x * (1.0 / 6.0) + 0.5, 0.0, 1.0),
    "hardswish": lambda x: x * torch.clamp(x * (1.0 / 6.0) + 0.5, 0.0, 1.0),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "tanh": torch.tanh,
    "mish": F.mish,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def resolve_activation(name) -> Callable:
    """Epilogue-activation lookup on torch tensors; parameterized forms
    encode their argument as `name@value` (e.g. "leaky_relu@0.1",
    "elu@1.0"), as ir/passes.py's fusion carries them."""
    if name in _ACTIVATIONS:
        return _ACTIVATIONS[name]
    base, _, arg = (name or "").partition("@")
    if base == "leaky_relu" and arg:
        s = float(arg)
        return lambda x: torch.where(x >= 0, x, x * s)
    if base == "elu" and arg:
        return lambda x, _a=float(arg): F.elu(x, alpha=_a)
    raise KeyError(f"unknown epilogue activation {name!r}")


def _act_code(name) -> tuple:
    """(enum code, float argument) of an activation name for the kernel."""
    resolve_activation(name)  # raises on unknown names
    if name in _ACT_CODES:
        return _ACT_CODES[name], 0.0
    base, _, arg = name.partition("@")
    return _ACT_CODES[base], float(arg)


# ---- plain PyTorch versions (the CPU path and the on-card oracle) -------
def matmul_ref(x, w, bias=None, activation: Optional[str] = None,
               out_dtype=None):
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return resolve_activation(activation)(out).to(out_dtype or x.dtype)


def matmul_int8w_ref(x, w_q, scale, bias=None,
                     activation: Optional[str] = None, out_dtype=None):
    out = (x.float() @ w_q.float()) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return resolve_activation(activation)(out).to(out_dtype or x.dtype)


def matmul_int4w_ref(x, wq4, bias=None, activation: Optional[str] = None,
                     out_dtype=None):
    """Dense f32 dequant, then the product (the CPU path and the
    on-card oracle of matmul_int4w)."""
    out = x.float() @ wq4.dequantize(torch.float32)
    if bias is not None:
        out = out + bias.float()
    return resolve_activation(activation)(out).to(out_dtype or x.dtype)


def matmul_s8s8_ref(x_q, w_q, scale, bias=None,
                    activation: Optional[str] = None,
                    out_dtype=torch.bfloat16):
    """Exact s32 reference of matmul_s8s8 on every device: the product
    in float64 (|acc| <= K * 127^2, far below 2^53, so every sum is
    exact in any order; CPU torch has no int8 matmul that keeps s32),
    then the f32 epilogue of the JAX package's matmul_s8s8_ref."""
    acc = x_q.double() @ w_q.double()
    out = acc.float() * scale.float()
    if bias is not None:
        out = out + bias.float()
    return resolve_activation(activation)(out).to(out_dtype)


# ---- bind ---------------------------------------------------------------
def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_matmul.argtypes = [vp, ci, vp, ci, vp, vp, ci, vp, ci, ci, ci,
                              ci, ci, ctypes.c_float, ci, vp]
    lib.si_matmul.restype = ci


def _bind_int4w(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_matmul_int4w.argtypes = [vp, ci, vp, vp, vp, ci, vp, ci, ci, ci,
                                    ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.si_matmul_int4w.restype = ci


def _bind_s8s8(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_matmul_s8s8.argtypes = [vp, vp, vp, vp, ci, vp, ci, ci, ci, ci,
                                   ci, ctypes.c_float, vp]
    lib.si_matmul_s8s8.restype = ci


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/matmul.cu (built at first use)."""
    return build.load(SOURCE, _bind, rebuild)


def load_library_int4w(rebuild: bool = False):
    """The ctypes library of csrc/matmul_int4w.cu (built at first use)."""
    return build.load(SOURCE_INT4W, _bind_int4w, rebuild)


def load_library_s8s8(rebuild: bool = False):
    """The ctypes library of csrc/matmul_s8s8.cu (built at first use)."""
    return build.load(SOURCE_S8S8, _bind_s8s8, rebuild)


# ---- wrappers -----------------------------------------------------------
def _check_vec(name, v, n, dtypes, device):
    if v is None:
        return
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, x on {device}")
    if v.dtype not in dtypes:
        raise TypeError(f"{name} dtype {v.dtype} not in {dtypes}")
    if tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [{n}] vector, got "
                         f"{tuple(v.shape)}")


# output rows of a tensor-core block, and its two widths (csrc/mma.cuh)
MMA_BLOCK_M = 128


def mma_block_n(n: int) -> int:
    """Width of the tensor-core output tile for N columns: 64 up to N 64
    (YOLOv5s's narrow pointwise convs), else 128."""
    return 64 if n <= 64 else 128


def _launch(x, w, scale, bias, activation, out_dtype):
    """Check what the kernel takes, allocate the output, launch on the
    current stream, count the launch."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA matmul kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype} is not float32/bfloat16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (row-major)")
    m, k = x.shape
    n = w.shape[1]
    # the C interface takes int sizes; the f32 tile's N tiles and the
    # tensor-core tile's M tiles ride gridDim.y (<= 65535)
    mma = x.dtype == torch.bfloat16 and w.dtype != torch.float32
    if (m >= 2 ** 31 or k >= 2 ** 31 or n > 65535 * 64
            or (mma and -(-m // MMA_BLOCK_M) > 65535)):
        raise ValueError(f"matmul too large for the kernel: M={m}, "
                         f"K={k}, N={n}")
    _check_vec("scale", scale, n, (torch.float32,), x.device)
    _check_vec("bias", bias, n, (torch.float32, torch.bfloat16), x.device)
    code, arg = _act_code(activation)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.si_matmul(
            x.data_ptr(), _DTYPE_CODES[x.dtype], w.data_ptr(),
            _DTYPE_CODES[w.dtype],
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            _DTYPE_CODES[bias.dtype] if bias is not None else 0,
            out.data_ptr(), _DTYPE_CODES[out_dtype], m, n, k, code, arg,
            mma_block_n(n), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_matmul launch failed with CUDA error {err}"
                           f" (M={m}, N={n}, K={k})")
    launches += 1
    return out


def matmul(x, w, bias=None, activation: Optional[str] = None, *,
           out_dtype=None):
    """out = act(x[M,K] @ w[K,N] + bias[N]); f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return matmul_ref(x, w, bias, activation, out_dtype)
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul weight dtype {w.dtype} is not "
                        f"float32/bfloat16 (int8 goes to matmul_int8w)")
    return _launch(x, w, None, bias, activation, out_dtype)


def matmul_int8w(x, w_q, scale, bias=None, activation: Optional[str] = None,
                 *, out_dtype=None):
    """out = act((x @ w_q) * scale + bias) with w_q int8 [K, N], scale
    f32 [N] — weight-only dequant fused into the epilogue."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return matmul_int8w_ref(x, w_q, scale, bias, activation, out_dtype)
    if w_q.dtype != torch.int8:
        raise TypeError(f"matmul_int8w weight dtype {w_q.dtype} is not int8")
    if scale is None:
        raise ValueError("matmul_int8w needs the per-column scale")
    return _launch(x, w_q, scale, bias, activation, out_dtype)


# output columns of one block of the tensor-core route, and the most K
# slices of its decode route (one thread-block cluster; csrc/matmul_int4w.cu)
INT4W_BLOCK_N = 128
INT4W_MAX_SLICES = 8
_sm_counts: dict = {}


def int4w_decode_splits(n: int, n_groups: int, sms: int) -> int:
    """K slices of the bf16 decode route (M <= 16) for N columns and
    `n_groups` K-groups on a card of `sms` SMs: enough 128-column blocks
    for ~2 per SM, at most INT4W_MAX_SLICES (a cluster), each slice whole
    groups, as even as the groups allow (ceil(n_groups / ceil(n_groups /
    splits)) slices)."""
    tiles = -(-n // INT4W_BLOCK_N)
    want = min(max(-(-2 * sms // tiles), 1), n_groups, INT4W_MAX_SLICES)
    per = -(-n_groups // want)
    return -(-n_groups // per)


def _int4w_splits(x, n, kp2, group) -> int:
    """K slices of the split-K decode route for bf16 x, else 0."""
    if x.dtype != torch.bfloat16 or x.shape[0] > 16 or group % 32 or \
            group & (group - 1):
        return 0
    dev = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return int4w_decode_splits(n, 2 * kp2 // group, _sm_counts[dev])


def matmul_int4w(x, wq4, bias=None, activation: Optional[str] = None, *,
                 out_dtype=None):
    """out = act(x[M,K] @ dequant(wq4) + bias[N]) with wq4 a
    Quantized4Tensor (group-wise nibble-packed int4; see quant/tensor.py
    for the layout the kernel shares). The TPU wrapper's block_m /
    block_n / groups_per_block are its VMEM tile sizes and have no
    counterpart here: the CUDA kernel picks its route from x's dtype,
    the group and M. bf16 x with a group of 32, 64, 128, ... runs on
    the tensor cores, summing each group in f32 before its scale;
    for M <= 16 K is split over `int4w_decode_splits` slices, one
    thread-block cluster, which sum their f32 partials in a fixed order
    through shared memory (reruns are bit-equal)."""
    global launches_int4w
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return matmul_int4w_ref(x, wq4, bias, activation, out_dtype)
    packed, scale = wq4.packed, wq4.scale
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA int4w kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[1] != wq4.k:
        raise ValueError(f"matmul_int4w: x {tuple(x.shape)} does not chain "
                         f"with a weight of logical K={wq4.k}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("matmul_int4w needs int8 packed and f32 scale")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype} is not float32/bfloat16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    if not (x.is_contiguous() and packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, packed and scale must be contiguous")
    m, k = x.shape
    kp2, n = packed.shape
    if (tuple(scale.shape) != (2 * kp2 // wq4.group, n)
            or (2 * kp2) % wq4.group or 2 * kp2 < k):
        raise ValueError(f"packed {tuple(packed.shape)} / scale "
                         f"{tuple(scale.shape)} do not match group "
                         f"{wq4.group} and K={k}")
    if m >= 2 ** 31 or n > 65535 * 32:
        raise ValueError(f"matmul_int4w too large for the kernel: M={m}, "
                         f"N={n}")
    _check_vec("bias", bias, n, (torch.float32, torch.bfloat16), x.device)
    code, arg = _act_code(activation)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = load_library_int4w()
    with torch.cuda.device(x.device):
        err = lib.si_matmul_int4w(
            x.data_ptr(), _DTYPE_CODES[x.dtype], packed.data_ptr(),
            scale.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            _DTYPE_CODES[bias.dtype] if bias is not None else 0,
            out.data_ptr(), _DTYPE_CODES[out_dtype],
            _int4w_splits(x, n, kp2, wq4.group), m, n, k, kp2, wq4.group,
            code, arg,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_matmul_int4w launch failed with CUDA error "
                           f"{err} (M={m}, N={n}, K={k})")
    launches_int4w += 1
    return out


def k_major(w) -> bool:
    """Whether a [K, N] matrix is the view of a contiguous [N, K] tensor
    (strides (1, K)): each column's K values side by side, the layout the
    s8 tensor cores read w in (size-1 dimensions take any stride)."""
    k, n = w.shape
    return (w.stride(0) == 1 or k <= 1) and (w.stride(1) == k or n <= 1)


def to_k_major(w):
    """The same [K, N] matrix laid out K-major (`k_major`), copied only
    when it is not."""
    return w if k_major(w) else w.t().contiguous().t()


def matmul_s8s8(x_q, w_q, scale, bias=None, activation: Optional[str] = None,
                *, out_dtype=torch.bfloat16):
    """out = act(float(x_q[M,K] s8 @ w_q[K,N] s8, summed exactly in s32)
    * scale[N] + bias[N]) — the static-int8 GEMM, with the quant
    semantics of ops/conv.int8_epilogue (scale = act_scale * w_scale per
    output channel, or w_scale alone for folded per-channel activation
    scales; a scalar scale applies to every column). x_q is row-major;
    w_q either layout: the kernel reads it K-major (`k_major`), as
    Engine.place_weights lays out every static-int8 weight, and a
    row-major w_q is copied so first (counted in `transposes_s8s8`). The
    TPU wrapper's block sizes are its VMEM tiles and have no counterpart
    here."""
    global launches_s8s8, transposes_s8s8
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32)
    if x_q.device.type == "cpu":
        return matmul_s8s8_ref(x_q, w_q, scale, bias, activation, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"the CUDA s8s8 kernel needs CUDA tensors, got "
                         f"{x_q.device}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"matmul_s8s8 shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"matmul_s8s8 needs int8 operands, got {x_q.dtype}"
                        f" and {w_q.dtype}")
    if w_q.device != x_q.device:
        raise ValueError(f"w_q is on {w_q.device}, x_q on {x_q.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    if not x_q.is_contiguous():
        raise ValueError("x_q must be contiguous (row-major)")
    m, k = x_q.shape
    n = w_q.shape[1]
    if (m >= 2 ** 31 or k >= 2 ** 31 or n > 65535 * 64
            or -(-m // MMA_BLOCK_M) > 65535):
        raise ValueError(f"matmul_s8s8 too large for the kernel: M={m}, "
                         f"K={k}, N={n}")
    if not k_major(w_q):
        w_q = to_k_major(w_q)
        transposes_s8s8 += 1
    scale = scale.to(x_q.device, torch.float32)
    if scale.ndim == 0:
        scale = scale.expand(n)
    scale = scale.contiguous()
    _check_vec("scale", scale, n, (torch.float32,), x_q.device)
    _check_vec("bias", bias, n, (torch.float32, torch.bfloat16), x_q.device)
    code, arg = _act_code(activation)
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    if m == 0 or n == 0:
        return out
    lib = load_library_s8s8()
    with torch.cuda.device(x_q.device):
        err = lib.si_matmul_s8s8(
            x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            _DTYPE_CODES[bias.dtype] if bias is not None else 0,
            out.data_ptr(), _DTYPE_CODES[out_dtype], m, n, k, code, arg,
            torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_matmul_s8s8 launch failed with CUDA error "
                           f"{err} (M={m}, N={n}, K={k})")
    launches_s8s8 += 1
    return out
