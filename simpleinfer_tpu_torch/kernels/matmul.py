"""Fused-epilogue GEMM: the hand-written CUDA counterpart of the Pallas
`_matmul_kernel` (simpleinfer_tpu/kernels/matmul.py).

Two entry points with the JAX signatures:
- matmul(x, w, ...)               — dense weights [K, N]
- matmul_int8w(x, w_q, scale, ...) — int8 weights + per-column f32 scale
  (per-OUTPUT-channel symmetric quantization, quant/tensor.py); the
  dequant `acc * scale[n]` is folded into the epilogue.

Both compute ``act((x @ w) * scale? + bias?)`` with f32 accumulation for
any M, N and K, through ONE CUDA kernel (csrc/matmul.cu), templated on
the input, weight and output dtypes. The kernel is built with nvcc for
sm_90a at first use, into `_build/` beside this package, and bound with
ctypes (a plain C interface: no PyTorch headers, so the build takes
seconds).

A wrapper runs its plain PyTorch version (`matmul_ref`,
`matmul_int8w_ref`) only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises; there is no fallback. `launches` counts
the kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "matmul.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


# ---- build and bind -----------------------------------------------------
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA matmul kernel cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def load_library(rebuild: bool = False):
    """Build csrc/matmul.cu with nvcc (once per source and flags, the
    library name carries their hash; `rebuild` builds anew) and bind
    `si_matmul` with ctypes. Raises when nvcc is missing or the build
    fails."""
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libsi_matmul_{tag[:16]}.so"
    t0 = time.perf_counter()
    ptxas = ""
    if rebuild or not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name} (exit "
                f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        ptxas = proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_matmul.argtypes = [vp, ci, vp, ci, vp, vp, ci, vp, ci, ci, ci,
                              ci, ci, ctypes.c_float, vp]
    lib.si_matmul.restype = ci
    build_info.update(library=str(so), seconds=time.perf_counter() - t0,
                      built=bool(ptxas), ptxas=ptxas)
    _lib = lib
    return lib


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
    # the C interface takes int sizes; N tiles ride gridDim.y (<= 65535)
    if m >= 2 ** 31 or k >= 2 ** 31 or n > 65535 * 64:
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
            torch.cuda.current_stream(x.device).cuda_stream)
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
