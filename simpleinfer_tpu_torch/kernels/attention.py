"""Flash attention (online softmax): the hand-written CUDA counterpart of
the Pallas `_flash_kernel` (simpleinfer_tpu/kernels/attention.py).

`flash_attention(q, k, v, causal=..., scale=..., sliding_window=...)`
over [B, H, L, D] (or [BH, L, D]) inputs streams K/V tiles through
shared memory and keeps a running max, sum and accumulator per query
row in f32, so the [Lq, Lk] scores never reach device memory; with
`sliding_window` only the key tiles the band touches are read. The
kernel (csrc/flash_attention.cu) is built with nvcc for sm_90a at first
use and bound with ctypes (kernels/build.py). Inputs may be strided
views as long as the head dim is contiguous: the rotary-attention op
passes the [N, L, H, D] projections transposed, and the output is laid
out [B, L, H, D] under its [B, H, L, D] view, so the op's merge of the
heads is free.

`flash_attention_ref` is the plain PyTorch version (the CPU path and the
on-card oracle): one f32 softmax over the masked scores, P rounded to
the input dtype before P·V, as in the JAX oracle. A query row with no
live key gives 0 in both (the JAX oracle's softmax gives NaN there).

The dispatch gates `flash_profitable` / `flash_band_profitable` keep
the JAX package's env knobs. The causal Lk (`FLASH_MIN_LK`) and the band
gate's Lk (`FLASH_BAND_MIN_LK`, with no limit on the band's width) were
measured on the H100; the non-causal Lk (4096) and the Lq (256) are
still the JAX package's TPU values.

`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from . import build

launches = 0

SOURCE = "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# widest head_dim the kernel's register accumulator takes
MAX_HEAD_DIM = 256


# the causal gate's least Lk (SI_FLASH_MIN_LK overrides it): on an H100
# the tensor-core kernel beats the unblocked path at every L measured,
# from 256 up (chip_smoke.flash_gate_sweep), and the JAX package's gate
# never goes below 256 either
FLASH_MIN_LK = 256


def flash_profitable(lq: int, lk: int, causal: bool = True) -> bool:
    """Sequence-length dispatch gate for the flash kernel: causal
    Lk >= FLASH_MIN_LK (measured on the H100), non-causal Lk >= 4096 and
    Lq >= 256 (the JAX package's thresholds); SI_FLASH_MIN_LK /
    SI_FLASH_MIN_LK_NC / SI_FLASH_MIN_LQ override them, read at call
    time."""
    if causal:
        min_lk = int(os.environ.get("SI_FLASH_MIN_LK", FLASH_MIN_LK))
    else:
        min_lk = int(os.environ.get("SI_FLASH_MIN_LK_NC", "4096"))
    min_lq = int(os.environ.get("SI_FLASH_MIN_LQ", "256"))
    return lk >= min_lk and lq >= min_lq


# the band gate: Lk >= FLASH_BAND_MIN_LK, at any band. On an H100 the
# banded kernel beats the port's banded torch path (which builds all L^2
# scores) at every L from 512 to 4096 and every band from 256 to 1024
# below L, by 15x to 134x (chip_smoke.band_gate_sweep, [4, 32, L, 64]
# bf16); the JAX package's TPU gate was Lk >= 1536 and a band of at most
# Lk / 4
FLASH_BAND_MIN_LK = 512


def flash_band_profitable(lq: int, lk: int,
                          sliding_window: int | None) -> bool:
    """Dispatch gate for the banded kernel: a band, Lk >=
    FLASH_BAND_MIN_LK and Lq >= 256; SI_FLASH_BAND_MIN_LK /
    SI_FLASH_BAND_MIN_LQ override the lengths, read at call time."""
    if sliding_window is None:
        return False
    min_lk = int(os.environ.get("SI_FLASH_BAND_MIN_LK", FLASH_BAND_MIN_LK))
    min_lq = int(os.environ.get("SI_FLASH_BAND_MIN_LQ", "256"))
    return lk >= min_lk and lq >= min_lq


def _check_args(q, k, causal, sliding_window):
    if causal and q.shape[-2] != k.shape[-2]:
        raise ValueError(
            f"flash_attention causal requires Lq == Lk, got "
            f"{q.shape[-2]} != {k.shape[-2]} (the alignment convention "
            f"would silently diverge from the unblocked attention)")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal=True")
        if sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {sliding_window}")
        if sliding_window >= k.shape[-2]:
            sliding_window = None      # band wider than L = plain causal
    return sliding_window


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        scale: float | None = None,
                        sliding_window: int | None = None):
    """Unblocked oracle: f32 scores and softmax, bottom-right causal
    alignment (as the JAX oracle), P at the input dtype for P·V; rows
    with no live key give 0."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # in place on the one [.., Lq, Lk] f32 buffer: the main path's
    # prefill (16 rows x 32 heads x 2048^2) holds 8.6 GB of scores
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        ones = torch.ones((lq, lk), dtype=torch.bool, device=s.device)
        keep = torch.tril(ones, diagonal=lk - lq)
        if sliding_window is not None:
            keep &= torch.triu(ones, diagonal=lk - lq - sliding_window + 1)
        s.masked_fill_(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    s.sub_(torch.where(torch.isinf(m), 0.0, m)).exp_()
    l = s.sum(dim=-1, keepdim=True)
    s.div_(torch.where(l > 0, l, 1.0))     # a row with no live key: 0
    return torch.matmul(s.to(q.dtype), v)


def _bind(lib):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.si_flash_attention.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
        cl, cl, cl, cl, cl, cl, cl, cl, cl, cl, cl, cl,
        ci, ci, ctypes.c_float, vp]
    lib.si_flash_attention.restype = ci


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/flash_attention.cu (built at first
    use)."""
    return build.load(SOURCE, _bind, rebuild)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None,
                    sliding_window: int | None = None):
    """Online-softmax attention over [B, H, L, D] (or [BH, L, D]) inputs.

    Causal masking requires Lq == Lk (query i attends keys <= i).
    sliding_window=W bands the causal mask to the last W positions
    (key j live for query i iff i-W < j <= i, the window includes
    self); a band at least as wide as L is plain causal. The TPU
    wrapper's block_q / block_k are its VMEM tile sizes and have no
    counterpart here. bf16 inputs on the card run on the tensor cores
    (128 queries x 64 keys a tile, P rounded to bf16 for P·V, as the TPU
    body does) and take scale > 0; f32 inputs keep P in f32.
    """
    global launches
    sliding_window = _check_args(q, k, causal, sliding_window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash kernel needs CUDA tensors, got "
                         f"{q.device}")
    rank3 = q.ndim == 3
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError("flash_attention takes [B, H, L, D] or [BH, L, D]")
    q4, k4, v4 = ((t.unsqueeze(0) if rank3 else t) for t in (q, k, v))
    b, h, lq, d = q4.shape
    lk = k4.shape[2]
    if tuple(k4.shape) != (b, h, lk, d) or tuple(v4.shape) != (b, h, lk, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    for name, t in (("k", k4), ("v", v4)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} is not float32/bfloat16")
    if d > MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} or B*H {b * h} "
                         f"> 65535")
    if any(t.stride(3) != 1 for t in (q4, k4, v4)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if rank3:
        out = torch.empty((1, h, lq, d), dtype=q.dtype, device=q.device)
    else:   # [B, L, H, D] memory under the [B, H, L, D] view
        out = torch.empty((b, lq, h, d), dtype=q.dtype,
                          device=q.device).permute(0, 2, 1, 3)
    if lq == 0 or b * h == 0:
        return out[0] if rank3 else out
    strides = []
    for t in (q4, k4, v4, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.si_flash_attention(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, lq, lk, d, *strides,
            int(causal), int(sliding_window or 0), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_flash_attention launch failed with CUDA "
                           f"error {err} (B={b}, H={h}, Lq={lq}, Lk={lk}, "
                           f"D={d})")
    launches += 1
    return out[0] if rank3 else out
