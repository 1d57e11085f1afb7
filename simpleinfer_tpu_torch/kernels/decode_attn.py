"""Per-row-length KV-cache decode attention: the hand-written CUDA
counterpart of the Pallas `_decode_kernel`
(simpleinfer_tpu/kernels/decode_attn.py).

`decode_attention(q, k_leaf, v_leaf, lengths, scale=...)` attends one
query per (row, query head) over the frozen cache positions
< lengths[row], reading only those positions (per-row lengths: a young
row stays cheap next to an old one), and returns the UNNORMALIZED
online-softmax partial (o, m, l) so the caller
(zoo/generate.CachedDecoder._attn_decode_scratch) merges it with the
current decode block's scratch keys. int8 cache leaves come as
(int8 values, [N, KV, L, 1] f32 scales) and are dequantized in
registers: the scales fold onto the scores and the probabilities.

The kernel (csrc/decode_attention.cu) is built with nvcc for sm_90a at
first use and bound with ctypes (kernels/build.py). It splits each
(row, kv head) over `decode_splits` blocks along the cache positions;
each block derives its share from the row's length on the device (the
host never reads the lengths), and the last of a row's blocks to finish
merges their partials in split order, so reruns are bit-equal. The
splits meet in a scratch buffer and a counter per row that the kernel
leaves at 0 (`_counters`, one buffer per device: launches on one device
must not overlap, as they do not on one stream).
`decode_attention_ref` is the plain PyTorch version (the CPU path and
the on-card oracle), the JAX oracle's math: dequantize, mask, one
softmax pass. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import build

launches = 0

SOURCE = "decode_attention.cu"
# finite "minus infinity": exp(_NEG - x) underflows to exact 0.0 for any
# finite x while never producing inf - inf = NaN in the merges
_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# blocks sharing one (row, kv head)
MAX_SPLITS = 8
# cache positions per split at the full bound, by default: 4 blocks a
# (row, kv head) at the llama service's window of 2048, the fastest of
# 1 to 16 on an H100 (PERF.md)
SPLIT_POSITIONS = 512


def decode_splits(bound: int, per_split: int = SPLIT_POSITIONS) -> int:
    """Blocks per (row, kv head) for a read bounded by `bound` cache
    positions: one per `per_split` positions of the bound, at most
    MAX_SPLITS. Fixed at launch from the bound alone, so a decode step
    needs nothing from the device."""
    return max(1, min(MAX_SPLITS, -(-int(bound) // int(per_split))))


def _split(k_leaf, v_leaf):
    """(k, k scales or None, v, v scales or None) of a cache leaf pair."""
    if isinstance(k_leaf, tuple):
        return k_leaf[0], k_leaf[1], v_leaf[0], v_leaf[1]
    return k_leaf, None, v_leaf, None


def decode_attention_ref(q, k_leaf, v_leaf, lengths, *, scale: float):
    """Unblocked oracle of decode_attention with the same (o, m, l)
    contract: o [N,KV,G,D], m and l [N,KV,G,1], all f32."""
    k, ks, v, vs = _split(k_leaf, v_leaf)
    k = k.float() * ks if ks is not None else k.float()
    v = v.float() * vs if vs is not None else v.float()
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * scale  # [N,KV,G,L]
    idx = torch.arange(s.shape[-1], device=s.device)
    live = idx < torch.as_tensor(lengths, device=s.device).reshape(
        -1, 1, 1, 1)
    s = torch.where(live, s, _NEG)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v), m, l


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.si_decode_attention.argtypes = [
        vp, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
        ci, ci, ci, ctypes.c_float, vp]
    lib.si_decode_attention.restype = ci


# the split counters of each device (int32, zero between launches: the
# kernel returns each to 0), grown on demand
_count_buffers: dict = {}


def _counters(device, n: int):
    buf = _count_buffers.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _count_buffers[device] = buf
    return buf


def load_library(rebuild: bool = False):
    """The ctypes library of csrc/decode_attention.cu (built at first
    use)."""
    return build.load(SOURCE, _bind, rebuild)


def decode_attention(q, k_leaf, v_leaf, lengths, *, scale: float,
                     block_k: int | None = None,
                     max_len: int | None = None):
    """Unnormalized decode attention over the frozen KV cache.

    q: [N, KV, G, D] (query heads grouped under their kv head, the
    repeat_kv order); k_leaf / v_leaf: [N, KV, L, D] tensors (f32/bf16)
    or (int8 values, [N, KV, L, 1] f32 scales) tuples; lengths: [N]
    int32, row n attends cache positions < lengths[n] (0 = nothing:
    o = 0, l = 0, m = -1e30).

    Returns (o [N,KV,G,D] = sum exp(s-m) v, m [N,KV,G,1],
    l [N,KV,G,1]), all f32; o/l is the normalized context when nothing
    else merges in.

    block_k: cache positions per split at the full bound (default 512,
    or SI_DECODE_ATTN_BLOCK): the launch splits each (row, kv head) over
    `decode_splits(bound, block_k)` blocks, which share the row's live
    positions evenly. max_len: bound on the occupied prefix — rows read
    at most max_len positions (the caller guarantees every live row's
    length fits). A cache row's bytes (D times the dtype's size) may be
    at most 512 (256 for int8).
    """
    global launches
    if q.device.type == "cpu":
        if max_len is not None:   # the kernel's truncated read
            lengths = torch.clamp(torch.as_tensor(lengths), max=int(max_len))
        return decode_attention_ref(q, k_leaf, v_leaf, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    if block_k is None:
        block_k = int(os.environ.get("SI_DECODE_ATTN_BLOCK",
                                     str(SPLIT_POSITIONS)))
    k, ks, v, vs = _split(k_leaf, v_leaf)
    n, kvh, g, d = q.shape
    length = k.shape[2]
    if tuple(k.shape) != (n, kvh, length, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match")
    quant = ks is not None
    if quant:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError("quantized cache leaves must be int8")
        for t in (ks, vs):
            if (tuple(t.shape) != (n, kvh, length, 1)
                    or t.dtype != torch.float32):
                raise ValueError("int8 cache scales must be f32 "
                                 "[N, KV, L, 1]")
    elif k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"cache dtype {k.dtype} is not float32/bfloat16")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} is not float32/bfloat16")
    tensors = [q, k, v] + ([ks, vs] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q and the cache must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q and the cache leaves must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the cache leaves must be 16-byte aligned")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    if d * k.element_size() > (256 if quant else 512):
        raise ValueError(f"head_dim {d} of {k.dtype} is wider than the "
                         f"kernel's {256 if quant else 512}-byte row")
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if tuple(lens.shape) != (n,):
        raise ValueError(f"lengths must be [{n}], got {tuple(lens.shape)}")
    bound = length if max_len is None else min(int(max_len), length)
    o = torch.empty((n, kvh, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((n, kvh, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((n, kvh, g, 1), dtype=torch.float32, device=q.device)
    if n * kvh == 0:
        return o, m, l
    lib = load_library()
    splits = decode_splits(bound, block_k)
    part = count = None
    if splits > 1:   # [rows x head groups of <= 8][splits][8][D + 2]
        groups = n * kvh * -(-g // 8)
        part = torch.empty(groups * splits * 8 * (d + 2),
                           dtype=torch.float32, device=q.device)
        count = _counters(q.device, groups)
    with torch.cuda.device(q.device):
        err = lib.si_decode_attention(
            q.data_ptr(), _DTYPE_CODES[q.dtype], k.data_ptr(),
            ks.data_ptr() if quant else None, v.data_ptr(),
            vs.data_ptr() if quant else None, _DTYPE_CODES[k.dtype],
            lens.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(),
            n, kvh, g, length, d, bound, splits, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_decode_attention launch failed with CUDA "
                           f"error {err} (N={n}, KV={kvh}, G={g}, L={length}"
                           f", D={d})")
    launches += 1
    return o, m, l
