"""Quantization containers: int8 and group-wise int4 weights, int8
activations.

The counterpart of simpleinfer_tpu/quant/tensor.py: weights are held as
an int8 tensor plus a per-output-channel fp32 scale (`QuantizedTensor`),
or as nibble-packed int4 plus per-(K-group, column) fp32 scales
(`Quantized4Tensor`, the LLM decode serving dtype). Static int8
quantizes activations with `quantize_act`; a chained producer hands its
consumer a `QuantizedActivation`. Weight quantization stays in numpy,
with the same arithmetic as the JAX package, so the bytes and scales
come out equal to the JAX package's. Dequantization
happens either in the plain path (`resolve_weight`) or inside the CUDA
matmul kernels (kernels/matmul.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import matmul as kmm


@dataclass
class QuantizedTensor:
    """int8 data + per-channel fp32 scales along `axis`.

    dequant: ``data.float() * expand(scale, axis)`` reproduces the
    original tensor to within one quantization step (|err| <= scale/2).
    """

    data: torch.Tensor  # int8, same shape as the original
    scale: torch.Tensor  # f32, shape = (original.shape[axis],)
    axis: int  # which axis the scales index

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(data=self.data.to(device),
                               scale=self.scale.to(device), axis=self.axis)

    def k_major(self) -> "QuantizedTensor":
        """The same tensor with its data laid out K-major, the layout of
        the s8 GEMM's weight operand (kernels/matmul.matmul_s8s8): the
        output channels on the last axis, the other axes flattened into
        K, stored as a contiguous [N, K] and viewed in this shape, so
        that `data.reshape(-1, N)` is the [K, N] view with strides
        (1, K). Values, shape and scales are unchanged."""
        nd = self.data.ndim
        if self.axis % nd != nd - 1:
            raise ValueError(f"k_major needs the output channels on the "
                             f"last axis, not axis {self.axis}")
        n = self.data.shape[-1]
        flat = self.data.reshape(-1, n)
        return QuantizedTensor(
            data=flat.t().contiguous().t().reshape(self.data.shape),
            scale=self.scale, axis=self.axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        bshape = [1] * self.data.ndim
        bshape[self.axis] = self.data.shape[self.axis]
        return (self.data.float() * self.scale.reshape(bshape)).to(dtype)


def quantize_per_channel(w, axis: int) -> QuantizedTensor:
    """Symmetric int8 per-channel quantization (abs-max / 127), in numpy
    exactly as simpleinfer_tpu.quant.tensor.quantize_per_channel."""
    w = np.asarray(w, dtype=np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.max(np.abs(w), axis=reduce_axes)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    bshape = [1] * w.ndim
    bshape[axis] = w.shape[axis]
    q = np.clip(np.round(w / scale.reshape(bshape)), -127, 127).astype(np.int8)
    return QuantizedTensor(data=torch.from_numpy(q),
                           scale=torch.from_numpy(scale), axis=axis)


@dataclass
class Quantized4Tensor:
    """Group-wise symmetric INT4 weight (W4 gG), nibble-packed, for 2-D
    [in, out] weights.

    Layout (shared with kernels/matmul.matmul_int4w and the JAX
    package): packed [Kp/2, N] int8 — for group g of `group` K-rows,
    packed rows [g*group/2, (g+1)*group/2) hold logical rows
    [g*group, g*group + group/2) in the high nibble and the second half
    of the group in the low nibble; scale [Kp/group, N] f32. `k` is the
    logical K (rows beyond it are zero padding).
    """

    packed: torch.Tensor  # int8 [Kp/2, N]
    scale: torch.Tensor   # f32 [Kp/group, N]
    group: int
    k: int

    @property
    def shape(self):
        return (self.k, self.packed.shape[1])

    @property
    def ndim(self):
        return 2

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "Quantized4Tensor":
        return Quantized4Tensor(packed=self.packed.to(device),
                                scale=self.scale.to(device),
                                group=self.group, k=self.k)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        p = self.packed.to(torch.int32)   # the sign-extended bytes
        kp2, n = p.shape
        g = self.group
        kg = (2 * kp2) // g
        hi = (p >> 4).reshape(kg, g // 2, n)
        lo = (((p & 0xF) ^ 8) - 8).reshape(kg, g // 2, n)
        wq = torch.cat([hi, lo], dim=1)                  # [kg, g, N]
        s = self.scale.reshape(kg, 1, n)
        return (wq.float() * s).reshape(kg * g, n)[:self.k].to(dtype)


def quantize_int4_grouped(w, group: int = 256) -> Quantized4Tensor:
    """Symmetric group-wise int4 (abs-max / 7) of a 2-D [K, N] weight,
    nibble-packed in the split-halves layout above; in numpy exactly as
    simpleinfer_tpu.quant.tensor.quantize_int4_grouped. K is zero-padded
    to a multiple of `group`."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"int4 weights must be 2-D, got {w.shape}")
    k, n = w.shape
    kp = -(-k // group) * group
    if kp != k:
        w = np.concatenate([w, np.zeros((kp - k, n), np.float32)])
    kg = kp // group
    wg = w.reshape(kg, group, n)
    absmax = np.abs(wg).max(axis=1)                     # [kg, N]
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(wg / scale[:, None, :]), -8, 7).astype(np.int8)
    hi, lo = q[:, :group // 2], q[:, group // 2:]
    packed = ((hi.astype(np.uint8) << 4)
              | (lo.astype(np.uint8) & 0xF)).astype(np.int8)
    return Quantized4Tensor(
        packed=torch.from_numpy(np.ascontiguousarray(
            packed.reshape(kp // 2, n))),
        scale=torch.from_numpy(scale), group=group, k=k)


@dataclass
class QuantizedActivation:
    """An int8 activation flowing between chained static-int8 convs
    (ir/passes.mark_int8_chains): the producer requantized its f32
    epilogue result to the consumer's calibrated scale and wrote 1-byte
    data, and the consumer skips its quantize pass."""

    data: torch.Tensor   # int8
    scale: torch.Tensor  # f32 scalar (the consumer's act_scale)

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale).to(dtype)


def quantize_act(x, scale) -> torch.Tensor:
    """Symmetric int8 quantization of an activation: `scale` is an f32
    scalar (per-tensor) or a vector broadcasting over the channel (last)
    axis (per-channel; the matching factor is folded into the weight).
    Values beyond ±127·scale saturate. Computed as the JAX package does,
    x in f32 times the f32 reciprocal, rounded half to even, so the
    bytes come out equal."""
    q = torch.round(x.float() * (1.0 / scale))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def resolve_weight(w, dtype=torch.float32) -> torch.Tensor:
    """Return a dense tensor for `w`, dequantizing if it is quantized."""
    if isinstance(w, (QuantizedTensor, Quantized4Tensor)):
        return w.dequantize(dtype)
    return w if w.dtype == dtype else w.to(dtype)


def proj_nlo(x, w, dt, use_kernels: bool = True):
    """Decode-path projection: [N, L, I] x weight [I, O] -> [N, L, O] in
    f32 (the caller adds bias and casts). THE int4w chokepoint: with
    kernels on, a Quantized4Tensor streams its packed nibbles through
    kernels/matmul.matmul_int4w with f32 output (on a CPU tensor, its
    plain version); everything else — and int4 with kernels off —
    resolves the weight dense at `dt` and runs torch.matmul."""
    n, l, i = x.shape
    if isinstance(w, Quantized4Tensor) and use_kernels:
        y = kmm.matmul_int4w(x.reshape(n * l, i).contiguous(), w,
                             out_dtype=torch.float32)
        return y.reshape(n, l, -1)
    return torch.matmul(x, resolve_weight(w, dt)).float()
