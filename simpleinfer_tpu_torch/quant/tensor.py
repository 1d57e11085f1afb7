"""Weight-only INT8 quantization container.

The counterpart of simpleinfer_tpu/quant/tensor.py: weights are held as
an int8 tensor plus a per-output-channel fp32 scale. Quantization itself
stays in numpy, with the same arithmetic as the JAX package, so the
bytes and scales come out equal to the JAX package's. Dequantization
happens either in the plain path (`resolve_weight`, before a conv) or in
the CUDA matmul kernel's epilogue (kernels/matmul.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def resolve_weight(w, dtype=torch.float32) -> torch.Tensor:
    """Return a dense tensor for `w`, dequantizing if it is quantized."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype)
    return w if w.dtype == dtype else w.to(dtype)
