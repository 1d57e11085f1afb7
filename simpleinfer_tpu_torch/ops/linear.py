"""nn.Linear lowering (counterpart of simpleinfer_tpu/ops/linear.py).

The pnnx weight [out, in] is transposed once at load to [in, out], so
the matmul and the kernels stream it in [K, N] order. Leading batch dims
are free; rank-4 operands are physically NHWC of their logical shape and
round-trip through the logical layout (ConvNeXt-style channel MLPs).

With kernels on, weight-only quantized weights go to the CUDA kernels of
kernels/matmul.py with bias and the fused activation in their epilogue:
int8w to `matmul_int8w`, int4w to `matmul_int4w` (the JAX package
dispatches int4w to its kernel without an opt-in; its int8w dispatch
waits for use_pallas). Everything else resolves the weight dense and
runs torch.matmul with f32 bias and activation.

Static int8 (an `act_scale` installed by Engine.calibrate over an int8
weight) quantizes the activation and takes the exact s8 x s8 -> s32
product of kernels/matmul.matmul_s8s8 with the dequant / bias /
activation epilogue (ops/conv.int8_epilogue). The JAX package chooses
between two exact paths there, its Pallas kernel for
min(M, K, N) >= 256 with use_pallas and XLA's s32 einsum below; the
port has one exact path on the card: every static-int8 product goes to
matmul_s8s8 with kernels on, with kernels off to torch._int_mm's s32
product on the card (ops/conv.matmul_s8s8_library; float64 on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_BOOL, PARAM_INT
from ..kernels import matmul as kmm
from ..quant.tensor import (Quantized4Tensor, QuantizedTensor, quantize_act,
                            resolve_weight)
from .conv import int8_epilogue
from .registry import OpImpl, register_op, require_attr, require_param


def linear(x, w, bias=None, activation=None):
    """x [..., in] @ w [in, out] (or a quantized tensor) + bias [out];
    bias and activation in f32, the result at x's dtype."""
    out = torch.matmul(x, resolve_weight(w, x.dtype)).float()
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = kmm.resolve_activation(activation)(out)
    return out.to(x.dtype)


def _linear_act_fold(op):
    """(act_axis, weight_ic_axis) for per-channel activation scales
    (OpImpl.act_fold). The contracted dim is the logical last dim; for
    rank-4 inputs the physical layout is NHWC of the logical NCHW shape
    (ops/shape.py), so logical dim 3 sits at physical axis 2. Unknown
    ranks get no per-channel support (per-tensor fallback)."""
    shape = op.inputs[0].shape if op.inputs else None
    if not shape:
        return None
    rank = len(shape)
    if rank == 4:
        return (2, 0)
    if rank in (2, 3):
        return (-1, 0)
    return None


@register_op("nn.Linear")
def lower_linear(op, cfg):
    in_features = require_param(op, "in_features", PARAM_INT).i
    out_features = require_param(op, "out_features", PARAM_INT).i
    use_bias = require_param(op, "bias", PARAM_BOOL).b

    w = require_attr(op, "weight", 1).array()
    if list(w.shape) != [out_features, in_features]:
        raise ValueError(f"Linear {op.name}: weight shape {w.shape} does not "
                         f"match params")
    weights = {"weight": torch.from_numpy(
        np.ascontiguousarray(w.T).astype(np.float32))}
    if use_bias:
        weights["bias"] = torch.from_numpy(
            require_attr(op, "bias", 1).array().astype(np.float32))

    fused_act = (op.params["si_fused_act"].s
                 if op.has_param("si_fused_act") else None)
    use_kernels = cfg.kernels_enabled

    def apply(weights, x):
        phys4 = x.ndim == 4
        if phys4:
            x = x.permute(0, 3, 1, 2)
        w, bias = weights["weight"], weights.get("bias")
        act_scale = weights.get("act_scale")
        lead = x.shape[:-1]
        if act_scale is not None and isinstance(w, QuantizedTensor):
            # the JAX package's gate min(M, K, N) >= 256 chose its Pallas
            # kernel over XLA's s32 einsum; both are this exact product
            q = quantize_act(x, act_scale).reshape(-1, in_features)
            q = q.contiguous()
            out = int8_epilogue(q, w.data, act_scale, w.scale, bias,
                                fused_act, x.dtype, use_kernels=use_kernels)
            out = out.reshape(*lead, -1)
            return out.permute(0, 2, 3, 1).contiguous() if phys4 else out
        if use_kernels and isinstance(
                w, (QuantizedTensor, Quantized4Tensor)):
            x2 = x.reshape(-1, in_features).contiguous()
            if isinstance(w, Quantized4Tensor):
                out = kmm.matmul_int4w(x2, w, bias, fused_act,
                                       out_dtype=x.dtype)
            else:
                out = kmm.matmul_int8w(x2, w.data, w.scale, bias, fused_act)
            out = out.reshape(*lead, -1)
        else:
            out = linear(x, w, bias, activation=fused_act)
        return out.permute(0, 2, 3, 1).contiguous() if phys4 else out

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"weight": 1},  # [in, out]: out channels on axis 1
        shard_hints={"weight": (None, "model"), "bias": ("model",)},
        # 2*in*out a row, whatever the leading dims (executor.
        # _estimate_flops); the JAX package's flops_per_item counts one
        # row a batch item
        flops_per_element=2 * in_features,
        fp32_keys=("act_scale",),
        act_quant=True,
        act_fold=_linear_act_fold(op),
        s8_weight=True,
    )
