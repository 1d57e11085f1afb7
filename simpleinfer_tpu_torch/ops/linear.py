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
runs torch.matmul with f32 bias and activation. Static int8 (an
`act_scale` weight) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_BOOL, PARAM_INT
from ..kernels import matmul as kmm
from ..quant.tensor import Quantized4Tensor, QuantizedTensor, resolve_weight
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
        if "act_scale" in weights:
            raise NotImplementedError(
                f"Linear {op.name}: static int8 is not ported yet")
        lead = x.shape[:-1]
        if use_kernels and isinstance(
                w, (QuantizedTensor, Quantized4Tensor)):
            x2 = x.reshape(-1, in_features).contiguous()
            if isinstance(w, Quantized4Tensor):
                out = kmm.matmul_int4w(x2, w, bias, fused_act,
                                       out_dtype=x.dtype)
            else:
                out = kmm.matmul_int8w(x2, w.data, w.scale, bias, fused_act)
            out = out.reshape(*lead, out_features)
        else:
            out = linear(x, w, bias, activation=fused_act)
        return out.permute(0, 2, 3, 1).contiguous() if phys4 else out

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"weight": 1},  # [in, out]: out channels on axis 1
    )
