"""LayerNorm and RMSNorm lowerings (inference form), the counterparts of
simpleinfer_tpu/ops/norm.py's. Statistics accumulate in f32 even under
bf16 compute; the result is cast back to the input dtype before the
affine scale, as in the JAX package. Rank-4 operands are physically
NHWC, so they round-trip through the logical NCHW layout. BatchNorm,
GroupNorm and InstanceNorm are not ported yet (BatchNorm reaches the
YOLOv5 path only folded into its conv).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_AINT, PARAM_BOOL, PARAM_FLOAT
from .registry import OpImpl, register_op, require_attr, require_param


def _affine_weights(op, affine, expect_shape):
    if not affine:
        return {}
    gamma = require_attr(op, "weight").array().astype(np.float32)
    beta = require_attr(op, "bias").array().astype(np.float32)
    for name, v in (("weight", gamma), ("bias", beta)):
        if v.shape != expect_shape:
            raise ValueError(f"{op.type} {op.name}: {name} shape "
                             f"{v.shape} != {expect_shape}")
    return {"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)}


def _check_trailing(op, x, shape):
    if tuple(x.shape[-len(shape):]) != shape:
        raise ValueError(
            f"{op.type} {op.name}: input trailing dims "
            f"{tuple(x.shape[-len(shape):])} != normalized_shape {shape}")


@register_op("nn.LayerNorm")
def lower_layer_norm(op, cfg):
    """Normalize over the trailing `normalized_shape` logical dims."""
    shape = tuple(require_param(op, "normalized_shape", PARAM_AINT).ai)
    eps = require_param(op, "eps", PARAM_FLOAT).f
    affine = require_param(op, "elementwise_affine", PARAM_BOOL).b
    weights = _affine_weights(op, affine, shape)
    axes = tuple(range(-len(shape), 0))

    def apply(weights, x):
        phys4 = x.ndim == 4
        if phys4:
            x = x.permute(0, 3, 1, 2)
        _check_trailing(op, x, shape)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
        if affine:
            y = (y * weights["gamma"].to(y.dtype)
                 + weights["beta"].to(y.dtype))
        return y.permute(0, 2, 3, 1).contiguous() if phys4 else y

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights)


@register_op("nn.RMSNorm")
def lower_rms_norm(op, cfg):
    """Root-mean-square norm (llama-style): no mean subtraction,
    optional gamma, over the trailing `normalized_shape` logical dims."""
    shape = tuple(require_param(op, "normalized_shape", PARAM_AINT).ai)
    eps = require_param(op, "eps", PARAM_FLOAT).f
    affine = (op.params["elementwise_affine"].b
              if op.has_param("elementwise_affine", PARAM_BOOL)
              else op.has_attr("weight"))
    axes = tuple(range(-len(shape), 0))
    weights = {}
    if affine:
        g = require_attr(op, "weight").array()
        if tuple(g.shape) != shape:
            raise ValueError(f"RMSNorm {op.name}: weight shape {g.shape} "
                             f"!= normalized_shape {shape}")
        weights["gamma"] = torch.from_numpy(g.astype(np.float32))

    def apply(weights, x):
        phys4 = x.ndim == 4
        if phys4:
            x = x.permute(0, 3, 1, 2)
        _check_trailing(op, x, shape)
        xf = x.float()
        ms = xf.square().mean(dim=axes, keepdim=True)
        y = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
        if affine:
            y = y * weights["gamma"].to(y.dtype)
        return y.permute(0, 2, 3, 1).contiguous() if phys4 else y

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights)
