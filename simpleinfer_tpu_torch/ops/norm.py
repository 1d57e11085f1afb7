"""Normalization lowerings (inference form), the counterparts of
simpleinfer_tpu/ops/norm.py's.

- BatchNorm2d: the four per-channel vectors fold at load, in float64 as
  the JAX package folds them, into one f32 scale + shift pair (so both
  packages hold the same bits); `y = x * scale + shift` over the NHWC
  channel dim. Most BNs never reach this op (ir/passes.fuse_conv_bn
  folds a BN that follows a conv); DenseNet's pre-activation BN follows
  a cat and runs here.
- LayerNorm, GroupNorm, InstanceNorm2d (per-instance statistics, or the
  running ones folded like BatchNorm when the op carries them) and
  RMSNorm: statistics accumulate in f32 even under bf16 compute; the
  normalized value is cast back to the input dtype before the affine
  scale, as in the JAX package. LayerNorm / RMSNorm take logical trailing
  dims, so rank-4 operands (physically NHWC) round-trip through NCHW.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_AINT, PARAM_BOOL, PARAM_FLOAT, PARAM_INT
from .registry import OpImpl, register_op, require_attr, require_param


def _fold_scale_shift(gamma, beta, mean, var, eps):
    """y = x * scale + shift of an inference BN, folded in float64 and
    stored f32 (the JAX package's arithmetic, bit for bit)."""
    scale = gamma / np.sqrt(var + eps)
    shift = beta - mean * scale
    return {"scale": torch.from_numpy(scale.astype(np.float32)),
            "shift": torch.from_numpy(shift.astype(np.float32))}


def _apply_scale_shift(weights, x):
    return (x * weights["scale"].to(x.dtype)
            + weights["shift"].to(x.dtype))


def _normalize(x, dims, eps):
    """(x - mean) / sqrt(var + eps) over `dims`, stats in f32, the result
    at x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


def _affine(weights, y):
    return y * weights["gamma"].to(y.dtype) + weights["beta"].to(y.dtype)


@register_op("nn.BatchNorm2d")
def lower_batch_norm_2d(op, cfg):
    eps = require_param(op, "eps", PARAM_FLOAT).f
    num_features = require_param(op, "num_features", PARAM_INT).i
    require_param(op, "affine", PARAM_BOOL)
    vecs = {}
    for name in ("running_mean", "running_var", "weight", "bias"):
        v = require_attr(op, name, 1).array().astype(np.float64)
        if v.shape != (num_features,):
            raise ValueError(f"BatchNorm2d {op.name}: {name} shape {v.shape} "
                             f"!= ({num_features},)")
        vecs[name] = v
    weights = _fold_scale_shift(vecs["weight"], vecs["bias"],
                                vecs["running_mean"], vecs["running_var"],
                                eps)
    return OpImpl(name=op.name, type=op.type, apply=_apply_scale_shift,
                  weights=weights)


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


@register_op("nn.GroupNorm")
def lower_group_norm(op, cfg):
    groups = require_param(op, "num_groups", PARAM_INT).i
    channels = require_param(op, "num_channels", PARAM_INT).i
    eps = require_param(op, "eps", PARAM_FLOAT).f
    affine = require_param(op, "affine", PARAM_BOOL).b
    if channels % groups:
        raise ValueError(f"GroupNorm {op.name}: num_channels {channels} "
                         f"not divisible by num_groups {groups}")
    weights = _affine_weights(op, affine, (channels,))

    def apply(weights, x):
        # NHWC: split the (last) channel dim into groups, reduce the
        # spatial dims and the channels of a group
        n, spatial = x.shape[0], tuple(x.shape[1:-1])
        xg = x.reshape((n,) + spatial + (groups, channels // groups))
        dims = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        y = _normalize(xg, dims, eps).reshape(x.shape)
        return _affine(weights, y) if affine else y

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights)


@register_op("nn.InstanceNorm2d")
def lower_instance_norm_2d(op, cfg):
    features = require_param(op, "num_features", PARAM_INT).i
    eps = require_param(op, "eps", PARAM_FLOAT).f
    affine = require_param(op, "affine", PARAM_BOOL).b
    weights = _affine_weights(op, affine, (features,))
    if op.has_attr("running_mean"):
        # track_running_stats at eval uses the running statistics:
        # BatchNorm's semantics, folded the same way
        mean = require_attr(op, "running_mean").array().astype(np.float64)
        var = require_attr(op, "running_var").array().astype(np.float64)
        if mean.shape != (features,) or var.shape != (features,):
            raise ValueError(
                f"InstanceNorm2d {op.name}: running stats shapes "
                f"{mean.shape}/{var.shape} != ({features},)")
        gamma = (weights["gamma"].numpy().astype(np.float64) if affine
                 else np.ones(features))
        beta = (weights["beta"].numpy().astype(np.float64) if affine
                else np.zeros(features))
        return OpImpl(name=op.name, type=op.type, apply=_apply_scale_shift,
                      weights=_fold_scale_shift(gamma, beta, mean, var, eps))

    def apply(weights, x):
        y = _normalize(x, (1, 2), eps)   # per (N, C) over NHWC H, W
        return _affine(weights, y) if affine else y

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights)


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
        y = _normalize(x, axes, eps)
        if affine:
            y = _affine(weights, y)
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
