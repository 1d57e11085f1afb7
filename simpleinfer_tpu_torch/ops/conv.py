"""nn.Conv2d lowering — NHWC conv (counterpart of simpleinfer_tpu/ops/conv.py).

Params padding_mode / padding / kernel_size / stride / dilation / groups
/ in_channels / out_channels / bias; weight OIHW transformed to HWIO at
load (the JAX package's layout, so weights and quantized bytes compare
one to one); zero / replicate / reflect padding; grouped conv.

Three paths, as in the JAX package minus its TPU layout means (the
W-packed stem/`PackedW` chain):
- pointwise (1x1 s1 p0 d1 g1) int8w convs ARE matmuls: with kernels on
  they run as one launch of kernels/matmul.matmul_int8w on the [N*H*W, C]
  view, dequant + bias + activation in its epilogue;
- convs over a channel concat that ir/passes.fuse_cat_conv1x1 removed
  run as a sum of per-source partial convs (`_apply_split`);
- everything else runs `F.conv2d` on the channels-last NCHW view of the
  NHWC tensor and permutes back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.graph import PARAM_AINT, PARAM_BOOL, PARAM_INT, PARAM_STR
from ..kernels import matmul as kmm
from ..quant.tensor import QuantizedTensor, resolve_weight
from .registry import OpImpl, register_op, require_attr, require_param


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x, w, bias=None, *, stride=(1, 1), padding=((0, 0), (0, 0)),
                dilation=(1, 1), groups=1, padding_mode="zeros",
                activation=None):
    """Functional NHWC conv.

    `w` is HWIO (or a QuantizedTensor of it); `padding` is
    ((top, bottom), (left, right)); `activation` is an optional fused
    epilogue name (kernels/matmul.resolve_activation). Runs in x's dtype
    (TF32 is the caller's to switch off; Engine.forward does in fp32).
    """
    w = resolve_weight(w, x.dtype)
    xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    (pt, pb), (pl, pr) = padding
    if padding_mode != "zeros":
        xn = F.pad(xn, (pl, pr, pt, pb), mode=padding_mode)
        pad = (0, 0)
    elif pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xn = F.pad(xn, (pl, pr, pt, pb))
        pad = (0, 0)
    b = None if bias is None else bias.to(x.dtype)
    out = F.conv2d(xn, _oihw(w), b, tuple(stride), pad, tuple(dilation),
                   groups)
    if activation is not None:
        out = kmm.resolve_activation(activation)(out)
    return _nhwc(out)


@register_op("nn.Conv2d")
def lower_conv2d(op, cfg):
    padding_mode = require_param(op, "padding_mode", PARAM_STR).s
    if padding_mode not in ("zeros", "replicate", "reflect"):
        raise ValueError(f"Conv2d {op.name}: unsupported padding_mode "
                         f"{padding_mode!r}")
    padding = require_param(op, "padding", PARAM_AINT).ai
    kernel = require_param(op, "kernel_size", PARAM_AINT).ai
    stride = require_param(op, "stride", PARAM_AINT).ai
    dilation = require_param(op, "dilation", PARAM_AINT).ai
    groups = require_param(op, "groups", PARAM_INT).i
    in_channels = require_param(op, "in_channels", PARAM_INT).i
    out_channels = require_param(op, "out_channels", PARAM_INT).i
    use_bias = require_param(op, "bias", PARAM_BOOL).b

    w = require_attr(op, "weight", 1).array()  # OIHW fp32
    if list(w.shape) != [out_channels, in_channels // groups, *kernel]:
        raise ValueError(f"Conv2d {op.name}: weight shape {w.shape} does not "
                         f"match params")
    w_hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
    weights = {"weight": torch.from_numpy(w_hwio.astype(np.float32))}
    if use_bias:
        b = require_attr(op, "bias", 1).array()
        weights["bias"] = torch.from_numpy(b.astype(np.float32))

    pad = ((padding[0], padding[0]), (padding[1], padding[1]))
    stride_t, dilation_t = tuple(stride), tuple(dilation)
    fused_act = (op.params["si_fused_act"].s
                 if op.has_param("si_fused_act") else None)
    pointwise = (tuple(kernel) == (1, 1) and stride_t == (1, 1)
                 and pad == ((0, 0), (0, 0)) and dilation_t == (1, 1)
                 and groups == 1)
    use_kernels = cfg.kernels_enabled
    cat_inputs = op.has_param("si_cat_inputs")

    def _apply_split(weights, xs):
        """conv1x1 over a (never materialized) channel concat: slice the
        weight per source and sum the partial convs. See
        ir/passes.fuse_cat_conv1x1."""
        w, bias = weights["weight"], weights.get("bias")
        dtype = xs[0].dtype
        wd = resolve_weight(w, dtype)  # dequant once, slice per source
        # partial sums carry at the compute dtype in bf16 mode (each conv
        # accumulates its own K in f32); the final sum is f32
        acc, ofs = None, 0
        for i, x in enumerate(xs):
            c = x.shape[-1]
            y = F.conv2d(x.permute(0, 3, 1, 2), _oihw(wd[:, :, ofs:ofs + c]))
            ofs += c
            if acc is None:
                acc = y
            elif i == len(xs) - 1:
                acc = acc.float() + y.float()
            else:
                acc = acc + y
        acc = acc.permute(0, 2, 3, 1)  # NHWC view: channels last
        if bias is not None:
            acc = acc + bias.float()
        if fused_act is not None:
            acc = kmm.resolve_activation(fused_act)(acc)
        return acc.to(dtype).contiguous()

    def apply(weights, *xs):
        if cat_inputs and len(xs) > 1:
            return _apply_split(weights, list(xs))
        (x,) = xs
        w, bias = weights["weight"], weights.get("bias")
        if pointwise and use_kernels and isinstance(w, QuantizedTensor):
            n, h, wd, c = x.shape
            out = kmm.matmul_int8w(
                x.reshape(n * h * wd, c),
                w.data.reshape(c, out_channels),  # HWIO 1x1 -> [K, N]
                w.scale, bias, fused_act)
            return out.reshape(n, h, wd, out_channels)
        return conv2d_nhwc(
            x, w, bias,
            stride=stride_t, padding=pad, dilation=dilation_t,
            groups=groups, padding_mode=padding_mode,
            activation=fused_act)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"weight": 3},  # HWIO: out channels on axis 3
    )
