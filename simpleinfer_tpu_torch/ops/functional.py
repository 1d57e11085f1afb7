"""Functional-form pnnx ops, slicing and inference no-ops (counterpart of
simpleinfer_tpu/ops/functional.py).

pnnx keeps `F.*` calls as operator types of their own beside their
`nn.Module` twins; each reuses its twin's NHWC lowering here:
F.max_pool2d / F.avg_pool2d / F.adaptive_avg_pool2d (ops/pool.py,
ops/extra.avg_pool_2d), F.interpolate and F.upsample* (ops/shape.py's
nearest and bilinear), and the activation aliases of ops/extra.py.

Also here:
- `Tensor.slice`, pnnx's basic-indexing export (`x[:, 1:, ::2]`), in the
  per-dim {dim,start,end,step} form and the folded {dims,starts,ends,
  steps} form; logical NCHW dims land on NHWC storage like torch.cat's;
- `Tensor.expand`, a broadcast without copy (-1 keeps a dim);
- inference no-ops: nn.Identity, nn.Dropout / Dropout2d, F.dropout*,
  Tensor.contiguous and torch.clone are identities at inference.
"""
from __future__ import annotations

from ..ir.graph import (PARAM_AFLOAT, PARAM_AINT, PARAM_BOOL, PARAM_FLOAT,
                        PARAM_INT, PARAM_STR)
from .extra import (_NCHW_TO_NHWC_DIM, avg_pool_2d, lower_elu, lower_gelu,
                    lower_leaky_relu, lower_tanh)
from .pool import adaptive_avg_pool_2d, max_pool_2d
from .registry import OpImpl, register_op, require_param
from .shape import upsample_bilinear, upsample_nearest

# pnnx encodes "slice to the end" as INT_MAX (torch.slice's sentinel)
_INT_MAX = 2**63 - 1


def _pair(p):
    """kernel/stride/padding params arrive as int or [h, w]."""
    if p.type == PARAM_INT:
        return (p.i, p.i)
    return tuple(p.ai)


def _opt_pair(op, key, default):
    if op.has_param(key, PARAM_INT) or op.has_param(key, PARAM_AINT):
        return _pair(op.params[key])
    return default


def _opt_bool(op, key, default):
    return op.params[key].b if op.has_param(key, PARAM_BOOL) else default


# ------------------------------------------------------------ F.pooling
@register_op("F.max_pool2d")
def lower_f_max_pool2d(op, cfg):
    kernel = _pair(require_param(op, "kernel_size"))
    stride = _opt_pair(op, "stride", kernel)
    padding = _opt_pair(op, "padding", (0, 0))
    dilation = _opt_pair(op, "dilation", (1, 1))
    ceil_mode = _opt_bool(op, "ceil_mode", False)

    def apply(weights, x):
        return max_pool_2d(x, kernel, stride, padding, dilation, ceil_mode)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("F.avg_pool2d")
def lower_f_avg_pool2d(op, cfg):
    kernel = _pair(require_param(op, "kernel_size"))
    stride = _opt_pair(op, "stride", kernel)
    padding = _opt_pair(op, "padding", (0, 0))
    ceil_mode = _opt_bool(op, "ceil_mode", False)
    cip = _opt_bool(op, "count_include_pad", True)

    def apply(weights, x):
        return avg_pool_2d(x, kernel, stride, padding, ceil_mode, cip)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("F.adaptive_avg_pool2d")
def lower_f_adaptive_avg_pool2d(op, cfg):
    p = require_param(op, "output_size")
    output_size = (p.i, p.i) if p.type == PARAM_INT else tuple(p.ai)

    def apply(weights, x):
        return adaptive_avg_pool_2d(x, output_size)

    return OpImpl(name=op.name, type=op.type, apply=apply)


# -------------------------------------------------------- F.interpolate
def _interp_args(op):
    """size / scale / mode of F.interpolate and F.upsample*."""
    mode = (op.params["mode"].s
            if op.has_param("mode", PARAM_STR) else "nearest")
    align = (op.params["align_corners"].b
             if op.has_param("align_corners", PARAM_BOOL) else False)
    scale = size = None
    if op.has_param("scale_factor", PARAM_AFLOAT):
        scale = tuple(op.params["scale_factor"].af)
    elif op.has_param("scale_factor", PARAM_FLOAT):
        scale = (op.params["scale_factor"].f,) * 2
    elif op.has_param("size", PARAM_AINT):
        size = tuple(op.params["size"].ai)
    elif op.has_param("size", PARAM_INT):
        size = (op.params["size"].i,) * 2
    return mode, align, scale, size


def _lower_interp(op, mode, align, scale, size):
    if scale is None and size is None:
        raise ValueError(f"{op.type} {op.name}: need scale_factor or size")
    if mode not in ("nearest", "bilinear"):
        # torch's "linear" is for rank-3 (N, C, L): rejected at load
        raise ValueError(f"{op.type} {op.name}: unsupported mode {mode!r}")

    def apply(weights, x):
        if mode == "nearest":
            return upsample_nearest(x, scale=scale, size=size)
        return upsample_bilinear(x, scale=scale, size=size,
                                 align_corners=align)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("F.interpolate")
@register_op("F.upsample")
def lower_f_interpolate(op, cfg):
    return _lower_interp(op, *_interp_args(op))


@register_op("F.upsample_nearest")
def lower_f_upsample_nearest(op, cfg):
    _, _, scale, size = _interp_args(op)
    return _lower_interp(op, "nearest", False, scale, size)


@register_op("F.upsample_bilinear")
def lower_f_upsample_bilinear(op, cfg):
    _, align, scale, size = _interp_args(op)
    return _lower_interp(op, "bilinear", align, scale, size)


# -------------------------------------------------- F.activation forms
register_op("F.leaky_relu")(lower_leaky_relu)
register_op("F.elu")(lower_elu)
register_op("F.gelu")(lower_gelu)
register_op("F.tanh")(lower_tanh)


# -------------------------------------------------------- Tensor.slice
def _norm_bound(v, size, default):
    """torch.slice bound -> concrete [0, size] index (INT_MAX open)."""
    if v is None or v >= _INT_MAX or v <= -_INT_MAX:
        return default
    if v < 0:
        v += size
    return max(0, min(v, size))


@register_op("Tensor.slice")
def lower_tensor_slice(op, cfg):
    if op.has_param("dims", PARAM_AINT):
        dims = list(op.params["dims"].ai)
        starts = list(require_param(op, "starts", PARAM_AINT).ai)
        ends = list(require_param(op, "ends", PARAM_AINT).ai)
        steps = (list(op.params["steps"].ai)
                 if op.has_param("steps", PARAM_AINT) else [1] * len(dims))
    else:
        dims = [require_param(op, "dim", PARAM_INT).i]
        starts = [op.params["start"].i
                  if op.has_param("start", PARAM_INT) else 0]
        ends = [op.params["end"].i
                if op.has_param("end", PARAM_INT) else _INT_MAX]
        steps = [op.params["step"].i
                 if op.has_param("step", PARAM_INT) else 1]

    def apply(weights, x):
        idx = [slice(None)] * x.ndim
        for d, s, e, st in zip(dims, starts, ends, steps):
            if st <= 0:
                raise ValueError(
                    f"slice {op.name}: non-positive step {st} unsupported")
            d = d + x.ndim if d < 0 else d
            if x.ndim == 4:
                d = _NCHW_TO_NHWC_DIM[d]
            size = x.shape[d]
            idx[d] = slice(_norm_bound(s, size, 0),
                           _norm_bound(e, size, size), st)
        return x[tuple(idx)]

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("Tensor.expand")
def lower_tensor_expand(op, cfg):
    shape = list(require_param(op, "shape", PARAM_AINT).ai)

    def apply(weights, x):
        if len(shape) != x.ndim:
            raise ValueError(
                f"expand {op.name}: rank change {x.ndim}->{len(shape)} "
                "unsupported")
        logical = ([x.shape[0], x.shape[3], x.shape[1], x.shape[2]]
                   if x.ndim == 4 else list(x.shape))
        tgt = [logical[i] if s == -1 else s for i, s in enumerate(shape)]
        if x.ndim == 4:  # logical NCHW target -> physical NHWC storage
            tgt = [tgt[0], tgt[2], tgt[3], tgt[1]]
        return x.expand(*tgt)

    return OpImpl(name=op.name, type=op.type, apply=apply)


# --------------------------------------------------- inference no-ops
def _identity(op, cfg):
    return OpImpl(name=op.name, type=op.type, apply=lambda weights, x: x)


for _t in ("nn.Identity", "nn.Dropout", "nn.Dropout2d", "F.dropout",
           "F.dropout2d", "Tensor.contiguous", "torch.clone"):
    register_op(_t)(_identity)
