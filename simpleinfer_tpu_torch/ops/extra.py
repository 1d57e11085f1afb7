"""The extended op set beyond the reference's layers (counterpart of
simpleinfer_tpu/ops/extra.py): average pool, chunk / split, permute /
transpose / reshape / squeeze / unsqueeze, more activations, PReLU,
ConvTranspose2d, pnnx.Attribute constants, reductions, stack, softmax,
clamp and padding.

Rank-4 operands are stored NHWC while pnnx dim / shape arguments are
logical NCHW, so every op here remaps at the boundary: a dim argument
maps 1->3, 2->1, 3->2 (`_NCHW_TO_NHWC_DIM`), and ops whose result
depends on the element order (permute, reshape, squeeze, stack, F.pad)
run on the logical NCHW view and store the result physical again.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.graph import (PARAM_AINT, PARAM_BOOL, PARAM_FLOAT, PARAM_INT,
                        PARAM_STR)
from ..quant.tensor import resolve_weight
from .conv import _pad_index
from .registry import OpImpl, register_op, require_attr, require_param

_NCHW_TO_NHWC_DIM = {0: 0, 1: 3, 2: 1, 3: 2}
# physical NHWC axis -> logical NCHW dim (the inverse)
_NHWC_TO_NCHW_DIM = {0: 0, 1: 2, 2: 3, 3: 1}


def _to_logical(x):
    """Physical NHWC -> logical NCHW for rank 4 (no-op otherwise)."""
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _to_physical(x):
    return x.permute(0, 2, 3, 1).contiguous() if x.ndim == 4 else x


def _phys_dim(dim, ndim):
    d = dim + ndim if dim < 0 else dim
    return _NCHW_TO_NHWC_DIM[d] if ndim == 4 else d


def _opt_float(op, key):
    """Optional numeric param: float or int value, absent / None -> None
    (pnnx writes unset optionals as `key=None`)."""
    if op.has_param(key, PARAM_FLOAT):
        return op.params[key].f
    if op.has_param(key, PARAM_INT):
        return float(op.params[key].i)
    return None


# ------------------------------------------------------------- avg pool
def avg_pool_2d(x, kernel, stride, padding, ceil_mode=False,
                count_include_pad=True):
    """NHWC average pool with torch semantics (ceil_mode clips the last
    window to the padded input; count_include_pad counts the symmetric
    padding but not the ceil overhang), on the channels-last NCHW view."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(kernel), tuple(stride),
                     tuple(padding), ceil_mode=ceil_mode,
                     count_include_pad=count_include_pad)
    return y.permute(0, 2, 3, 1).contiguous()


@register_op("nn.AvgPool2d")
def lower_avg_pool_2d(op, cfg):
    kernel = tuple(require_param(op, "kernel_size", PARAM_AINT).ai)
    stride = tuple(op.params["stride"].ai) if op.has_param(
        "stride", PARAM_AINT) else kernel
    padding = tuple(op.params["padding"].ai) if op.has_param(
        "padding", PARAM_AINT) else (0, 0)
    ceil_mode = (op.params["ceil_mode"].b
                 if op.has_param("ceil_mode", PARAM_BOOL) else False)
    cip = (op.params["count_include_pad"].b
           if op.has_param("count_include_pad", PARAM_BOOL) else True)

    def apply(weights, x):
        return avg_pool_2d(x, kernel, stride, padding, ceil_mode, cip)

    return OpImpl(name=op.name, type=op.type, apply=apply)


# -------------------------------------------------------- chunk / split
@register_op("torch.chunk")
def lower_chunk(op, cfg):
    chunks = require_param(op, "chunks", PARAM_INT).i
    dim = require_param(op, "dim", PARAM_INT).i
    n_declared = len(op.outputs) or chunks

    def apply(weights, x):
        d = _phys_dim(dim, x.ndim)
        size = x.shape[d]
        per = -(-size // chunks)  # torch: ceil split
        n_eff = -(-size // per)   # torch returns FEWER chunks when the
        if n_eff != n_declared:   # ceil split exhausts the dim early
            raise ValueError(
                f"chunk {op.name}: dim size {size} yields {n_eff} chunks "
                f"of {per}, but the graph declares {n_declared} outputs")
        return tuple(x.narrow(d, i * per, min(per, size - i * per))
                     for i in range(n_eff))

    return OpImpl(name=op.name, type=op.type, apply=apply,
                  n_outputs=n_declared)


@register_op("torch.split")
def lower_split(op, cfg):
    dim = require_param(op, "dim", PARAM_INT).i
    p = op.params.get("split_size_or_sections")
    if p is None:
        raise ValueError(f"split {op.name}: missing split_size_or_sections")
    sections = list(p.ai) if p.type == PARAM_AINT else p.i

    def apply(weights, x):
        d = _phys_dim(dim, x.ndim)
        size = x.shape[d]
        if isinstance(sections, int):
            bounds = list(range(sections, size, sections))
        else:
            bounds = np.cumsum(sections)[:-1].tolist()
        starts, ends = [0] + bounds, bounds + [size]
        return tuple(x.narrow(d, s, e - s) for s, e in zip(starts, ends))

    return OpImpl(name=op.name, type=op.type, apply=apply,
                  n_outputs=len(op.outputs))


# ----------------------------------------------------- permute / reshape
@register_op("torch.permute")
def lower_permute(op, cfg):
    dims = tuple(require_param(op, "dims", PARAM_AINT).ai)

    def apply(weights, x):
        return _to_physical(_to_logical(x).permute(dims))

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("torch.transpose")
def lower_transpose(op, cfg):
    d0 = require_param(op, "dim0", PARAM_INT).i
    d1 = require_param(op, "dim1", PARAM_INT).i

    def apply(weights, x):
        return _to_physical(_to_logical(x).transpose(d0, d1))

    return OpImpl(name=op.name, type=op.type, apply=apply)


def _reshape_logical(x, shape):
    return _to_physical(_to_logical(x).reshape([int(s) for s in shape]))


def _lower_reshape(op, cfg):
    shape = require_param(op, "shape", PARAM_AINT).ai

    def apply(weights, x):
        return _reshape_logical(x, shape)

    return OpImpl(name=op.name, type=op.type, apply=apply)


for _t in ("torch.reshape", "Tensor.reshape", "Tensor.view"):
    register_op(_t)(_lower_reshape)


@register_op("torch.unsqueeze")
def lower_unsqueeze(op, cfg):
    dim = require_param(op, "dim", PARAM_INT).i

    def apply(weights, x):
        return _to_physical(_to_logical(x).unsqueeze(dim))

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("torch.squeeze")
def lower_squeeze(op, cfg):
    def apply(weights, x):
        y = _to_logical(x)
        if op.has_param("dim", PARAM_INT):
            d = op.params["dim"].i
            if y.shape[d] != 1:   # jnp.squeeze raises where torch no-ops
                raise ValueError(f"squeeze {op.name}: dim {d} has size "
                                 f"{y.shape[d]}")
            y = y.squeeze(d)
        else:
            y = y.squeeze()
        return _to_physical(y)

    return OpImpl(name=op.name, type=op.type, apply=apply)


# ------------------------------------------------------- more activations
@register_op("nn.LeakyReLU")
def lower_leaky_relu(op, cfg):
    slope = (op.params["negative_slope"].f
             if op.has_param("negative_slope", PARAM_FLOAT) else 0.01)

    def apply(weights, x):
        return torch.where(x >= 0, x, x * slope)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.ELU")
def lower_elu(op, cfg):
    alpha = (op.params["alpha"].f
             if op.has_param("alpha", PARAM_FLOAT) else 1.0)

    def apply(weights, x):
        return torch.where(x > 0, x, alpha * torch.expm1(x))

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.GELU")
def lower_gelu(op, cfg):
    # pnnx/torch `approximate` param: "none" (exact, default) or "tanh"
    approx = (op.params["approximate"].s
              if op.has_param("approximate") else "none")
    approx = "tanh" if approx == "tanh" else "none"

    def apply(weights, x):
        return F.gelu(x, approximate=approx)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.Tanh")
def lower_tanh(op, cfg):
    def apply(weights, x):
        return torch.tanh(x)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.PReLU")
def lower_prelu(op, cfg):
    require_param(op, "num_parameters", PARAM_INT)
    w = require_attr(op, "weight", 1).array().astype(np.float32)

    def apply(weights, x):
        a = weights["slope"].to(x.dtype)  # [C] broadcast on NHWC last
        return torch.where(x >= 0, x, x * a)

    return OpImpl(name=op.name, type=op.type, apply=apply,
                  weights={"slope": torch.from_numpy(w)})


# -------------------------------------------------------- conv transpose
@register_op("nn.ConvTranspose2d")
def lower_conv_transpose_2d(op, cfg):
    """The JAX package flips the IOHW weight at load into an HWIO kernel
    for its lhs-dilated conv; the port keeps that weight (same key and
    layout, so quantization and convert.py line up one to one) and turns
    it back into torch's IOHW for F.conv_transpose2d, which computes the
    same transposed conv. f32 bias, result at x's dtype."""
    in_channels = require_param(op, "in_channels", PARAM_INT).i
    out_channels = require_param(op, "out_channels", PARAM_INT).i
    kernel = require_param(op, "kernel_size", PARAM_AINT).ai
    stride = tuple(require_param(op, "stride", PARAM_AINT).ai)
    padding = tuple(require_param(op, "padding", PARAM_AINT).ai)
    output_padding = tuple(op.params["output_padding"].ai
                           if op.has_param("output_padding", PARAM_AINT)
                           else (0, 0))
    dilation = tuple(op.params["dilation"].ai
                     if op.has_param("dilation", PARAM_AINT) else (1, 1))
    groups = require_param(op, "groups", PARAM_INT).i
    use_bias = require_param(op, "bias", PARAM_BOOL).b
    if groups != 1:
        raise ValueError(f"ConvTranspose2d {op.name}: groups>1 unsupported")

    w = require_attr(op, "weight", 1).array()  # IOHW [ic, oc, kh, kw]
    if list(w.shape) != [in_channels, out_channels, *kernel]:
        raise ValueError(f"ConvTranspose2d {op.name}: weight shape "
                         f"{w.shape} does not match params")
    w_t = np.ascontiguousarray(
        np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))).astype(np.float32)
    weights = {"weight": torch.from_numpy(w_t)}
    if use_bias:
        weights["bias"] = torch.from_numpy(
            require_attr(op, "bias", 1).array().astype(np.float32))

    def apply(weights, x):
        wt = resolve_weight(weights["weight"], x.dtype)  # flipped HWIO
        w_iohw = wt.permute(2, 3, 0, 1).flip(2, 3)
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_iohw, None,
                                 stride, padding, output_padding, 1,
                                 dilation).float()
        bias = weights.get("bias")
        if bias is not None:
            out = out + bias.float()[:, None, None]
        return out.to(x.dtype).permute(0, 2, 3, 1).contiguous()

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights,
                  quantizable={"weight": 3},  # HWIO: oc on axis 3
                  shard_hints={"weight": (None, None, None, "model"),
                               "bias": ("model",)},
                  flops_per_pixel=(2 * in_channels * out_channels
                                   * kernel[0] * kernel[1]))


# ------------------------------------------------------------- constants
@register_op("pnnx.Attribute")
def lower_pnnx_attribute(op, cfg):
    """Constant-tensor operator: the single attr holds the data; rank-4
    constants are NCHW on disk like operands and stored NHWC here."""
    if len(op.attrs) != 1:
        raise ValueError(f"pnnx.Attribute {op.name}: expected exactly one "
                         f"attr, got {list(op.attrs)}")
    (arr,) = [a.array() for a in op.attrs.values()]
    if arr.ndim == 4:
        arr = np.transpose(arr, (0, 2, 3, 1))

    def apply(weights, *unused):
        return weights["value"]

    return OpImpl(name=op.name, type=op.type, apply=apply,
                  weights={"value": torch.from_numpy(
                      np.ascontiguousarray(arr))})


# ------------------------------------------------------ reductions/stack
def _reduce_nchw(x, dims_logical, keepdim, reducer):
    """Reduce over LOGICAL NCHW dims on physical-NHWC rank-4 storage.
    Without keepdim the surviving axes come out in logical order (a mean
    over H of [N,C,H,W] is [N,C,W], where reducing physical axis 1 of
    NHWC leaves [N,W,C])."""
    ds = [d + x.ndim if d < 0 else d for d in dims_logical]
    if x.ndim != 4:
        out = reducer(x, ds, keepdim)
        # a rank transition onto rank 4 lands physical NHWC
        return _to_physical(out) if out.ndim == 4 else out
    phys = [_NCHW_TO_NHWC_DIM[d] for d in ds]
    out = reducer(x, phys, keepdim)
    if keepdim:
        return out  # still rank-4 physical NHWC
    survivors = [a for a in range(4) if a not in phys]
    logical = [_NHWC_TO_NCHW_DIM[a] for a in survivors]
    perm = sorted(range(len(logical)), key=lambda i: logical[i])
    if perm != list(range(len(perm))):
        out = out.permute(perm)
    return out


def _lower_reduction(reducer):
    def lower(op, cfg):
        dims = require_param(op, "dim", PARAM_AINT).ai
        keepdim = (op.params["keepdim"].b
                   if op.has_param("keepdim", PARAM_BOOL) else False)

        def apply(weights, x):
            return _reduce_nchw(x, dims, keepdim, reducer)

        return OpImpl(name=op.name, type=op.type, apply=apply)
    return lower


register_op("torch.mean")(_lower_reduction(
    lambda v, ds, kd: v.mean(dim=ds, keepdim=kd)))
register_op("torch.sum")(_lower_reduction(
    lambda v, ds, kd: v.sum(dim=ds, keepdim=kd)))
register_op("torch.amax")(_lower_reduction(
    lambda v, ds, kd: v.amax(dim=ds, keepdim=kd)))


@register_op("torch.stack")
def lower_stack(op, cfg):
    dim = require_param(op, "dim", PARAM_INT).i

    def apply(weights, *inputs):
        out_rank = inputs[0].ndim + 1
        d = dim + out_rank if dim < 0 else dim
        if inputs[0].ndim == 4:
            # physical inputs -> logical; the 5-D result stays logical
            return torch.stack([_to_logical(x) for x in inputs], dim=d)
        return _to_physical(torch.stack(list(inputs), dim=d))

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.Softmax")
def lower_softmax(op, cfg):
    """Softmax over a LOGICAL dim (rank-4 operands are physical NHWC)."""
    dim = require_param(op, "dim", PARAM_INT).i

    def apply(weights, x):
        return torch.softmax(x, dim=_phys_dim(dim, x.ndim))

    return OpImpl(name=op.name, type=op.type, apply=apply)


register_op("F.softmax")(lower_softmax)


@register_op("torch.clamp")
def lower_clamp(op, cfg):
    lo = _opt_float(op, "min")
    hi = _opt_float(op, "max")

    def apply(weights, x):
        if lo is None and hi is None:
            return x
        return torch.clamp(x, lo, hi)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.ZeroPad2d")
def lower_zero_pad_2d(op, cfg):
    """padding = [left, right, top, bottom] (torch order), onto the
    physical NHWC W and H dims."""
    left, right, top, bottom = (
        int(v) for v in require_param(op, "padding", PARAM_AINT).ai)

    def apply(weights, x):
        return F.pad(x, (0, 0, left, right, top, bottom))

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("F.pad")
def lower_f_pad(op, cfg):
    """Constant / replicate / reflect pad; `pad` pairs run from the LAST
    logical dim inward (torch semantics). Replicate and reflect gather
    each padded dim by index (numpy's modes, as the JAX package's
    jnp.pad), so any rank and any padded dim work."""
    pad = [int(v) for v in require_param(op, "pad", PARAM_AINT).ai]
    mode = (op.params["mode"].s if op.has_param("mode", PARAM_STR)
            else "constant")
    value = _opt_float(op, "value") or 0.0
    if mode not in ("constant", "replicate", "reflect"):
        raise ValueError(f"F.pad {op.name}: unsupported mode {mode!r}")

    def apply(weights, x):
        y = _to_logical(x)
        if mode == "constant":
            return _to_physical(F.pad(y, pad, value=value))
        for i in range(len(pad) // 2):
            d = y.ndim - 1 - i
            before, after = pad[2 * i], pad[2 * i + 1]
            if before or after:
                idx = _pad_index(y.shape[d], before, after, mode, y.device)
                y = y.index_select(d, idx)
        return _to_physical(y)

    return OpImpl(name=op.name, type=op.type, apply=apply)
