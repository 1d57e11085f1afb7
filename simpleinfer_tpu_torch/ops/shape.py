"""Shape/layout lowerings: torch.cat, torch.flatten, nn.Upsample (the
counterpart of simpleinfer_tpu/ops/shape.py).

Operands of rank 4 are stored NHWC, so logical NCHW dim arguments are
remapped to physical NHWC dims:

- Cat: dim 1->3, 2->1, 3->2.
- Flatten: permute NHWC back to NCHW first so the flat element order
  matches PyTorch, then reshape.
- Upsample: nearest (source index = trunc(out_coord * (1/scale)),
  clamped; integer factors as a broadcast) and bilinear (both
  align_corners modes), with `scale_factor` or `size`.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import OpImpl, register_op, require_param
from ..ir.graph import PARAM_INT

_NCHW_TO_NHWC_DIM = {0: 0, 1: 3, 2: 1, 3: 2}


@register_op("torch.cat")
def lower_cat(op, cfg):
    dim = require_param(op, "dim", PARAM_INT).i

    def apply(weights, *inputs):
        d = dim
        rank = inputs[0].ndim
        if d < 0:
            d += rank
        if rank == 4:
            d = _NCHW_TO_NHWC_DIM[d]
        return torch.cat(inputs, dim=d)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("torch.flatten")
def lower_flatten(op, cfg):
    start_dim = require_param(op, "start_dim", PARAM_INT).i
    end_dim = require_param(op, "end_dim", PARAM_INT).i

    def apply(weights, x):
        rank = x.ndim
        s = start_dim + rank if start_dim < 0 else start_dim
        e = end_dim + rank if end_dim < 0 else end_dim
        if rank == 4:
            x = x.permute(0, 3, 1, 2)  # match PyTorch's NCHW flat order
        return torch.flatten(x, s, e)

    return OpImpl(name=op.name, type=op.type, apply=apply)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def upsample_nearest(x, scale=None, size=None):
    """NHWC nearest upsample; index = trunc(out * 1/scale), clamped."""
    n, h, w, c = x.shape
    if size is not None:
        oh, ow = size
        sh_inv, sw_inv = h / oh, w / ow
    else:
        sh, sw = scale
        oh, ow = int(h * sh), int(w * sw)
        sh_inv, sw_inv = 1.0 / sh, 1.0 / sw
    # integer upscale (the YOLO FPN 2x case): out[i,j] = x[i//f, j//f],
    # identical to the trunc-clamp index map below when both divide
    if oh % h == 0 and ow % w == 0 and (oh > h or ow > w):
        fh, fw = oh // h, ow // w
        out = x[:, :, None, :, None, :].expand(n, h, fh, w, fw, c)
        return out.reshape(n, oh, ow, c)
    h_idx = np.clip((np.arange(oh) * sh_inv).astype(np.int32), 0, h - 1)
    w_idx = np.clip((np.arange(ow) * sw_inv).astype(np.int32), 0, w - 1)
    x = torch.index_select(x, 1, _index(h_idx, x.device))
    return torch.index_select(x, 2, _index(w_idx, x.device))


def _linear_axis(x, axis, out_size, align_corners):
    """1-D linear interpolation along `axis` (torch F.interpolate
    semantics for both align_corners modes)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if align_corners and out_size > 1:
        pos = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        pos = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    lo = np.clip(np.floor(pos), 0, in_size - 1).astype(np.int32)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    bshape = [1] * x.ndim
    bshape[axis] = out_size
    t = torch.from_numpy(frac).reshape(bshape).to(x.device, x.dtype)
    a = torch.index_select(x, axis, _index(lo, x.device))
    b = torch.index_select(x, axis, _index(hi, x.device))
    return a * (1 - t) + b * t


def upsample_bilinear(x, scale=None, size=None, align_corners=False):
    """NHWC bilinear upsample."""
    n, h, w, c = x.shape
    if size is not None:
        oh, ow = size
    else:
        oh, ow = int(h * scale[0]), int(w * scale[1])
    x = _linear_axis(x, 1, oh, align_corners)
    return _linear_axis(x, 2, ow, align_corners)


@register_op("nn.Upsample")
def lower_upsample(op, cfg):
    mode = require_param(op, "mode").s
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"Upsample {op.name}: unsupported mode {mode!r}")
    align_corners = (op.params["align_corners"].b
                     if op.has_param("align_corners", 1) else False)
    scale = size = None
    if op.has_param("scale_factor", 6):
        scale = tuple(op.params["scale_factor"].af)
    elif op.has_param("scale_factor", 3):
        scale = (op.params["scale_factor"].f,) * 2
    elif op.has_param("size", 5):
        size = tuple(op.params["size"].ai)
    elif op.has_param("size", 2):
        size = (op.params["size"].i,) * 2
    else:
        raise ValueError(f"Upsample {op.name}: need scale_factor or size")

    def apply(weights, x):
        if mode == "nearest":
            return upsample_nearest(x, scale=scale, size=size)
        return upsample_bilinear(x, scale=scale, size=size,
                                 align_corners=align_corners)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.UpsamplingNearest2d")
def lower_upsampling_nearest_2d(op, cfg):
    scale = size = None
    if op.has_param("scale_factor", 6):
        scale = tuple(op.params["scale_factor"].af)
    elif op.has_param("size", 5):
        size = tuple(op.params["size"].ai)
    else:
        raise ValueError(f"UpsamplingNearest2d {op.name}: need scale or size")

    def apply(weights, x):
        return upsample_nearest(x, scale=scale, size=size)

    return OpImpl(name=op.name, type=op.type, apply=apply)
