"""Pooling lowerings: nn.MaxPool2d, nn.AdaptiveAvgPool2d (counterpart of
simpleinfer_tpu/ops/pool.py). Tensors are NHWC; PyTorch's pools run on
the channels-last NCHW view and permute back.

- MaxPool2d: window max with -inf padding; ceil_mode follows PyTorch (the
  last window must start inside the padded input), as the JAX package's
  extended bottom/right padding does.
- AdaptiveAvgPool2d: requires divisible input/output spatial dims, with
  a global-pool fast path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import OpImpl, register_op, require_param
from ..ir.graph import PARAM_AINT, PARAM_BOOL


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def max_pool_2d(x, kernel, stride, padding, dilation=(1, 1),
                ceil_mode=False):
    """NHWC max pool; padding is (pad_h, pad_w) symmetric like torch."""
    return _nhwc(F.max_pool2d(_nchw(x), tuple(kernel), tuple(stride),
                              tuple(padding), tuple(dilation),
                              ceil_mode=ceil_mode))


def adaptive_avg_pool_2d(x, output_size):
    """NHWC adaptive average pool; in/out spatial dims must divide."""
    oh, ow = output_size
    n, h, w, c = x.shape
    if oh == 1 and ow == 1:
        return torch.mean(x, dim=(1, 2), keepdim=True)
    if h % oh != 0 or w % ow != 0:
        raise ValueError(
            f"AdaptiveAvgPool2d: input spatial ({h},{w}) not divisible by "
            f"output ({oh},{ow})")
    kh, kw = h // oh, w // ow
    return _nhwc(F.avg_pool2d(_nchw(x), (kh, kw), (kh, kw)))


@register_op("nn.MaxPool2d")
def lower_max_pool_2d(op, cfg):
    ceil_mode = require_param(op, "ceil_mode", PARAM_BOOL).b
    require_param(op, "return_indices", PARAM_BOOL)
    padding = tuple(require_param(op, "padding", PARAM_AINT).ai)
    kernel = tuple(require_param(op, "kernel_size", PARAM_AINT).ai)
    stride = tuple(require_param(op, "stride", PARAM_AINT).ai)
    dilation = tuple(require_param(op, "dilation", PARAM_AINT).ai)

    def apply(weights, x):
        return max_pool_2d(x, kernel, stride, padding, dilation, ceil_mode)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("nn.AdaptiveAvgPool2d")
def lower_adaptive_avg_pool_2d(op, cfg):
    output_size = tuple(require_param(op, "output_size", PARAM_AINT).ai)

    def apply(weights, x):
        return adaptive_avg_pool_2d(x, output_size)

    return OpImpl(name=op.name, type=op.type, apply=apply)
