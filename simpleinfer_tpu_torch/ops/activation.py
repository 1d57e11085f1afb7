"""Elementwise activation lowerings (counterpart of
simpleinfer_tpu/ops/activation.py). Each is one PyTorch op; on a bf16
tensor PyTorch computes in f32 internally and rounds once."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import OpImpl, register_op


def relu(x):
    return F.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def silu(x):
    return F.silu(x)


def hard_sigmoid(x):
    # alpha = 1/6, beta = 0.5, as the JAX package
    return torch.clamp(x * (1.0 / 6.0) + 0.5, 0.0, 1.0)


def hard_swish(x):
    return x * hard_sigmoid(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def mish(x):
    return F.mish(x)


def _elementwise(pnnx_type, fn):
    @register_op(pnnx_type)
    def lower(op, cfg, _fn=fn):
        def apply(weights, x):
            return _fn(x)
        return OpImpl(name=op.name, type=op.type, apply=apply)
    return lower


_elementwise("nn.ReLU", relu)
_elementwise("nn.Sigmoid", sigmoid)
_elementwise("nn.SiLU", silu)
_elementwise("nn.Hardsigmoid", hard_sigmoid)
_elementwise("nn.Hardswish", hard_swish)
_elementwise("F.relu", relu)
_elementwise("F.sigmoid", sigmoid)
_elementwise("F.silu", silu)
_elementwise("F.hardsigmoid", hard_sigmoid)
_elementwise("F.hardswish", hard_swish)
_elementwise("nn.ReLU6", relu6)
_elementwise("F.relu6", relu6)
_elementwise("nn.Mish", mish)
_elementwise("F.mish", mish)
