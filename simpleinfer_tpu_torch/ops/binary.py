"""BinaryOp / UnaryOp lowerings (ncnn op-code convention), the
counterpart of simpleinfer_tpu/ops/binary.py. Broadcasting follows
PyTorch's (= NumPy's) rules."""
from __future__ import annotations

import torch

from .registry import OpImpl, register_op, require_param
from ..ir.graph import PARAM_INT

# ncnn BinaryOp op codes (expand_expression.cpp:190-200)
_BINARY_FNS = {
    0: torch.add,
    1: torch.sub,
    2: torch.mul,
    3: torch.div,
    4: torch.maximum,
    5: torch.minimum,
    6: torch.pow,
    7: lambda a, b: torch.sub(b, a),    # rsub (scalar first)
    8: lambda a, b: torch.div(b, a),    # rdiv
    9: lambda a, b: torch.pow(b, a),    # rpow
    10: torch.atan2,
    11: lambda a, b: torch.atan2(b, a),  # ratan2
}

# ncnn UnaryOp op codes (expand_expression.cpp:140-160)
_UNARY_FNS = {
    0: torch.abs,
    1: torch.neg,
    2: torch.floor,
    3: torch.ceil,
    4: torch.square,
    5: torch.sqrt,
    6: torch.rsqrt,
    7: torch.exp,
    8: torch.log,
    9: torch.sin,
    10: torch.cos,
    11: torch.tan,
    12: torch.asin,
    13: torch.acos,
    14: torch.atan,
    15: torch.reciprocal,
    16: torch.tanh,
    17: torch.log10,
}


@register_op("BinaryOp")
def lower_binary_op(op, cfg):
    code = require_param(op, "0", PARAM_INT).i
    fn = _BINARY_FNS.get(code)
    if fn is None:
        raise ValueError(f"BinaryOp {op.name}: unsupported op code {code}")

    with_scalar = op.has_param("1") and op.params["1"].i == 1
    if with_scalar:
        scalar = float(op.params["2"].f)
        # the scalar binds as the SECOND operand (reversed codes 7-9, 11
        # have the swap built in), rounded to the tensor's dtype like the
        # JAX package's jnp.asarray(s, x.dtype); a 0-d CPU tensor mixes
        # with a tensor on any device
        consts: dict = {}

        def apply(weights, x, _fn=fn):
            s = consts.get(x.dtype)
            if s is None:
                s = consts[x.dtype] = torch.tensor(scalar, dtype=x.dtype)
            return _fn(x, s)
    else:
        def apply(weights, a, b, _fn=fn):
            return _fn(a, b)

    return OpImpl(name=op.name, type=op.type, apply=apply)


@register_op("UnaryOp")
def lower_unary_op(op, cfg):
    code = require_param(op, "0", PARAM_INT).i
    fn = _UNARY_FNS.get(code)
    if fn is None:
        raise ValueError(f"UnaryOp {op.name}: unsupported op code {code}")

    def apply(weights, x, _fn=fn):
        return _fn(x)

    return OpImpl(name=op.name, type=op.type, apply=apply)
