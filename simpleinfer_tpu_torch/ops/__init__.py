"""Operator lowerings: pnnx type string -> OpImpl (weights + torch fn).

Importing this package registers every ported lowering: the op types a
fused YOLOv5 graph uses (nn.Conv2d, BinaryOp, nn.MaxPool2d, nn.Upsample,
torch.cat, models.yolo.Detect) and their file-mates.
"""
from . import activation, binary, conv, pool, shape, yolo  # noqa: F401
from .registry import (
    OpImpl,
    UnsupportedOpError,
    get_lowering,
    lower_operator,
    register_op,
    registered_ops,
)

__all__ = [
    "OpImpl",
    "UnsupportedOpError",
    "get_lowering",
    "lower_operator",
    "register_op",
    "registered_ops",
]
