"""Operator lowerings: pnnx type string -> OpImpl (weights + torch fn).

Importing this package registers every ported lowering: the op types a
fused YOLOv5 graph uses (nn.Conv2d, BinaryOp, nn.MaxPool2d, nn.Upsample,
torch.cat, models.yolo.Detect, and si.FusedC3 with c3_fusion), those of a llama graph (nn.Embedding,
nn.RMSNorm, si.RotaryAttention, nn.Linear, nn.SiLU) and their
file-mates.
"""
from . import (  # noqa: F401
    activation,
    attention,
    binary,
    c3,
    conv,
    linear,
    norm,
    pool,
    shape,
    yolo,
)
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
