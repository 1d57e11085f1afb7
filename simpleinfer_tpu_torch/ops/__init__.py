"""Operator lowerings: pnnx type string -> OpImpl (weights + torch fn).

Importing this package registers every ported lowering: the op types a
fused YOLOv5 graph uses (nn.Conv2d, BinaryOp, nn.MaxPool2d, nn.Upsample,
torch.cat, models.yolo.Detect, and si.FusedC3 with c3_fusion), those of a
llama graph (nn.Embedding, nn.RMSNorm, si.RotaryAttention, nn.Linear,
nn.SiLU), the transformer ops of ops/attention.py (nn.MultiheadAttention,
F.scaled_dot_product_attention, torch.matmul / bmm / select), those of
the CNN classification and segmentation builders
(nn.BatchNorm2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d, torch.flatten,
nn.ConvTranspose2d) and their file-mates: the rest of ops/norm.py,
ops/extra.py and ops/functional.py.
"""
from . import (  # noqa: F401
    activation,
    attention,
    binary,
    c3,
    conv,
    extra,
    functional,
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
