"""Weight-only int8 and group-wise int4 quantization (static int8 is not
ported yet)."""
from .tensor import (
    Quantized4Tensor,
    QuantizedTensor,
    proj_nlo,
    quantize_int4_grouped,
    quantize_per_channel,
    resolve_weight,
)

__all__ = ["Quantized4Tensor", "QuantizedTensor", "proj_nlo",
           "quantize_int4_grouped", "quantize_per_channel", "resolve_weight"]
