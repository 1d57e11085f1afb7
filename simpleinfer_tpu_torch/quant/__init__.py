"""Weight-only int8 and group-wise int4 quantization, static int8
activations (`quantize_act`) and their calibration (calibrate.py)."""
from .tensor import (
    Quantized4Tensor,
    QuantizedActivation,
    QuantizedTensor,
    proj_nlo,
    quantize_act,
    quantize_int4_grouped,
    quantize_per_channel,
    resolve_weight,
)

__all__ = ["Quantized4Tensor", "QuantizedActivation", "QuantizedTensor",
           "proj_nlo", "quantize_act", "quantize_int4_grouped",
           "quantize_per_channel", "resolve_weight"]
