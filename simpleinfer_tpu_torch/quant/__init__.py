"""Weight-only INT8 quantization (static int8 is not ported yet)."""
from .tensor import QuantizedTensor, quantize_per_channel, resolve_weight

__all__ = ["QuantizedTensor", "quantize_per_channel", "resolve_weight"]
