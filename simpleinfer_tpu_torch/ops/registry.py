"""Operator lowering registry.

The counterpart of simpleinfer_tpu/ops/registry.py: pnnx type strings
map to *lowering functions*. A lowering inspects a pnnx Operator at load
time, performs weight layout transforms (e.g. OIHW->HWIO), and returns
an OpImpl — a plain function on torch tensors plus its weights — which
the executor runs in topological order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ir.graph import Operator


@dataclass
class OpImpl:
    """A lowered operator: weights + an apply function.

    apply(weights_dict, *input_tensors) -> output tensor (or tuple when
    n_outputs > 1). Rank-4 tensors are NHWC.
    """

    name: str
    type: str
    apply: Callable
    weights: dict = field(default_factory=dict)
    n_outputs: int = 1
    # weight key -> axis holding output channels, for per-channel
    # weight-only int8 quantization (quant/tensor.py)
    quantizable: dict = field(default_factory=dict)
    # weight keys that must STAY float32 even when the engine casts
    # weights to a lower compute dtype (e.g. YOLO grids: box coordinates
    # lose pixels in bf16)
    fp32_keys: tuple = ()
    # op can consume int8-quantized activations (static quant): the
    # calibration observer (quant/calibrate.py) records its input
    # activation range, and Engine.calibrate installs an `act_scale`
    # weight entry that switches apply onto the s8 path
    act_quant: bool = False
    # int8-chain producer: name of the consumer op whose calibrated
    # act_scale this op requantizes its output to (Engine.calibrate
    # installs `out_scale` from it); None = not a chain producer
    q_out_consumer: Optional[str] = None
    # per-CHANNEL activation quantization (EngineConfig.act_per_channel):
    # (act_axis, weight_ic_axis) — the channel axis of the physical
    # activation the observer sees, and the weight axis the per-channel
    # scales fold into at install (engine._install_act_scales), so the
    # s8 epilogue dequant stays one per-OUT-channel vector. None =
    # per-tensor scales only.
    act_fold: Optional[tuple] = None
    # the static-int8 route (an `act_scale` installed) reads the op's
    # quantized `weight` as the [K, N] operand of kernels/matmul.
    # matmul_s8s8: Engine.place_weights then lays it out K-major once
    # (QuantizedTensor.k_major), as the s8 tensor cores read it
    s8_weight: bool = False
    # head geometry of attention ops, read by zoo/generate.CachedDecoder
    decode_info: Optional[dict] = None


class UnsupportedOpError(Exception):
    """Raised when a graph references an op type with no lowering."""


_LOWERINGS: dict[str, Callable] = {}


def register_op(pnnx_type: str):
    def deco(fn: Callable):
        _LOWERINGS[pnnx_type] = fn
        return fn
    return deco


def get_lowering(pnnx_type: str) -> Callable:
    fn = _LOWERINGS.get(pnnx_type)
    if fn is None:
        raise UnsupportedOpError(
            f"no lowering registered for op type {pnnx_type!r}; "
            f"known: {sorted(_LOWERINGS)}")
    return fn


def registered_ops() -> list[str]:
    return sorted(_LOWERINGS)


def lower_operator(op: Operator, cfg) -> OpImpl:
    return get_lowering(op.type)(op, cfg)


# ---- param helpers (strict, like the reference's CheckParam/CheckAttr) --
def require_param(op: Operator, key: str, ptype: Optional[int] = None):
    if not op.has_param(key, ptype):
        raise ValueError(
            f"{op.type} {op.name!r}: missing/mistyped param {key!r} "
            f"(expected type {ptype})")
    return op.params[key]


def require_attr(op: Operator, key: str, atype: Optional[int] = None):
    if not op.has_attr(key, atype):
        raise ValueError(
            f"{op.type} {op.name!r}: missing/mistyped attr {key!r}")
    return op.attrs[key]
