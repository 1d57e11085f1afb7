"""Engine configuration of the PyTorch/CUDA port.

The counterpart of simpleinfer_tpu/config.py's `EngineConfig`, carrying
the fields that say WHAT is computed (dtype policy, weight-only int8,
I/O layout, load-time fusions, u8 input scaling) plus the torch device
the engine runs on. The TPU-only fields (mesh, tp_mode, device_index,
compilation_cache_dir, donate_inputs, input_layout,
xla_compiler_options) change how the work is laid out on a TPU, not its
result, and are not carried.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NOT_PORTED_QUANT = ("int8", "int4w")


@dataclass(frozen=True)
class EngineConfig:
    # "float32" (the parity mode: TF32 off for convs and matmuls) or
    # "bfloat16" (the production mode)
    compute_dtype: str = "float32"
    # None (keep weights at compute dtype) or "int8w" (weight-only int8,
    # per-output-channel scales). "int8" (static) and "int4w" are not
    # ported yet.
    quant: Optional[str] = None
    # layout of arrays the USER passes to input()/gets from extract():
    # "nhwc" or "nchw" (the engine permutes at the boundary)
    io_layout: str = "nhwc"
    # run load-time graph fusions (conv+bn fold, conv+activation tagging,
    # cat-split of pointwise convs; ir/passes.py)
    fuse: bool = True
    # the fused whole-C3 kernel of the JAX package; not ported yet
    c3_fusion: bool = False
    # hand-written kernels for eligible ops (pointwise int8w convs run
    # through kernels/matmul.matmul_int8w): the counterpart of the JAX
    # package's `EngineConfig.use_pallas`. None = on when the device is
    # CUDA. use_pallas defaults off because of a TPU v5e measurement,
    # which says nothing about Hopper. On a CPU device the kernels'
    # wrappers run their plain PyTorch versions.
    use_kernels: Optional[bool] = None
    # uint8 inputs are shipped raw and scaled on the device by this factor
    u8_scale: float = 1.0 / 255.0
    # torch device string; the entry points run on CUDA unless the
    # caller asks for the CPU (tests pass device="cpu")
    device: str = "cuda"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if self.quant in _NOT_PORTED_QUANT:
            raise NotImplementedError(
                f"quant={self.quant!r} is not ported yet; use None or "
                f"'int8w'")
        if self.quant not in (None, "int8w"):
            raise ValueError("quant must be None or 'int8w'")
        if self.c3_fusion:
            raise NotImplementedError("c3_fusion is not ported yet")
        if self.io_layout not in ("nhwc", "nchw"):
            raise ValueError("io_layout must be 'nhwc' or 'nchw'")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError("device must be a CUDA or CPU device")

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    @property
    def kernels_enabled(self) -> bool:
        if self.use_kernels is None:
            return self.torch_device.type == "cuda"
        return bool(self.use_kernels)
