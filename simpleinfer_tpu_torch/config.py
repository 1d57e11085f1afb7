"""Engine configuration of the PyTorch/CUDA port.

The counterpart of simpleinfer_tpu/config.py's `EngineConfig`, carrying
the fields that say WHAT is computed (dtype policy, weight-only int8
and int4, static int8 and its calibration, I/O layout, load-time
fusions, the C3 collapse, u8 input scaling), the device mesh and the
tensor-parallel mode (`mesh`, `tp_mode`: one rank per device under
torch.distributed, parallel/), plus the torch device the engine runs
on. The JAX package's `device_index=i` is the port's
`device=f"cuda:{i}"`. The XLA-only fields (compilation_cache_dir,
donate_inputs, input_layout, xla_compiler_options) change how XLA
compiles the work, not its result, and are not carried.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: data x spatial x model parallel axes.

    The axis sizes multiply to the device count, one torch.distributed
    rank per device: `data` shards the batch dim of activations,
    `model` shards conv / linear output channels and attention heads
    (tensor parallelism), and `spatial` shards the activation HEIGHT
    dim, the CNN analog of sequence parallelism (the convs and pools
    exchange halo rows with their neighbours). Use `spatial` when batch
    alone cannot fill the mesh (batch-1 latency, very large images).
    The JAX package's mesh is one process over all devices with XLA
    placing the collectives; here every rank runs the same program on
    its shard and the walk calls the collectives (parallel/mesh.py).
    """

    data: int = 1
    model: int = 1
    spatial: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.spatial


@dataclass(frozen=True)
class EngineConfig:
    # "float32" (the parity mode: TF32 off for convs and matmuls) or
    # "bfloat16" (the production mode)
    compute_dtype: str = "float32"
    # None (keep weights at compute dtype), "int8w" (weight-only int8,
    # per-output-channel scales), "int8" (static full int8: weights
    # per-channel + activations per-tensor or per-channel; needs
    # Engine.calibrate() or load_calibration(), until which convs run
    # the weight-only path; s8 x s8 products go through
    # kernels/matmul.matmul_s8s8) or "int4w" (weight-only group-wise
    # int4 of 2-D [in, out] weights, the LLM decode serving dtype,
    # through kernels/matmul.matmul_int4w; 4-D conv weights fall back to
    # int8)
    quant: Optional[str] = None
    # int4w quantization group size along the weight's K dim (one scale
    # row per group)
    int4_group: int = 128
    # activation calibration observer: None = abs-max, or a percentile
    # of |x| in (0, 100) (outliers then saturate in quantize_act)
    act_clip_percentile: Optional[float] = None
    # per-CHANNEL activation scales (quant="int8"): ops that can fold
    # (OpImpl.act_fold) calibrate one scale per input channel, folded
    # into the quantized weight at install, so the s8 epilogue stays one
    # per-out-channel dequant; chain requant is off on such consumers
    act_per_channel: bool = False
    # (the JAX package's int8_min_channels / int8_pointwise gate is the
    # constant pair INT8_MIN_CHANNELS / INT8_POINTWISE of ops/conv.py)
    # layout of arrays the USER passes to input()/gets from extract():
    # "nhwc" or "nchw" (the engine permutes at the boundary)
    io_layout: str = "nhwc"
    # run load-time graph fusions (conv+bn fold, conv+activation tagging,
    # cat-split of pointwise convs; ir/passes.py)
    fuse: bool = True
    # collapse eligible YOLOv5 C3 blocks into one si.FusedC3 op
    # (ir/passes.fuse_c3_blocks), run by kernels/c3block.c3_block where
    # its gates pass (ops/c3.py); requires fuse=True. Off by default, as
    # in the JAX package.
    c3_fusion: bool = False
    # hand-written kernels for eligible ops (pointwise int8w convs and
    # int8w linears through kernels/matmul.matmul_int8w, int4w weights
    # through matmul_int4w, static-int8 convs and linears through
    # matmul_s8s8, fused C3 blocks through kernels/c3block.c3_block,
    # long prefills through kernels/attention.flash_attention): the
    # counterpart of the JAX
    # package's `EngineConfig.use_pallas`. None = on when the device is
    # CUDA. use_pallas defaults off because of a TPU v5e measurement,
    # which says nothing about Hopper. On a CPU device the kernels'
    # wrappers run their plain PyTorch versions.
    use_kernels: Optional[bool] = None
    # uint8 inputs are shipped raw and scaled on the device by this factor
    u8_scale: float = 1.0 / 255.0
    # torch device string; the entry points run on CUDA unless the
    # caller asks for the CPU (tests pass device="cpu"). "cuda:i" pins
    # the engine to card i (the JAX package's device_index=i; DP engine
    # pools, serving/batcher.py). Under a mesh a bare "cuda" means this
    # rank's card (parallel/multihost.local_device)
    device: str = "cuda"
    # device mesh; None = single device. Every rank of the
    # torch.distributed world builds the same Engine; num_devices must
    # equal the world size (parallel/multiproc.launch or torchrun start
    # the ranks)
    mesh: Optional[MeshConfig] = None
    # tensor-parallel reduce of the row-parallel attention output
    # projections when mesh.model > 1: "gspmd" (the JAX name; one
    # all_reduce over the model group) or "ring" (parallel/tp.
    # tp_linear_row: the local partial in column chunks whose sums ride
    # a ring of neighbour send / recv hops; ops whose heads do not
    # divide the model axis keep the all_reduce)
    tp_mode: str = "gspmd"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if self.quant not in (None, "int8w", "int8", "int4w"):
            raise ValueError(
                "quant must be None, 'int8w', 'int8' or 'int4w'")
        if self.int4_group < 2 or self.int4_group % 2:
            raise ValueError("int4_group must be an even number >= 2")
        if self.act_clip_percentile is not None and not (
                0.0 < self.act_clip_percentile < 100.0):
            raise ValueError("act_clip_percentile must be in (0, 100)")
        if self.io_layout not in ("nhwc", "nchw"):
            raise ValueError("io_layout must be 'nhwc' or 'nchw'")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError("device must be a CUDA or CPU device")
        if self.quant == "int4w" and self.mesh is not None:
            raise ValueError(
                "int4w is single-device in this version (Quantized4Tensor"
                " carries no shard layout yet) — drop the mesh or use"
                " int8w")
        if self.tp_mode not in ("gspmd", "ring"):
            raise ValueError("tp_mode must be 'gspmd' or 'ring'")
        if self.mesh is not None and torch.device(self.device).index \
                is not None:
            raise ValueError("a device index pins a SINGLE-device "
                             "engine; it cannot combine with a mesh")

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
