"""simpleinfer_tpu_torch — the PyTorch/CUDA port of simpleinfer_tpu.

The same pnnx-IR inference engine and `Engine` surface, on PyTorch, for
an NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel
of the JAX package becomes a kernel written by hand for Hopper
(kernels/, sources in csrc/). The JAX package stays the reference; this
package imports neither jax nor simpleinfer_tpu.

Ported so far: the YOLOv5 path — IR, fusions, the YOLOv5 builder, the
ops it lowers to, weight-only int8, the executor and the Engine — with
`matmul` / `matmul_int8w` as a CUDA kernel; and the llama generation
path — the llama builder, Linear / norm / rotary-attention ops,
group-wise int4 weights, the KV-cache decoder, sampling and
serving.GenerationService — with `matmul_int4w`, `flash_attention` and
`decode_attention` as CUDA kernels; and static int8 (calibration, int8
chains, per-channel folding) with the C3 collapse — with `matmul_s8s8`
and `c3_block` as CUDA kernels; the CNN classification family with
`conv3x3_s1_same` and `stem_s2d`; and the detection pipeline (zoo/detect,
YOLOv5 and YOLOv8 heads, NMS on the device), segmentation, metrics,
image I/O and the native host library (host.py).
"""
from .config import EngineConfig
from .engine import Engine, EngineStateError, initialize_context
from .executor import Program, build_program
from .ir.graph import Graph

__all__ = [
    "Engine",
    "EngineConfig",
    "EngineStateError",
    "Graph",
    "Program",
    "build_program",
    "initialize_context",
]
