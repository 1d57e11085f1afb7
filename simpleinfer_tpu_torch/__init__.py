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
`conv3x3_s1_same` and `stem_s2d`; the detection pipeline (zoo/detect,
YOLOv5 and YOLOv8 heads, NMS on the device), segmentation, metrics,
image I/O and the native host library (host.py); and CNN serving:
serving.BatchingService (buckets, the pipelined dispatch, engine pools),
the HTTP front end serving.InferenceServer, and the command line
(`python -m simpleinfer_tpu_torch dump|detect|classify|segment|calibrate|
serve`, tools.py); and the attention lineages: nn.MultiheadAttention,
F.scaled_dot_product_attention, torch.matmul / bmm / select, sliding
windows (ring caches, the banded flash kernel), logit softcap and ALiBi,
the GPT / BLOOM / NeoX / ViT / BERT builders and greedy_generate;
LLM serving over HTTP (/v1/generate, TieredGenerationService) and
speculative decoding; and the model-import path: frontends.export_torch
(torch.fx export of an eager nn.Module, on its own device), the Hugging
Face converters (frontends.hf_llama: llama / qwen2 / qwen3 / mistral /
gemma / gemma2 / phi3 / stablelm, neox / phi / gptj, bloom, falcon, mpt,
opt; frontends.hf_gpt2), the ConvNeXt / MobileNetV3 / SqueezeNet
builders, and the reference's own API: tensor.py (DataType, Status,
Tensor) and compat.py (InitializeContext and the PascalCase Engine);
and parallelism on torch.distributed: MeshConfig, data / spatial /
model sharding in the Engine's walk, tensor-parallel decode behind
GenerationService, and parallel/ (mesh, multihost, tp, multiproc).
"""
from .config import EngineConfig, MeshConfig
from .engine import (Engine, EngineStateError, initialize_context,
                     load_exported)
from .executor import Program, build_program
from .ir.graph import Graph
from .tensor import DataType, Status, Tensor

__all__ = [
    "DataType",
    "Engine",
    "EngineConfig",
    "EngineStateError",
    "Graph",
    "MeshConfig",
    "Program",
    "Status",
    "Tensor",
    "build_program",
    "initialize_context",
    "load_exported",
]
