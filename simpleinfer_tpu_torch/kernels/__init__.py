"""Hand-written CUDA kernels for Hopper, the counterparts of the JAX
package's Pallas TPU kernels (simpleinfer_tpu/kernels/). Each wrapper
runs its plain PyTorch version for CPU tensors and launches its kernel
(or raises) for CUDA tensors.

- matmul.py: `matmul` / `matmul_int8w` (csrc/matmul.cu),
  `matmul_int4w` (csrc/matmul_int4w.cu) and `matmul_s8s8`
  (csrc/matmul_s8s8.cu)
- c3block.py: `c3_block` (csrc/c3block.cu)
- attention.py: `flash_attention` (csrc/flash_attention.cu)
- decode_attn.py: `decode_attention` (csrc/decode_attention.cu)
- conv3x3.py: `conv3x3_s1_same` (csrc/conv3x3.cu)
- stem.py: `stem_s2d` (csrc/stem.cu), with the host packing of its input
  and weights
- build.py: nvcc build and ctypes binding of the sources

The submodules are not re-exported by function name, so
`kernels.matmul` stays the module (its `launches` counters live there).

The six entry points `Engine.forward` can reach (`matmul`,
`matmul_int8w`, `matmul_int4w`, `matmul_s8s8`, `flash_attention`,
`c3_block`) are also custom ops in the `simpleinfer` namespace
(`torch.ops.simpleinfer.*`): the CUDA implementation is the wrapper's
launch, the CPU one its plain version, the fake one the output's shape
and dtype. A wrapper goes through its op only while it is traced
(`tracing`: torch.export, the executor's FakeTensorMode walk), so that
an exported graph records the op instead of tracing into ctypes, and an
eager call keeps the direct launch, without the dispatcher's cost.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor


def tracing(x) -> bool:
    """Whether the wrapper's input is being traced, not computed: a fake
    tensor (torch.export's non-strict tracing, a FakeTensorMode walk)."""
    return isinstance(x, FakeTensor)
