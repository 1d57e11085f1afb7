"""Public Engine API of the PyTorch/CUDA port.

The counterpart of simpleinfer_tpu/engine.py, with the same surface:

    Engine.load_model(parampath, binpath, graph=...)
    Engine.release()
    Engine.input_names / output_names / program
    Engine.input(name, array)      (dtype policy, u8 scaling, io_layout)
    Engine.forward()
    Engine.extract(name)
    Engine.run(**inputs)
    Engine.synchronize()           (the block_until_ready counterpart)

Execution model: `load_model` lowers the pnnx graph once
(executor.build_program) and places the weights on the engine's device
once, at the compute dtype. `forward` runs the plan eagerly on the
staged tensors; it returns when the work is queued on the card, and
`extract` / `synchronize` wait for it. The engine runs on the device of
`EngineConfig.device` ("cuda" by default) and never moves silently to
another one: asking for CUDA without a card raises.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional

import numpy as np
import torch

from .config import EngineConfig
from .executor import Program, build_program
from .ir.graph import Graph
from .quant.tensor import Quantized4Tensor, QuantizedTensor

logger = logging.getLogger("simpleinfer_tpu_torch")


class EngineStateError(RuntimeError):
    """Operation requires a loaded model / a forward first."""


def resolve_device(name: str) -> torch.device:
    """The torch device an engine runs on; raises instead of falling
    back when CUDA is asked for and there is no card."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} out of range: "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return device


@contextlib.contextmanager
def fp32_parity(enabled: bool):
    """fp32 is the parity mode: no TF32 in cuDNN convs
    (torch.backends.cudnn.allow_tf32, True by default) nor in cuBLAS
    matmuls (torch.backends.cuda.matmul.allow_tf32). Restores both. Sets
    the two flags directly: `torch.backends.cudnn.flags(allow_tf32=False)`
    would also reset its other arguments, `enabled` among them, to their
    defaults and switch cuDNN off."""
    if not enabled:
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Engine:
    """Load a pnnx model and run batched NHWC inference with PyTorch."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self._program: Optional[Program] = None
        self._device_weights = None
        self._staged: dict = {}
        self._outputs: dict = {}

    # ---- lifecycle -----------------------------------------------------
    def load_model(self, parampath: Optional[str],
                   binpath: Optional[str] = None,
                   graph: Optional[Graph] = None) -> "Engine":
        """Lower + place a model (idempotent re-load). Pass `graph` to
        load an already-parsed/constructed Graph."""
        self.release()
        t0 = time.perf_counter()
        if graph is None:
            graph = Graph.load(parampath, binpath)
        program = build_program(graph, self.config)
        self._device_weights = self.place_weights(program.weights, program)
        self._program = program
        logger.info("loaded model %s: %d ops on %s, %.0f ms", parampath,
                    len(program.impls), self.device,
                    (time.perf_counter() - t0) * 1e3)
        return self

    def release(self) -> None:
        self._program = None
        self._device_weights = None
        self._staged = {}
        self._outputs = {}

    @property
    def loaded(self) -> bool:
        return self._program is not None

    # ---- introspection ---------------------------------------------------
    @property
    def input_names(self) -> list:
        self._require_loaded()
        return self._program.input_names

    @property
    def output_names(self) -> list:
        self._require_loaded()
        return self._program.output_names

    @property
    def program(self) -> Program:
        self._require_loaded()
        return self._program

    # ---- run-time calls --------------------------------------------------
    def input(self, name: str, array) -> None:
        """Stage one named input (numpy array or torch tensor) on the
        engine's device at the compute dtype. Arrays are NHWC by default;
        with io_layout='nchw' rank-4 arrays are permuted here. uint8
        arrays are shipped raw and scaled on the device by u8_scale.
        Token-id inputs (consumed only by nn.Embedding, e.g. [N, L] ids
        of an LM) are staged as float32, which holds every id below 2^24
        exactly (bf16 would round ids above 256)."""
        self._require_loaded()
        if name not in self._program.input_names:
            raise KeyError(
                f"unknown input {name!r}; inputs are {self._program.input_names}")
        x = array if isinstance(array, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(array))
        spec = next(s for s in self._program.inputs if s.name == name)
        dtype = torch.float32 if spec.token else \
            self.config.compute_torch_dtype
        if x.dtype == torch.uint8 and not spec.token:
            x = x.to(self.device).to(dtype) * self.config.u8_scale
        else:
            x = x.to(self.device, dtype)
        if self.config.io_layout == "nchw" and x.ndim == 4:
            x = x.permute(0, 2, 3, 1)
        if spec.shape and len(spec.shape) != x.ndim:
            raise ValueError(
                f"input {name!r}: rank {x.ndim} does not match declared "
                f"shape {spec.shape}")
        self._staged[name] = x.contiguous()

    def forward(self) -> None:
        """Run the plan on the staged inputs (queued on the device)."""
        self._require_loaded()
        missing = [n for n in self._program.input_names
                   if n not in self._staged]
        if missing:
            raise EngineStateError(f"inputs not set: {missing}")
        fp32 = self.config.compute_torch_dtype == torch.float32
        with torch.inference_mode(), fp32_parity(fp32):
            self._outputs = self._program.fn(self._device_weights,
                                             self._staged)

    def synchronize(self) -> None:
        """Wait until the last forward's work on the device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def extract(self, name: str, as_numpy: bool = True):
        """Fetch a named output of the last forward(). As numpy, bf16
        outputs come back as float32 (numpy has no bfloat16)."""
        self._require_loaded()
        if name not in self._outputs:
            if name in self._program.output_names:
                raise EngineStateError("forward() has not been run")
            raise KeyError(
                f"unknown output {name!r}; outputs are "
                f"{self._program.output_names}")
        out = self._outputs[name]
        if self.config.io_layout == "nchw" and out.ndim == 4:
            out = out.permute(0, 3, 1, 2)
        if not as_numpy:
            return out
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def run(self, inputs: Optional[dict] = None, **named) -> dict:
        """One-shot: stage inputs, forward, return all outputs (numpy)."""
        feeds = dict(inputs or {})
        feeds.update(named)
        for k, v in feeds.items():
            self.input(k, v)
        self.forward()
        return {n: self.extract(n) for n in self.output_names}

    # ---- internals ---------------------------------------------------
    def _require_loaded(self) -> None:
        if self._program is None:
            raise EngineStateError("no model loaded")

    def place_weights(self, weights: dict, program: Program) -> dict:
        """Move a {op: {key: tensor | QuantizedTensor | Quantized4Tensor}}
        weight tree of `program` to the engine's device, float weights at
        the compute dtype; each op's fp32_keys (e.g. YOLO grids, qk-norm
        weights) stay f32 and quantized tensors keep their int8 data /
        packed nibbles and f32 scales."""
        fp32_keys = {impl.name: impl.fp32_keys for impl in program.impls}
        dtype = self.config.compute_torch_dtype
        placed = {}
        for opname, wdict in weights.items():
            keep = fp32_keys.get(opname, ())
            placed[opname] = {}
            for k, w in wdict.items():
                if isinstance(w, (QuantizedTensor, Quantized4Tensor)):
                    placed[opname][k] = w.to(self.device)
                elif w.is_floating_point() and k not in keep:
                    placed[opname][k] = w.to(self.device, dtype)
                else:
                    placed[opname][k] = w.to(self.device)
        return placed
