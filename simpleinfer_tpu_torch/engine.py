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
    Engine.warmup(batch_sizes)     (one forward per batch size, ahead)
    Engine.temp_bytes(batch_size)  (a forward's peak memory above what
                                    was allocated before it; None on CPU)
    Engine.calibrate(batches)      (static int8: activation scales)
    Engine.save_calibration(path) / load_calibration(path)

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
from .quant.tensor import (Quantized4Tensor, QuantizedTensor,
                           quantize_per_channel)

logger = logging.getLogger("simpleinfer_tpu_torch")


def initialize_context() -> None:
    """Logging init, as the JAX package's initialize_context (the
    reference's InitializeContext also only initializes logging)."""
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname).1s %(name)s] %(message)s")


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
        # pre-fold quantized weights (per-channel act scales fold the
        # act factor into the weight; re-installs restore from here)
        self._pristine_qweights: dict = {}

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
        self._pristine_qweights = {}

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
        self._staged[name] = self._prepare_input(name, array)

    def _prepare_input(self, name: str, array) -> torch.Tensor:
        """Convert + place one named input (dtype policy, u8 scaling,
        layout) — shared by input() and calibrate()."""
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
        return x.contiguous()

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

    def _zero_feeds(self, batch_size: int, what: str,
                    dynamic_ok: bool) -> dict:
        """Zeros of each input's declared shape at `batch_size`. A
        dynamic non-batch dim raises unless `dynamic_ok` (then 1)."""
        feeds = {}
        for spec in self._program.inputs:
            if not spec.shape:
                raise EngineStateError(
                    f"{what} needs a declared shape for input "
                    f"{spec.name!r}")
            if not dynamic_ok and any(d == -1 for d in spec.shape[1:]):
                # batch is the only axis a warmup can pick a size for
                raise EngineStateError(
                    f"{what} cannot pick a size for dynamic non-batch "
                    f"dim(s) of input {spec.name!r} (declared "
                    f"{spec.shape}); feed a concrete array via "
                    f"input()+forward() instead")
            shape = [batch_size] + [1 if d == -1 else d
                                    for d in spec.shape[1:]]
            if self.config.io_layout == "nchw" and len(shape) == 4:
                # input() reads rank-4 arrays as NCHW on such an engine
                # (the JAX package's warmup feeds NHWC zeros there and
                # fails)
                shape = [shape[0], shape[3], shape[1], shape[2]]
            feeds[spec.name] = np.zeros(shape, np.float32)
        return feeds

    def warmup(self, batch_sizes=(1,)) -> None:
        """One forward per batch size on zeros of the declared input
        shapes, ahead of the first request: builds and loads the kernel
        libraries, and runs cuDNN's and cuBLAS's first-call setup for
        those shapes. Requires declared input shapes. The staged inputs
        and outputs of the last forward are kept."""
        self._require_loaded()
        staged_backup, outputs_backup = dict(self._staged), self._outputs
        try:
            for bs in batch_sizes:
                for name, x in self._zero_feeds(bs, "warmup",
                                                False).items():
                    self.input(name, x)
                self.forward()
            self.synchronize()
        finally:
            self._staged, self._outputs = staged_backup, outputs_backup

    def temp_bytes(self, batch_size: int) -> Optional[int]:
        """Peak device memory of one forward at this batch size above
        what was allocated before it (the resident weights, the staged
        zeros of the input shapes, anything else the process holds):
        the forward's temporaries and outputs. torch.cuda's allocator
        statistics count allocated bytes, not the blocks its cache
        keeps. None on the CPU, which keeps no such statistics (the JAX
        method returns None where its backend gives no memory report)."""
        self._require_loaded()
        if self.device.type != "cuda":
            return None
        staged = {k: self._prepare_input(k, v) for k, v in self._zero_feeds(
            batch_size, "temp_bytes", True).items()}
        fp32 = self.config.compute_torch_dtype == torch.float32
        torch.cuda.synchronize(self.device)
        base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        with torch.inference_mode(), fp32_parity(fp32):
            out = self._program.fn(self._device_weights, staged)
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        del out, staged
        return int(peak - base)

    # ---- static int8 ---------------------------------------------------
    def calibrate(self, sample_batches) -> dict:
        """Static-int8 activation calibration (quant='int8' only).

        `sample_batches`: iterable of {input name: array} feeds (any
        batch size; representative data). Runs one observer pass per
        batch collecting per-op activation ranges (quant/calibrate.py),
        takes the running max, installs `act_scale` entries into the
        weights and re-places them: the next forward takes the
        s8 x s8 -> s32 conv/linear paths. Returns {op name: scale}."""
        self._require_loaded()
        if self.config.quant != "int8":
            raise EngineStateError(
                "calibrate() requires EngineConfig(quant='int8')")
        from .quant.calibrate import build_observer_fn, scales_from_stats

        observer = build_observer_fn(
            self._program, self.config.act_clip_percentile,
            per_channel=self.config.act_per_channel)
        fp32 = self.config.compute_torch_dtype == torch.float32
        agg: dict = {}
        n_batches = 0
        for feeds in sample_batches:
            staged = {k: self._prepare_input(k, v) for k, v in feeds.items()}
            missing = [n for n in self._program.input_names
                       if n not in staged]
            if missing:
                raise EngineStateError(
                    f"calibration batch missing inputs: {missing}")
            with torch.inference_mode(), fp32_parity(fp32):
                stats = observer(self._device_weights, staged)
            for k, v in stats.items():
                v = v.float().cpu().numpy()  # scalar or per-channel
                agg[k] = np.maximum(agg[k], v) if k in agg else v
            n_batches += 1
        if not n_batches:
            raise EngineStateError("calibrate() needs at least one batch")
        scales = scales_from_stats(agg)
        if self.config.act_per_channel:
            scales = self._balance_per_channel(scales)
        self._install_act_scales(scales)
        logger.info("calibrated %d ops over %d batches (observer=%s)",
                    len(scales), n_batches,
                    self.config.act_clip_percentile or "absmax")
        return scales

    def _balance_per_channel(self, scales: dict) -> dict:
        """Replace raw per-channel scale vectors (absmax/127) with
        SmoothQuant-balanced ones (quant/calibrate.smooth_balanced_scales)
        for ops whose weight they will fold into. save_calibration
        artifacts store the BALANCED vectors, so load_calibration folds
        them verbatim and round-trips exactly."""
        from .quant.calibrate import smooth_balanced_scales

        impls = {i.name: i for i in self._program.impls}
        out = {}
        for name, s in scales.items():
            s = np.asarray(s, np.float32)
            impl = impls.get(name)
            w = self._pristine_qweights.get(name)
            if w is None:
                w = self._program.weights[name].get("weight")
            fold = impl.act_fold if impl is not None else None
            if (s.ndim == 1 and fold is not None
                    and isinstance(w, QuantizedTensor)
                    and w.data.shape[fold[1]] == s.size):
                w_fp = self._program.fp_weights.get(name)
                w_fp = (w.dequantize() if w_fp is None else w_fp).numpy()
                ic = fold[1] % w_fp.ndim
                w_ic = np.abs(w_fp).max(
                    axis=tuple(i for i in range(w_fp.ndim) if i != ic))
                out[name] = smooth_balanced_scales(s * 127.0, w_ic)
            else:
                out[name] = s
        return out

    def _install_act_scales(self, scales: dict) -> None:
        """Install per-op activation scales into the weights and
        re-place them (switches conv/linear onto the s8 path).

        Vector (per-channel) scales are FOLDED into the op's quantized
        weight along its input-channel axis (OpImpl.act_fold): with
        w~ = w·s[ic] requantized per-out-channel and x̂ = x/s[ic], the
        s32 accumulator dequantizes by w~'s per-out-channel scale alone.
        The pre-fold weight is kept, so re-installs (re-calibration,
        loading another artifact) never fold twice."""
        unknown = [k for k in scales if k not in self._program.weights]
        if unknown:
            raise EngineStateError(
                f"calibration names not in this model: {unknown[:5]}")
        weights = self._program.weights
        impls = {i.name: i for i in self._program.impls}
        # restore pre-fold weights before applying the new scales; an op
        # absent from the NEW scales also loses its old act_scale (a
        # stale per-channel vector over an unfolded weight would
        # quantize by s while the epilogue dequantizes by w_scale alone)
        for opname, w0 in self._pristine_qweights.items():
            weights[opname]["weight"] = w0
            if opname not in scales:
                weights[opname].pop("act_scale", None)
        for opname, s in scales.items():
            s = np.asarray(s, np.float32)
            if s.ndim == 1:
                impl = impls.get(opname)
                w = weights[opname].get("weight")
                fold = impl.act_fold if impl is not None else None
                if (fold is None or not isinstance(w, QuantizedTensor)
                        or w.data.shape[fold[1]] != s.size):
                    logger.warning(
                        "per-channel act scale for %r cannot fold "
                        "(act_fold=%s); reducing to per-tensor",
                        opname, fold)
                    s = np.float32(s.max())
                else:
                    w0 = self._pristine_qweights.setdefault(opname, w)
                    wf = self._program.fp_weights.get(opname)
                    wf = (w0.dequantize() if wf is None else wf).numpy()
                    bshape = [1] * wf.ndim
                    bshape[fold[1] % wf.ndim] = s.size
                    weights[opname]["weight"] = quantize_per_channel(
                        wf * s.reshape(bshape), axis=w0.axis)
            weights[opname]["act_scale"] = torch.from_numpy(
                np.array(s, np.float32))
        # chain producers (ir/passes.mark_int8_chains) requantize their
        # output to the consumer's scale: install it as out_scale. A
        # per-channel consumer scale (or an absent one) disables the
        # chain; every consumer then quantizes its own input.
        for impl in self._program.impls:
            c = impl.q_out_consumer
            if c is None:
                continue
            s = np.asarray(scales[c], np.float32) if c in scales else None
            if s is not None and s.ndim == 0:
                weights[impl.name]["out_scale"] = torch.from_numpy(
                    np.array(s, np.float32))
            else:
                weights[impl.name].pop("out_scale", None)
        self._device_weights = self.place_weights(weights, self._program)

    def save_calibration(self, path: str) -> None:
        """Persist the installed activation scales as an npz artifact
        {op name: f32 scalar or per-channel vector}, the JAX package's
        format: an artifact either package saves, the other loads."""
        self._require_loaded()
        scales = {name: w["act_scale"].numpy()
                  for name, w in self._program.weights.items()
                  if "act_scale" in w}
        if not scales:
            raise EngineStateError(
                "no activation scales installed; run calibrate() first")
        # through a file object: np.savez would append ".npz" to a path
        with open(path, "wb") as f:
            np.savez(f, **scales)

    def load_calibration(self, path: str) -> dict:
        """Install activation scales from a `save_calibration` artifact
        (of either package). Requires quant='int8'. Returns the
        {op name: scale} dict."""
        self._require_loaded()
        if self.config.quant != "int8":
            raise EngineStateError(
                "load_calibration() requires EngineConfig(quant='int8')")
        with np.load(path) as z:
            scales = {k: np.asarray(z[k], np.float32) for k in z.files}
        self._install_act_scales(scales)
        logger.info("loaded calibration for %d ops from %s",
                    len(scales), path)
        return scales

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
        packed nibbles and f32 scales. The weight of a static-int8 op
        (OpImpl.s8_weight, with its `act_scale` installed) is laid out
        K-major here, once, as the s8 GEMM reads it."""
        fp32_keys = {impl.name: impl.fp32_keys for impl in program.impls}
        s8 = {impl.name for impl in program.impls if impl.s8_weight}
        dtype = self.config.compute_torch_dtype
        placed = {}
        for opname, wdict in weights.items():
            keep = fp32_keys.get(opname, ())
            k_major = opname in s8 and "act_scale" in wdict
            placed[opname] = {}
            for k, w in wdict.items():
                if isinstance(w, (QuantizedTensor, Quantized4Tensor)):
                    w = w.to(self.device)
                    if k_major and k == "weight" and isinstance(
                            w, QuantizedTensor):
                        w = w.k_major()
                    placed[opname][k] = w
                elif w.is_floating_point() and k not in keep:
                    placed[opname][k] = w.to(self.device, dtype)
                else:
                    placed[opname][k] = w.to(self.device)
        return placed
