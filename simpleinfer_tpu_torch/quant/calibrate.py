"""Static activation calibration for full-int8 inference (counterpart of
simpleinfer_tpu/quant/calibrate.py).

- `build_observer_fn(program)` re-runs the lowered plan and, for every
  op that can consume int8 activations (`OpImpl.act_quant`), records a
  statistic of its input activations: abs-max by default, or a high
  percentile of |x| (`EngineConfig.act_clip_percentile`; outliers then
  saturate in `quantize_act`); per tensor, or per channel for ops that
  can fold a vector scale into their weight (`OpImpl.act_fold`).
- `Engine.calibrate` takes the running max across batches and turns the
  stats into per-op scales `stat / 127` (`scales_from_stats`), stored as
  an `act_scale` weight entry; per-channel vectors are first balanced
  against the weight (`smooth_balanced_scales`).

Calibration runs with the weights already int8-quantized (build_program
quantizes at load for quant="int8"), so the observed ranges include the
weight-quantization error: the scales calibrate the network that will
run, not its fp parent.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tensor import QuantizedActivation


def _quantile(a: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """Linear-interpolation quantile along `dim` (numpy's and jnp's
    default method), by sorting: torch.quantile refuses inputs of more
    than 2^24 elements, which a 640x640 batch exceeds."""
    v, _ = torch.sort(a, dim=dim)
    pos = q * (v.shape[dim] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.shape[dim] - 1)
    vlo, vhi = v.select(dim, lo), v.select(dim, hi)
    return vlo + (vhi - vlo) * (pos - lo)


def _tensor_stat(a, percentile: Optional[float], axis: Optional[int] = None):
    """abs-max (or percentile of |x|) of one activation — an f32 scalar,
    or a per-channel f32 vector over `axis` (OpImpl.act_fold). A
    QuantizedActivation (re-calibration over an active int8 chain) is
    read at its real values."""
    if isinstance(a, QuantizedActivation):
        a = a.dequantize(torch.float32)
    mag = a.float().abs()
    if axis is not None:
        c = mag.shape[axis]
        flat = torch.movedim(mag, axis, -1).reshape(-1, c)
        if percentile is not None:
            return _quantile(flat, percentile / 100.0, 0)
        return flat.amax(dim=0)
    if percentile is not None:
        return _quantile(mag.reshape(-1), percentile / 100.0, 0)
    return mag.max()


def _mesh_stat(walk, a, sharded: bool, percentile, axis):
    """The statistic of an activation held in shards (a rank's batch rows
    over `data`, its height rows over `spatial` when `sharded`) equal to
    the whole activation's: abs-max is each shard's, reduced with MAX
    over the axes; a percentile is taken over the gathered activation."""
    from ..parallel.mesh import AXIS_DATA, AXIS_SPATIAL, all_gather, \
        all_reduce

    mesh = walk.mesh
    if percentile is not None:
        if isinstance(a, QuantizedActivation):
            a = a.dequantize(torch.float32)
        a = all_gather(a, mesh, AXIS_DATA, 0)
        if sharded:
            a = all_gather(a, mesh, AXIS_SPATIAL, 1)
        return _tensor_stat(a, percentile, axis)
    v = _tensor_stat(a, None, axis).float()
    v = all_reduce(v, mesh, AXIS_DATA, "max")
    if sharded:
        v = all_reduce(v, mesh, AXIS_SPATIAL, "max")
    return v


def build_observer_fn(program, percentile: Optional[float] = None,
                      per_channel: bool = False, walk=None):
    """fn(weights, inputs) -> {op name: f32 activation stat (tensor)} for
    every act_quant op in the plan; runs the full forward. Stats are
    scalars, or per-channel vectors for single-input ops advertising
    OpImpl.act_fold when `per_channel` is set. With `walk` (a mesh
    engine's executor.ShardedWalk) the forward is this rank's sharded
    walk and each statistic is reduced over the shards (`_mesh_stat`):
    every rank returns the stats of the whole batch."""
    plan = program.plan

    def axis_of(impl, args):
        return (impl.act_fold[0] if per_channel and impl.act_fold
                and len(args) == 1 else None)

    if walk is not None:
        def mesh_fn(weights, inputs):
            stats = {}

            def observe(impl, args, sharded):
                if impl.act_quant and args:
                    axis = axis_of(impl, args)
                    vals = [_mesh_stat(walk, a, s, percentile, axis)
                            for a, s in zip(args, sharded)]
                    stats[impl.name] = (vals[0] if len(vals) == 1
                                        else torch.stack(vals).max())

            walk(weights, inputs, observe=observe)
            return stats

        return mesh_fn

    def fn(weights, inputs):
        env = dict(inputs)
        stats = {}
        for impl, in_names, out_names in plan:
            args = [env[n] for n in in_names]
            if impl.act_quant and args:
                axis = axis_of(impl, args)
                vals = [_tensor_stat(a, percentile, axis) for a in args]
                stats[impl.name] = (vals[0] if len(vals) == 1
                                    else torch.stack(vals).max())
            out = impl.apply(weights[impl.name], *args)
            if impl.n_outputs == 1:
                env[out_names[0]] = out
            else:
                for n, o in zip(out_names, out):
                    env[n] = o
        return stats

    return fn


def smooth_balanced_scales(act_absmax, w_ic_absmax, alpha: float = 0.5):
    """Balanced per-channel activation scales (the SmoothQuant
    equivalent transform, Xiao et al. 2022): s_ic = act_max^alpha /
    w_max^(1-alpha) splits the channel skew between the activation and
    the per-out-channel weight quantization instead of moving it all
    into the weight.

    Returns v (f32, per input channel) such that x_hat = x / v is int8
    with max |x_hat| = 127, and w·v requantized per-out-channel carries
    the rest; the s32 epilogue dequant is the folded weight's
    per-out-channel scale alone (ops/conv.int8_epilogue convention)."""
    act = np.maximum(np.asarray(act_absmax, np.float64), 1e-8)
    wm = np.maximum(np.asarray(w_ic_absmax, np.float64), 1e-8)
    s = np.maximum(act ** alpha / wm ** (1.0 - alpha), 1e-8)
    t = max(float((act / s).max()) / 127.0, 1e-12)
    return (s * t).astype(np.float32)


def scales_from_stats(stats: dict) -> dict:
    """Aggregated abs-max stats -> symmetric scales: f32 scalars for
    per-tensor stats, f32 vectors for per-channel stats (numpy)."""
    return {k: np.asarray(np.maximum(np.asarray(v, np.float32), 1e-8)
                          / 127.0, np.float32)
            for k, v in stats.items()}
