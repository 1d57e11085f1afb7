"""Carry the JAX package's program weights over to the port.

`program_weights_from_numpy` takes a JAX `Program.weights` tree that the
caller converted to numpy — {op: {key: ndarray | (int8 data, f32 scale,
axis) | (int8 packed, f32 scale, group, k)}}, the tuples standing for
QuantizedTensor and Quantized4Tensor — and returns the port's weights
for the same graph, ready to hand to the port's `Program.fn` (or to an
Engine's place_weights). Both packages then run on the SAME quantized
bytes. Keys line up one to one (both packages keep HWIO conv weights,
per-output-channel scales, the attention ops' wq/wk/wv/wo and
bq/bk/bv/bo (si.RotaryAttention and nn.MultiheadAttention alike, dense,
int8w or int4w), wqn/wkn, gamma
and weight, the static-int8 `act_scale` / `out_scale` entries that JAX's
own Engine.calibrate installs — scalars or per-channel vectors, with the
folded weights they go with — and the si.FusedC3 keys with its s8 taps
`btl_b_wq` / `btl_b_wsc`, and the CNN family's BatchNorm / InstanceNorm
`scale` / `shift`, GroupNorm / LayerNorm `gamma` / `beta`, the flipped
HWIO ConvTranspose2d `weight`, PReLU `slope` and pnnx.Attribute
`value`), so a JAX program runs in the port on the same bytes and
scales (an ALiBi op's slopes are no weight: both lowerings take them
from the graph's alibi_slopes attr or its head count); the exceptions:
- the Detect decode tables: per level (`gridc{i}`, `anchorc{i}`) in the
  JAX package, row-concatenated (`grid`, `anchor`) in the port;
- the block-Toeplitz stem packs `bt_in{g}` of the JAX package's W-packed
  chain (a TPU layout means the port does not carry), which are dropped.

Tensors are placed on `device` as they are, the card unless the caller
asks for the CPU (as `EngineConfig.device` defaults to it); casting to
a compute dtype is the caller's (Engine.place_weights).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.yolo import detect_tables
from .quant.tensor import Quantized4Tensor, QuantizedTensor


def _tensor(a, device) -> torch.Tensor:
    # a copy: arrays fetched from JAX are read-only
    return torch.from_numpy(np.array(a, order="C")).to(device)


def program_weights_from_numpy(weights: dict, device="cuda") -> dict:
    out = {}
    for opname, wdict in weights.items():
        port = {}
        for key, v in wdict.items():
            if key.startswith(("bt_in", "gridc", "anchorc")):
                continue
            if isinstance(v, tuple) and len(v) == 4:
                packed, scale, group, k = v
                port[key] = Quantized4Tensor(
                    packed=_tensor(np.asarray(packed, np.int8), device),
                    scale=_tensor(np.asarray(scale, np.float32), device),
                    group=int(group), k=int(k))
            elif isinstance(v, tuple):
                data, scale, axis = v
                port[key] = QuantizedTensor(
                    data=_tensor(np.asarray(data, np.int8), device),
                    scale=_tensor(np.asarray(scale, np.float32), device),
                    axis=int(axis))
            else:
                port[key] = _tensor(v, device)
        if "gridc0" in wdict:
            levels = sorted(int(k[5:]) for k in wdict if k.startswith("gridc"))
            tables = detect_tables([(wdict[f"gridc{i}"], wdict[f"anchorc{i}"])
                                    for i in levels])
            port.update({k: _tensor(v, device) for k, v in tables.items()})
        out[opname] = port
    return out
