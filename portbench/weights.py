"""The benchmark's weights: drawn on the card from the seed, in one call,
and written into a pnnx graph before the program sees it.

Every float weight of the graph is replaced, op by op in the graph's
order, by a slice of one normal draw of a torch.Generator seeded with
the run's seed, scaled by the rule of its op type and key (He-style for
convs and projections, near 1 for norm gains). The same seed gives the
same weights. The draw is copied to the host once: the graph format
holds host arrays, and the program quantizes and places them itself.
Tables that are not weights (the Detect head's grids, anchors and
strides, a causal mask) are left as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _he(fan_in):
    return math.sqrt(2.0 / fan_in)


def _rule(op_type: str, key: str, shape: tuple):
    """(scale, offset) of a weight: value = offset + scale * normal; None
    for an attribute that is not a weight."""
    if op_type == "nn.Conv2d":
        if key == "weight":
            return _he(int(np.prod(shape[1:]))), 0.0
        if key == "bias":
            return 0.05, 0.0
    if op_type == "models.yolo.Detect":
        if key.startswith("m.") and key.endswith(".weight"):
            return _he(shape[1]), 0.0
        if key.startswith("m.") and key.endswith(".bias"):
            return 0.05, 0.0
        return None                       # grids, anchors, strides
    if op_type == "nn.Embedding" and key == "weight":
        return 0.05, 0.0
    if op_type == "pnnx.Attribute" and key == "data":
        return (0.02, 0.0) if len(shape) == 3 else None   # 2-D: a mask
    if op_type == "nn.LayerNorm":
        return (0.1, 1.0) if key == "weight" else (0.1, 0.0)
    if op_type == "nn.MultiheadAttention":
        if key in ("in_proj_weight", "out_proj.weight"):
            return _he(shape[1]), 0.0
        return 0.02, 0.0
    if op_type == "nn.Linear":
        if key == "weight":
            return _he(shape[1]), 0.0
        return 0.05, 0.0
    raise ValueError(f"no weight rule for {op_type} attribute {key!r} "
                     f"{shape}")


def fill_graph(graph, seed: int, device) -> list:
    """Replace the graph's weights by the seed's; returns [(op name, op
    type, key, float32 host array)] in graph order, the arrays the
    references take (the graph holds copies)."""
    from simpleinfer_tpu_torch.ir.graph import Attribute

    slots = []
    for op in graph.ops:
        for key, attr in op.attrs.items():
            shape = tuple(attr.array().shape)
            rule = _rule(op.type, key, shape)
            if rule is not None:
                slots.append((op, key, shape, rule))
    total = sum(int(np.prod(s)) for _, _, s, _ in slots)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()
    out, at = [], 0
    for op, key, shape, (scale, offset) in slots:
        n = int(np.prod(shape))
        arr = (flat[at:at + n].reshape(shape) * np.float32(scale)
               + np.float32(offset)).astype(np.float32)
        at += n
        op.attrs[key] = Attribute.from_array(arr.copy())
        out.append((op.name, op.type, key, arr))
    return out
