"""models.yolo.Detect and models.yolo.DetectV8 lowerings — the YOLOv5 and
YOLOv8 detection heads (counterpart of simpleinfer_tpu/ops/yolo.py).

Detect (YOLOv5): three feature levels (P3/P4/P5), each through its own
1x1 conv (attrs ``m.{0,1,2}.weight/bias``); the logits of all levels are
concatenated in the channel-packed [N, ΣHW, A*ni] layout and decoded
ONCE, in f32:

    xy = (sig(xy) * 2 + grid) * stride
    wh = (sig(wh) * 2)^2 * anchor_grid

Strides come from attr ``pnnx_5``, anchor grids from ``pnnx_{4,2,0}``
and grids from ``pnnx_{6,3,1}``, each [1, A, H, W, 2]. The output is
[N, ΣHW·A, ni], what the JAX `Engine.extract` returns (there a host
retile; here a reshape of a contiguous tensor is a view).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_INT
from .conv import conv2d_nhwc
from .registry import (OpImpl, cached, register_op, require_attr,
                       require_param)

_ANCHOR_ATTR_INDEX = (4, 2, 0)
_GRID_ATTR_INDEX = (6, 3, 1)
_NUM_LEVELS = 3


def detect_tables(level_tables: list) -> dict:
    """The decode tables of the port from per-level ones: the JAX
    package keeps `gridc{i}` / `anchorc{i}` ([H*W, A*ni] each), the port
    their row concatenation (`grid`, `anchor`) for the one decode after
    the concat. Shared with convert.program_weights_from_numpy."""
    return {"grid": np.concatenate([g for g, _ in level_tables]),
            "anchor": np.concatenate([a for _, a in level_tables])}


@register_op("models.yolo.DetectV8")
def lower_yolo_detect_v8(op, cfg):
    """Anchor-free YOLOv8 decode (ultralytics v8). Inputs: one
    [N, H, W, 4*reg_max+nc] map per level (NHWC). In f32 whatever the
    engine's dtype, as in the JAX package:

        dist = softmax(box.reshape(..., 4, reg_max)) @ arange(reg_max)
        xy   = ((anchor+0.5) + (rb-lt)/2) * stride        (cell centres)
        wh   = (lt + rb) * stride
        out  = concat([xy, wh, sigmoid(cls)], -1)  ->  [N, total, 4+nc]
    """
    nc = require_param(op, "nc", PARAM_INT).i
    reg_max = require_param(op, "reg_max", PARAM_INT).i
    strides = require_attr(op, "strides", 1).array().astype(np.float32)
    n_levels = len(op.inputs)
    if strides.shape != (n_levels,):
        raise ValueError(f"DetectV8 {op.name}: strides {strides.shape} "
                         f"vs {n_levels} levels")
    no = 4 * reg_max + nc
    centres: dict = {}   # (H, W, device) -> anchor-cell centres [H*W, 2]

    def centres_of(h, w, x):
        def make():
            xv, yv = np.meshgrid(np.arange(w), np.arange(h))
            return torch.from_numpy(
                np.stack([xv, yv], -1).reshape(h * w, 2)
                .astype(np.float32) + 0.5).to(x.device)
        return cached(centres, (h, w, x.device), make, x)

    def apply(weights, *features):
        bins = torch.arange(reg_max, dtype=torch.float32,
                            device=features[0].device)
        outs = []
        for i, x in enumerate(features):
            n, h, w_, c = x.shape
            if c != no:
                raise ValueError(
                    f"DetectV8 {op.name}: level {i} has {c} channels, "
                    f"expected {no}")
            x = x.float().reshape(n, h * w_, c)
            box, cls = x[..., :4 * reg_max], x[..., 4 * reg_max:]
            # DFL: softmax over reg_max bins -> expected distance
            d = torch.softmax(box.reshape(n, h * w_, 4, reg_max), -1)
            d = (d * bins).sum(-1)                   # [N, HW, 4] ltrb
            lt, rb = d[..., :2], d[..., 2:]
            s = float(strides[i])
            xy = (centres_of(h, w_, x) + (rb - lt) * 0.5) * s
            wh = (lt + rb) * s
            outs.append(torch.cat([xy, wh, torch.sigmoid(cls)], -1))
        return torch.cat(outs, dim=1)

    return OpImpl(name=op.name, type=op.type, apply=apply, weights={})


@register_op("models.yolo.Detect")
def lower_yolo_detect(op, cfg):
    strides = require_attr(op, "pnnx_5", 1).array().astype(np.float32)
    if strides.shape != (_NUM_LEVELS,):
        raise ValueError(f"YoloDetect {op.name}: bad strides {strides.shape}")

    weights: dict = {}
    num_anchors = num_info = None
    level_tables, level_hw = [], []
    for i in range(_NUM_LEVELS):
        w = require_attr(op, f"m.{i}.weight", 1).array()  # [E, C, 1, 1]
        b = require_attr(op, f"m.{i}.bias", 1).array()
        if w.shape[2] != 1 or w.shape[3] != 1:
            raise ValueError(f"YoloDetect {op.name}: head conv m.{i} must be "
                             f"1x1, got {w.shape}")
        weights[f"w{i}"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0))).astype(np.float32))  # HWIO
        weights[f"b{i}"] = torch.from_numpy(b.astype(np.float32))

        ag = require_attr(op, f"pnnx_{_ANCHOR_ATTR_INDEX[i]}", 1).array()
        gr = require_attr(op, f"pnnx_{_GRID_ATTR_INDEX[i]}", 1).array()
        for name, t in (("anchor_grid", ag), ("grid", gr)):
            if t.ndim != 5 or t.shape[0] != 1 or t.shape[4] != 2:
                raise ValueError(f"YoloDetect {op.name}: bad {name} shape "
                                 f"{t.shape} at level {i}")
        if ag.shape != gr.shape:
            raise ValueError(f"YoloDetect {op.name}: grid/anchor shape "
                             f"mismatch at level {i}")
        a = ag.shape[1]
        if num_anchors is None:
            num_anchors = a
        elif num_anchors != a:
            raise ValueError(f"YoloDetect {op.name}: anchor count varies")
        e = w.shape[0]
        if num_info is None:
            if e % a != 0:
                raise ValueError(f"YoloDetect {op.name}: head width {e} not "
                                 f"divisible by anchors {a}")
            num_info = e // a
        elif num_info != e // a:
            raise ValueError(f"YoloDetect {op.name}: head width varies")
        ni = e // a
        # channel-packed [H*W, A*ni] tables: gridc[p, a*ni+j] = grid[a,p,j]
        # for j<2; anchorc[p, a*ni+2+j] = anchor[a, p, j]
        hw = ag.shape[2] * ag.shape[3]
        gridc = np.zeros((hw, e), np.float32)
        anchorc = np.zeros((hw, e), np.float32)
        gr2, ag2 = gr.reshape(a, hw, 2), ag.reshape(a, hw, 2)
        for ai in range(a):
            gridc[:, ai * ni + 0] = gr2[ai, :, 0]
            gridc[:, ai * ni + 1] = gr2[ai, :, 1]
            anchorc[:, ai * ni + 2] = ag2[ai, :, 0]
            anchorc[:, ai * ni + 3] = ag2[ai, :, 1]
        level_tables.append((gridc, anchorc))
        level_hw.append(hw)
    weights.update({k: torch.from_numpy(v)
                    for k, v in detect_tables(level_tables).items()})

    na, ni = num_anchors, num_info
    chan = np.arange(na * ni) % ni
    # per-row stride and channel masks: constants of the op, not weights
    # (the JAX package folds the stride per level), made once per device
    host_consts = (
        torch.from_numpy(np.concatenate(
            [np.full((hw, 1), s, np.float32)
             for hw, s in zip(level_hw, strides)])),
        torch.from_numpy(chan < 2),
        torch.from_numpy((chan >= 2) & (chan < 4)))
    device_consts: dict = {}

    def apply(weights, *features):
        if len(features) != _NUM_LEVELS:
            raise ValueError("YoloDetect expects 3 feature maps")
        logits = []
        for i, x in enumerate(features):
            y = conv2d_nhwc(x, weights[f"w{i}"], weights[f"b{i}"])
            n, h, w_, c = y.shape
            logits.append(y.reshape(n, h * w_, c))
        yf = torch.sigmoid(torch.cat(logits, dim=1).float())
        consts = cached(device_consts, yf.device, lambda: tuple(
            t.to(yf.device) for t in host_consts), yf)
        stride_rows, xy_mask, wh_mask = consts
        y2 = yf * 2.0
        xy = (y2 + weights["grid"]) * stride_rows
        wh = torch.square(y2) * weights["anchor"]
        out = torch.where(xy_mask, xy, torch.where(wh_mask, wh, yf))
        return out.reshape(out.shape[0], out.shape[1] * na, ni)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={},  # head convs are accuracy-critical; keep fp
        # decode tables and head biases stay f32: grid coords up to ~80
        # would quantize to 0.25-cell steps in bf16
        fp32_keys=("b0", "b1", "b2", "grid", "anchor"),
    )
