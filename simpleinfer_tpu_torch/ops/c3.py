"""si.FusedC3 lowering — a whole YOLOv5 C3 block as one op
(counterpart of simpleinfer_tpu/ops/c3.py).

Created by ir/passes.fuse_c3_blocks from the YOLOv5 C3 pattern
(cv1 -> bottlenecks -> cat(cv2) -> cv3, zoo/builders.py c3()).

Dispatch, as in the JAX package: kernels/c3block.c3_block where
`kernel_ok` (kernels on, and the block passes c3_supported and
c3_profitable at its actual input), else the reference chain
(`c3_block_reference`: torch ops, cuDNN convs on the card), the
counterpart of the JAX package's lax chain. Static-int8 engines give
the kernel int8 3x3 taps where the JAX package does (kernel_ok and
c3_taps_s8_profitable); the reference chain always runs the fp taps,
its conv chain being the unfused engine's math. Weights stay float
(quantizable={}): the s8 taps are quantized here at load.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import PARAM_BOOL, PARAM_INT
from ..kernels import c3block as kc3
from .registry import OpImpl, register_op, require_attr, require_param


@register_op("si.FusedC3")
def lower_fused_c3(op, cfg):
    c_in = require_param(op, "in_channels", PARAM_INT).i
    hid = require_param(op, "hidden_channels", PARAM_INT).i
    oc = require_param(op, "out_channels", PARAM_INT).i
    n_btl = require_param(op, "n_bottlenecks", PARAM_INT).i
    shortcut = require_param(op, "shortcut", PARAM_BOOL).b
    act = (op.params["si_fused_act"].s
           if op.has_param("si_fused_act") else None)

    keys = ("cv1_w", "cv1_b", "cv2_w", "cv2_b", "cv3_w", "cv3_b",
            "btl_a_w", "btl_a_b", "btl_b_w", "btl_b_b")
    arrays = {k: require_attr(op, k).array().astype(np.float32)
              for k in keys}
    if arrays["cv1_w"].shape != (c_in, hid) \
            or arrays["cv3_w"].shape != (2 * hid, oc) \
            or arrays["btl_b_w"].shape != (n_btl, 9, hid, hid):
        raise ValueError(f"FusedC3 {op.name}: attr shapes do not match "
                         f"params (c={c_in}, hid={hid}, oc={oc}, "
                         f"T={n_btl})")
    weights = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in arrays.items()}

    # static-int8 engines get the s8 tap path: per-channel-quantized tap
    # weights prepared at load, activations quantized per image in the
    # kernel (no calibration needed)
    taps_s8 = cfg.quant == "int8"
    if taps_s8:
        wq, wsc = kc3.quantize_taps(arrays["btl_b_w"])
        weights["btl_b_wq"] = torch.from_numpy(wq)
        weights["btl_b_wsc"] = torch.from_numpy(wsc)
    use_kernels = cfg.kernels_enabled

    def apply(w, x):
        dt = x.dtype
        h, ww = x.shape[1], x.shape[2]
        kernel_ok = (use_kernels
                     and kc3.c3_supported(h, ww, c_in, hid, oc)
                     and kc3.c3_profitable(h, ww, hid, n_btl))
        s8 = taps_s8 and kernel_ok and kc3.c3_taps_s8_profitable(hid)
        args = (x, w["cv1_w"].to(dt), w["cv1_b"], w["cv2_w"].to(dt),
                w["cv2_b"], w["cv3_w"][:hid].to(dt), w["cv3_w"][hid:].to(dt),
                w["cv3_b"], w["btl_a_w"].to(dt), w["btl_a_b"],
                w["btl_b_wq"] if s8 else w["btl_b_w"].to(dt), w["btl_b_b"])
        scale = w["btl_b_wsc"] if s8 else None
        fn = kc3.c3_block if kernel_ok else kc3.c3_block_reference
        return fn(*args, btl_b_scale=scale, activation=act,
                  shortcut=shortcut)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        # dequant scales are precision-critical (and tiny)
        fp32_keys=("btl_b_wsc",),
    )
