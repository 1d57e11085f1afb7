"""si.FusedC3 lowering — a whole YOLOv5 C3 block as one op
(counterpart of simpleinfer_tpu/ops/c3.py).

Created by ir/passes.fuse_c3_blocks from the YOLOv5 C3 pattern
(cv1 -> bottlenecks -> cat(cv2) -> cv3, zoo/builders.py c3()).

Dispatch: kernels/c3block.c3_block where `kernel_ok` (kernels on, and
the block passes c3_supported and c3_profitable, at C3_MIN_WORK as
measured on the H100, at its actual input), else the chain of the
unfused convs,
the counterpart of the JAX package's lax chain: on the card in bf16
`c3_chain` (bf16 operands on the library, as the JAX chain runs bf16
operands on the MXU with f32 sums), otherwise `c3_block_reference` (f32
sums of the operands at x's dtype: the CPU path, fp32 on the card, and
the oracle the kernel and `c3_chain` are held to). Static-int8 engines
give a block int8 3x3 taps exactly where the JAX package does (kernels
on, c3_supported, c3_profitable at the JAX package's JAX_C3_MIN_WORK and
c3_taps_s8_profitable), whichever route runs it: the taps are the
reference's numerics, so the H100's gate moves no block between s8 and
fp taps. Weights stay float (quantizable={}): the s8 taps are quantized
here at load.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.graph import PARAM_BOOL, PARAM_INT
from ..kernels import c3block as kc3
from ..kernels.matmul import resolve_activation
from .conv import s8_product
from .registry import OpImpl, register_op, require_attr, require_param


def _mm_f32(t, w):
    """t [..., K] @ w [K, N] with the operands at t's dtype and an f32
    result: on the card one library GEMM (bf16 operands, f32 sums and
    out: torch.mm's out_dtype), on the CPU the same sums in f32."""
    t2 = t.reshape(-1, t.shape[-1])
    w = w.to(t.dtype)
    if t.device.type == "cuda":
        y = torch.mm(t2, w, out_dtype=torch.float32)
    else:
        y = t2.float() @ w.float()
    return y.reshape(*t.shape[:-1], w.shape[1])


def _im2col3x3(t):
    """The 3x3 "same" im2col of NHWC t [N, H, W, C]: [N*H*W, 9*C], tap-
    major (dy, dx, c) as the [9, C, OC] taps flatten, zeros off the
    image; one concatenation of the 9 shifted views of the padded map,
    moved as 8-byte words where C allows (the strided copy's cost is per
    element, so 2- and 1-byte elements made it 4-8x slower)."""
    n, h, w, c = t.shape
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    if (c * t.element_size()) % 8 == 0:
        tp = tp.view(torch.int64)
    cols = torch.cat([tp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1)
    return cols.view(t.dtype).reshape(n * h * w, 9 * c)


def c3_chain(x, cv1_w, cv1_b, cv2_w, cv2_b, cv3_w1, cv3_w2, cv3_b,
             btl_a_w, btl_a_b, btl_b_w, btl_b_b, btl_b_scale=None,
             activation: str | None = "silu", shortcut: bool = True):
    """The C3 block as a chain of library GEMMs with bf16 operands, with
    the arguments of kernels/c3block.c3_block: each 1x1 one GEMM of the
    operands at x's dtype with an f32 result (torch.mm's out_dtype on the
    card), then f32 bias and activation and one rounding to x's dtype;
    each fp 3x3 the same GEMM over the activation's im2col (`_im2col3x3`)
    and the taps [9*hid, hid]; s8 taps quantize the bottleneck's f32
    activation per image and take the exact s32 product of its int8
    im2col (ops/conv.s8_product: torch._int_mm on the card). The route
    ops/c3.py takes on the card in bf16 below the kernel's gate or with
    kernels off: c3_block_reference's sums in another order, one
    rounding per conv as there (cuDNN's bf16 conv rounds its sums to bf16
    before the bias, which took the chain past c3_block's bf16 limit of
    the reference at the tests' widths)."""
    act = resolve_activation(activation) if activation else (lambda v: v)
    dt = x.dtype

    def conv1x1(t, wm, bias, keep_f32=False):
        y = act(_mm_f32(t, wm) + bias.float())
        return y if keep_f32 else y.to(dt)

    def conv3x3(t, w9, bias):
        y = _mm_f32(_im2col3x3(t), w9.reshape(-1, w9.shape[2]))
        y = y.reshape(*t.shape[:3], -1)
        return act(y + bias.float()).to(dt)

    def conv3x3_s8(t_f32, wq9, wscale, bias):
        # per-IMAGE dynamic activation quant, as c3_block_reference
        amax = t_f32.abs().amax(dim=(1, 2, 3), keepdim=True)
        ascale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(t_f32 / ascale), -127.0, 127.0)
        zi = s8_product(_im2col3x3(q.to(torch.int8)),
                        wq9.reshape(-1, wq9.shape[2]))
        y = zi.reshape(*q.shape[:3], -1).float() * (ascale * wscale.float())
        return act(y + bias.float()).to(dt)

    y1 = conv1x1(x, cv1_w, cv1_b)
    for t in range(btl_a_w.shape[0]):
        if btl_b_scale is not None:
            af = conv1x1(y1, btl_a_w[t], btl_a_b[t], keep_f32=True)
            z = conv3x3_s8(af, btl_b_w[t], btl_b_scale[t], btl_b_b[t])
        else:
            a = conv1x1(y1, btl_a_w[t], btl_a_b[t])
            z = conv3x3(a, btl_b_w[t], btl_b_b[t])
        y1 = z + y1 if shortcut else z
    y2 = conv1x1(x, cv2_w, cv2_b)
    cat = torch.cat([y1, y2], dim=-1)
    return conv1x1(cat, torch.cat([cv3_w1.to(dt), cv3_w2.to(dt)], 0), cv3_b)


def c3_routes(h, w, c_in, hid, oc, n_btl, taps_s8: bool,
              use_kernels: bool) -> tuple:
    """(kernel_ok, s8) of a fused block at input h x w: the kernel where
    kernels are on and the block passes c3_supported and c3_profitable
    (C3_MIN_WORK, the H100's); int8 taps where the JAX package gives
    them: a static-int8 engine (`taps_s8`), kernels on, c3_supported,
    c3_profitable at JAX_C3_MIN_WORK and c3_taps_s8_profitable."""
    supported = use_kernels and kc3.c3_supported(h, w, c_in, hid, oc)
    kernel_ok = supported and kc3.c3_profitable(h, w, hid, n_btl)
    s8 = (taps_s8 and supported and kc3.c3_taps_s8_profitable(hid)
          and kc3.c3_profitable(h, w, hid, n_btl, kc3.JAX_C3_MIN_WORK))
    return kernel_ok, s8


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
        kernel_ok, s8 = c3_routes(h, ww, c_in, hid, oc, n_btl, taps_s8,
                                  use_kernels)
        args = (x, w["cv1_w"].to(dt), w["cv1_b"], w["cv2_w"].to(dt),
                w["cv2_b"], w["cv3_w"][:hid].to(dt), w["cv3_w"][hid:].to(dt),
                w["cv3_b"], w["btl_a_w"].to(dt), w["btl_a_b"],
                w["btl_b_wq"] if s8 else w["btl_b_w"].to(dt), w["btl_b_b"])
        scale = w["btl_b_wsc"] if s8 else None
        if kernel_ok:
            fn = kc3.c3_block
        elif x.device.type == "cuda" and dt == torch.bfloat16:
            fn = c3_chain
        else:
            fn = kc3.c3_block_reference
        return fn(*args, btl_b_scale=scale, activation=act,
                  shortcut=shortcut)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        # the five 1x1s and T 3x3s of the block, per output pixel
        flops_per_pixel=2 * (2 * c_in * hid + n_btl * 10 * hid * hid
                             + 2 * hid * oc),
        # dequant scales are precision-critical (and tiny)
        fp32_keys=("btl_b_wsc",),
    )
