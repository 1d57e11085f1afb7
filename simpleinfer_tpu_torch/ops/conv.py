"""nn.Conv2d lowering — NHWC conv (counterpart of simpleinfer_tpu/ops/conv.py).

Params padding_mode / padding / kernel_size / stride / dilation / groups
/ in_channels / out_channels / bias; weight OIHW transformed to HWIO at
load (the JAX package's layout, so weights and quantized bytes compare
one to one); zero / replicate / reflect padding; grouped conv.

Paths, as in the JAX package minus its TPU layout means (the W-packed
stem/`PackedW` chain):
- static int8 (quant="int8" after Engine.calibrate installed an
  `act_scale`, for convs inside the `int8_conv_eligible` gate, or an int8
  input from a chained producer): `conv2d_int8_static` quantizes the
  activation, pads the int8 tensor, lays it out as an int8 im2col in
  HWIO order and runs kernels/matmul.matmul_s8s8, an exact s8 x s8 -> s32
  product with the dequant / bias / activation epilogue (with kernels
  off, torch._int_mm's s32 product: `matmul_s8s8_library`). PyTorch has
  no int8 convolution on CUDA; the JAX package takes XLA's s8 conv;
- pointwise (1x1 s1 p0 d1 g1) int8w convs ARE matmuls: with kernels on
  they run as one launch of kernels/matmul.matmul_int8w on the [N*H*W, C]
  view, dequant + bias + activation in its epilogue;
- convs over a channel concat that ir/passes.fuse_cat_conv1x1 removed
  run as a sum of per-source partial convs (`_apply_split`);
- everything else runs `F.conv2d` on the channels-last NCHW view of the
  NHWC tensor and permutes back.
A chain producer (ir/passes.mark_int8_chains) requantizes its result to
its consumer's scale and hands it on as a QuantizedActivation
(`_finish`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.graph import PARAM_AINT, PARAM_BOOL, PARAM_INT, PARAM_STR
from ..kernels import matmul as kmm
from ..quant.tensor import (QuantizedActivation, QuantizedTensor,
                            quantize_act, resolve_weight)
from .registry import OpImpl, register_op, require_attr, require_param

# input-channel threshold of the JAX package's space-to-depth stem
# rewrite; the port keeps the predicate so both packages give the same
# ops a per-channel activation fold (OpImpl.act_fold)
_S2D_MAX_IC = 8


def _finish(out_f32, out_dtype, out_quant_scale):
    """Close a conv epilogue: cast to the activation dtype, or — for a
    marked int8 chain (ir/passes.mark_int8_chains) — requantize the f32
    result to the consumer's scale and hand on 1-byte data."""
    if out_quant_scale is not None:
        return QuantizedActivation(
            data=quantize_act(out_f32, out_quant_scale),
            scale=out_quant_scale)
    return out_f32.to(out_dtype)


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x, w, bias=None, *, stride=(1, 1), padding=((0, 0), (0, 0)),
                dilation=(1, 1), groups=1, padding_mode="zeros",
                activation=None, out_quant_scale=None):
    """Functional NHWC conv.

    `w` is HWIO (or a QuantizedTensor of it); `padding` is
    ((top, bottom), (left, right)); `activation` is an optional fused
    epilogue name (kernels/matmul.resolve_activation); `out_quant_scale`
    requantizes the result to int8 (see `_finish`). Runs in x's dtype
    (TF32 is the caller's to switch off; Engine.forward does in fp32).
    """
    w = resolve_weight(w, x.dtype)
    xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    (pt, pb), (pl, pr) = padding
    if padding_mode != "zeros":
        xn = F.pad(xn, (pl, pr, pt, pb), mode=padding_mode)
        pad = (0, 0)
    elif pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xn = F.pad(xn, (pl, pr, pt, pb))
        pad = (0, 0)
    b = None if bias is None else bias.to(x.dtype)
    out = F.conv2d(xn, _oihw(w), b, tuple(stride), pad, tuple(dilation),
                   groups)
    if activation is not None:
        out = kmm.resolve_activation(activation)(out)
    if out_quant_scale is not None:
        return _finish(_nhwc(out.float()), None, out_quant_scale)
    return _nhwc(out)


# static-int8 dispatch gate: the defaults of the JAX package's
# EngineConfig.int8_min_channels / int8_pointwise, its TPU v5e
# measurement (s8 convs won only on k>1 convs with >= 128 input
# channels); kept so both packages take the same paths, to be
# re-measured on the H100. Convs outside it run the weight-only path.
INT8_MIN_CHANNELS = 128
INT8_POINTWISE = False


def int8_conv_eligible(kernel_area: int, in_channels: int,
                       min_channels: int = INT8_MIN_CHANNELS,
                       pointwise_ok: bool = INT8_POINTWISE) -> bool:
    """The static-int8 dispatch gate — single source of truth for the
    conv lowering AND ir/passes.mark_int8_chains."""
    return (in_channels >= min_channels
            and (kernel_area > 1 or pointwise_ok))


def int_mm_ok(q, w_q) -> bool:
    """Whether torch._int_mm takes q [M, K] @ w_q [K, N] (int8, on the
    card): its shape rules, M > 16 and K, N positive multiples of 8."""
    m, k = q.shape
    n = w_q.shape[1]
    return (q.device.type == "cuda" and m > 16 and k > 0 and k % 8 == 0
            and n > 0 and n % 8 == 0)


def s8_product(q, w_q):
    """The exact s8 x s8 sum of q [M, K] @ w_q [K, N]: torch._int_mm's
    s32 on the card where its shape rules allow (the library route, as
    XLA's s32 conv is the JAX package's), else float64 (|acc| <= K *
    127^2, far below 2^53, so every sum is exact; the CPU, and the shapes
    _int_mm refuses). The two are the same integers. A K-major w_q (the
    layout Engine.place_weights gives static-int8 weights) goes to
    _int_mm as it is, any other as a row-major copy."""
    if int_mm_ok(q, w_q):
        w = w_q if kmm.k_major(w_q) else w_q.contiguous()
        return torch._int_mm(q.contiguous(), w)
    return q.double() @ w_q.double()


def matmul_s8s8_library(x_q, w_q, scale, bias=None, activation=None,
                        out_dtype=torch.bfloat16):
    """The static-int8 product with kernels off: `s8_product`, then the
    f32 epilogue of kernels/matmul.matmul_s8s8_ref (which stays the
    float64 oracle of the kernel). Bit-equal to matmul_s8s8_ref: both
    sums are the exact integers, rounded once to f32."""
    out = s8_product(x_q, w_q).float() * scale.float()
    if bias is not None:
        out = out + bias.float()
    return kmm.resolve_activation(activation)(out).to(out_dtype)


def int8_epilogue(q, w_q, act_scale, w_scale, bias, activation, out_dtype,
                  out_quant_scale=None, *, use_kernels: bool = True):
    """The s8 x s8 -> s32 product of every static-int8 site (conv,
    cat-split conv, linear) and its dequant + bias + activation
    epilogue, in one place: q [M, K] int8 @ w_q [K, N] int8 through
    kernels/matmul.matmul_s8s8, or with kernels off through
    `matmul_s8s8_library` (torch._int_mm on the card). Where the JAX
    package's int8_epilogue takes XLA's s32 accumulator, the port's
    accumulator stays inside the kernel, so this takes the operands.

    A rank-1 `act_scale` means per-CHANNEL activation scales, which were
    FOLDED into the quantized weight at install time
    (engine._install_act_scales, see OpImpl.act_fold): the dequant is
    then `w_scale` alone."""
    scale = w_scale if act_scale.ndim else act_scale * w_scale
    mm = kmm.matmul_s8s8 if use_kernels else matmul_s8s8_library
    if out_quant_scale is not None:
        out = mm(q, w_q, scale, bias, activation, out_dtype=torch.float32)
        return _finish(out, None, out_quant_scale)
    return mm(q, w_q, scale, bias, activation, out_dtype=out_dtype)


def _pad_index(n: int, before: int, after: int, mode: str, device):
    """Source indices of a padded axis: edge-clamped (replicate) or
    mirrored without the edge (reflect, numpy's and torch's)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _pad_int8(q, padding, padding_mode):
    """Pad the 1-byte NHWC tensor itself: zeros are exact in the
    quantized domain (symmetric quant: 0 <-> 0.0); replicate / reflect
    gather rows and columns by index (torch's replicate / reflect pads
    take no int8)."""
    (pt, pb), (pl, pr) = padding
    if not (pt or pb or pl or pr):
        return q
    if padding_mode == "zeros":
        return F.pad(q, (0, 0, pl, pr, pt, pb))
    hi = _pad_index(q.shape[1], pt, pb, padding_mode, q.device)
    wi = _pad_index(q.shape[2], pl, pr, padding_mode, q.device)
    return q[:, hi][:, :, wi].contiguous()


def conv2d_int8_static(x, wq: QuantizedTensor, act_scale, bias=None, *,
                       stride=(1, 1), padding=((0, 0), (0, 0)),
                       dilation=(1, 1), groups=1, padding_mode="zeros",
                       activation=None, out_quant_scale=None,
                       out_dtype=None, use_kernels: bool = True):
    """Static full-int8 NHWC conv: quantize the activation (scale from
    Engine.calibrate), pad the int8 tensor, lay it out as an int8 im2col
    [N*OH*OW, KH*KW*IC/g] in HWIO order (kh, kw, ic), so that K lines up
    with wq.data.reshape(-1, OC), and take the exact s8 x s8 -> s32
    product with its dequant by act_scale * w_scale[oc], bias and
    activation in the epilogue (`int8_epilogue`; one product per group).

    `x` may be a QuantizedActivation from a chained producer (its own
    quantize pass is then skipped); `out_quant_scale` requantizes the
    result for the next chained consumer (see `_finish`)."""
    if isinstance(x, QuantizedActivation):
        q, act_scale = x.data, x.scale
        out_dtype = out_dtype or torch.bfloat16
    else:
        q = quantize_act(x, act_scale)
        out_dtype = out_dtype or x.dtype
    q = _pad_int8(q.contiguous(), padding, padding_mode)
    kh, kw, icg, oc = wq.data.shape
    (sh, sw), (dh, dw) = stride, dilation
    n, hp, wp, c = q.shape
    oh = (hp - dh * (kh - 1) - 1) // sh + 1
    ow = (wp - dw * (kw - 1) - 1) // sw + 1
    sn, sH, sW, sc = q.stride()
    cols = q.as_strided((n, oh, ow, kh, kw, c),
                        (sn, sH * sh, sW * sw, sH * dh, sW * dw, sc))
    ocg = oc // groups
    m = n * oh * ow
    if groups == 1:
        out = int8_epilogue(cols.reshape(m, kh * kw * c),
                            wq.data.reshape(-1, oc), act_scale, wq.scale,
                            bias, activation, out_dtype, out_quant_scale,
                            use_kernels=use_kernels)
        if isinstance(out, QuantizedActivation):
            out.data = out.data.reshape(n, oh, ow, oc)
            return out
        return out.reshape(n, oh, ow, oc)
    parts = []
    for g in range(groups):
        sl = slice(g * ocg, (g + 1) * ocg)
        parts.append(int8_epilogue(
            cols[..., g * icg:(g + 1) * icg].reshape(m, kh * kw * icg),
            wq.data[..., sl].reshape(-1, ocg), act_scale,
            wq.scale[sl].contiguous(),
            None if bias is None else bias[sl].contiguous(), activation,
            torch.float32, use_kernels=use_kernels))
    out = torch.cat(parts, dim=-1).reshape(n, oh, ow, oc)
    return _finish(out, out_dtype, out_quant_scale)


@register_op("nn.Conv2d")
def lower_conv2d(op, cfg):
    padding_mode = require_param(op, "padding_mode", PARAM_STR).s
    if padding_mode not in ("zeros", "replicate", "reflect"):
        raise ValueError(f"Conv2d {op.name}: unsupported padding_mode "
                         f"{padding_mode!r}")
    padding = require_param(op, "padding", PARAM_AINT).ai
    kernel = require_param(op, "kernel_size", PARAM_AINT).ai
    stride = require_param(op, "stride", PARAM_AINT).ai
    dilation = require_param(op, "dilation", PARAM_AINT).ai
    groups = require_param(op, "groups", PARAM_INT).i
    in_channels = require_param(op, "in_channels", PARAM_INT).i
    out_channels = require_param(op, "out_channels", PARAM_INT).i
    use_bias = require_param(op, "bias", PARAM_BOOL).b

    w = require_attr(op, "weight", 1).array()  # OIHW fp32
    if list(w.shape) != [out_channels, in_channels // groups, *kernel]:
        raise ValueError(f"Conv2d {op.name}: weight shape {w.shape} does not "
                         f"match params")
    w_hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
    weights = {"weight": torch.from_numpy(w_hwio.astype(np.float32))}
    if use_bias:
        b = require_attr(op, "bias", 1).array()
        weights["bias"] = torch.from_numpy(b.astype(np.float32))

    pad = ((padding[0], padding[0]), (padding[1], padding[1]))
    stride_t, dilation_t = tuple(stride), tuple(dilation)
    fused_act = (op.params["si_fused_act"].s
                 if op.has_param("si_fused_act") else None)
    # int8-chain producer marker (ir/passes.mark_int8_chains): the name
    # of the consumer whose calibrated act_scale this conv requantizes
    # its output to (Engine.calibrate installs `out_scale`)
    q_consumer = (op.params["si_q_out"].s
                  if op.has_param("si_q_out") else None)
    pointwise = (tuple(kernel) == (1, 1) and stride_t == (1, 1)
                 and pad == ((0, 0), (0, 0)) and dilation_t == (1, 1)
                 and groups == 1)
    use_kernels = cfg.kernels_enabled
    cat_inputs = op.has_param("si_cat_inputs")
    int8_profitable = int8_conv_eligible(kernel[0] * kernel[1], in_channels)
    # the JAX package's W-stride-2 small-ic stem (its packed path, which
    # takes no folded weight)
    s2d_eligible = (stride_t[1] == 2 and dilation_t == (1, 1)
                    and groups == 1 and padding_mode == "zeros"
                    and in_channels <= _S2D_MAX_IC)

    def _apply_split(weights, xs):
        """conv1x1 over a (never materialized) channel concat: slice the
        weight per source and sum the partial convs. See
        ir/passes.fuse_cat_conv1x1."""
        w, bias = weights["weight"], weights.get("bias")
        act_scale = weights.get("act_scale")
        if (act_scale is not None and isinstance(w, QuantizedTensor)
                and int8_conv_eligible(1, in_channels)):
            # static int8: every source shares the cat's per-tensor
            # scale, so the int8 sources side by side times the whole
            # weight is the exact sum of the per-source s32 products
            q = torch.cat([quantize_act(x, act_scale) for x in xs], -1)
            n, h, wd, c = q.shape
            out = int8_epilogue(q.reshape(-1, c),
                                w.data.reshape(c, -1),
                                act_scale, w.scale, bias, fused_act,
                                xs[0].dtype, use_kernels=use_kernels)
            return out.reshape(n, h, wd, -1)
        dtype = xs[0].dtype
        wd = resolve_weight(w, dtype)  # dequant once, slice per source
        # partial sums carry at the compute dtype in bf16 mode (each conv
        # accumulates its own K in f32); the final sum is f32
        acc, ofs = None, 0
        for i, x in enumerate(xs):
            c = x.shape[-1]
            y = F.conv2d(x.permute(0, 3, 1, 2), _oihw(wd[:, :, ofs:ofs + c]))
            ofs += c
            if acc is None:
                acc = y
            elif i == len(xs) - 1:
                acc = acc.float() + y.float()
            else:
                acc = acc + y
        acc = acc.permute(0, 2, 3, 1)  # NHWC view: channels last
        if bias is not None:
            acc = acc + bias.float()
        if fused_act is not None:
            acc = kmm.resolve_activation(fused_act)(acc)
        return acc.to(dtype).contiguous()

    def apply(weights, *xs):
        if cat_inputs and len(xs) > 1:
            return _apply_split(weights, list(xs))
        (x,) = xs
        w, bias = weights["weight"], weights.get("bias")
        # requant target of a marked int8 chain, installed by
        # Engine.calibrate alongside act_scale
        out_scale = weights.get("out_scale")
        if isinstance(x, QuantizedActivation):
            if not isinstance(w, QuantizedTensor):
                x = x.dequantize()
            else:
                return conv2d_int8_static(
                    x, w, None, bias,
                    stride=stride_t, padding=pad, dilation=dilation_t,
                    groups=groups, padding_mode=padding_mode,
                    activation=fused_act, out_quant_scale=out_scale,
                    out_dtype=cfg.compute_torch_dtype,
                    use_kernels=use_kernels)
        act_scale = weights.get("act_scale")
        if (act_scale is not None and isinstance(w, QuantizedTensor)
                and int8_profitable):
            return conv2d_int8_static(
                x, w, act_scale, bias,
                stride=stride_t, padding=pad, dilation=dilation_t,
                groups=groups, padding_mode=padding_mode,
                activation=fused_act, out_quant_scale=out_scale,
                use_kernels=use_kernels)
        if pointwise and use_kernels and isinstance(w, QuantizedTensor):
            n, h, wd, c = x.shape
            out = kmm.matmul_int8w(
                x.reshape(n * h * wd, c),
                w.data.reshape(c, -1),  # HWIO 1x1 -> [K, N]
                w.scale, bias, fused_act,
                out_dtype=None if out_scale is None else torch.float32)
            out = out.reshape(n, h, wd, -1)
            if out_scale is not None:
                return _finish(out, None, out_scale)
            return out
        return conv2d_nhwc(
            x, w, bias,
            stride=stride_t, padding=pad, dilation=dilation_t,
            groups=groups, padding_mode=padding_mode,
            activation=fused_act, out_quant_scale=out_scale)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"weight": 3},  # HWIO: out channels on axis 3
        # the JAX package's hints; a grouped conv declares none: its
        # output-channel shard would read an input-channel slice that
        # the op's fixed `groups` cannot take, so it runs replicated
        shard_hints=({"weight": (None, None, None, "model"),
                      "bias": ("model",)} if groups == 1 else {}),
        # FLOPs at batch 1: 2 * OH*OW * OC * (IC/g) * KH*KW; the
        # executor multiplies the per-pixel term by OH*OW
        flops_per_pixel=(2 * out_channels * (in_channels // groups)
                         * kernel[0] * kernel[1]),
        fp32_keys=("act_scale", "out_scale"),  # quant scales stay f32
        act_quant=True,
        # per-channel act scales fold into HWIO axis 2 (input channels),
        # only where the int8 branch is statically guaranteed: a folded
        # weight is wrong on every other path. The JAX package also
        # excludes its packed-chain consumers (ic <= 64, outside the
        # int8 gate at its default)
        act_fold=((-1, 2) if (groups == 1 and not cat_inputs
                              and not s2d_eligible and int8_profitable)
                  else None),
        q_out_consumer=q_consumer,
        s8_weight=int8_profitable,
    )
