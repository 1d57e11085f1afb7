#!/usr/bin/env python3
"""Controls for chip_smoke.py's kernels-on-vs-off checks: can their
limits tell a kernel that is wrong from bf16 and int8 noise?

    python3 scripts/torch_onoff_control.py          # llama (phase 7)
    python3 scripts/torch_onoff_control.py --int8   # yolov5l int8 + C3
    python3 scripts/torch_onoff_control.py --resnet # ResNet-50 int8

Loads the llama "base" bf16 int4w engine (kernels on), the same graph
with use_kernels=False, and the fp32 yardstick, as chip_smoke.py does,
and reads phase 7 once as it is (sound), then once per control, each
putting a plain PyTorch stand-in in place of one kernel wrapper for
bf16 inputs (the fp32 yardstick keeps the real kernels):

- int4w_bf16_dequant: matmul_int4w dequantizes to bf16 and multiplies
  in bf16, as the torch path does (a precision change, not a fault);
- flash_bf16_p: flash_attention rounds P to bf16 before P.V (its plain
  version; a precision change, not a fault);
- flash_causal_off_by_one: each query also sees the next key (a fault);
- int4w_nibbles_swapped: matmul_int4w reads each packed byte's high
  nibble as its low one and the low as the high, so the two halves of
  every K-group trade places (a fault).

With --int8: the yolov5l-640-b16 bf16 int8 c3_fusion engine (kernels
on, calibrated) against the same graph and scales with use_kernels=False,
as chip_smoke.py's yolo_int8 phase compares them (box and scores each
against its own scale), sound and with:

- s8s8_bf16_product: matmul_s8s8 multiplies in bf16 and rounds the
  product to bf16 before the epilogue (a precision change, not a fault);
- s8s8_drop_k_tile: matmul_s8s8 loses the last 64 of K (a fault);
- int8w_drop_k_tile: matmul_int8w (the path's 3 weight-only pointwise
  convs) loses the last 32 of K (a fault);
- c3_fp_taps: c3_block runs fp taps where it takes s8 ones (a precision
  change, not a fault);
- c3_taps_mirrored: c3_block's 3x3 taps read x + dx as x - dx (a fault).

With --resnet: the ResNet-50-224-b128 bf16 int8 engine (kernels on,
calibrated) against the same graph and scales with use_kernels=False,
as chip_smoke.py's resnet_int8 phase compares their logits, sound and
with s8s8_bf16_product and s8s8_drop_k_tile as above, and
int8w_drop_k_tile on the path's 33 pointwise convs (a fault).

Prints one JSON line of readings per run, each with whether
chip_smoke's check fails it, then a summary line. Needs a CUDA card.
"""
from __future__ import annotations

import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def int4w_bf16_dequant(orig):
    import torch
    from simpleinfer_tpu_torch.kernels.matmul import resolve_activation

    def fn(x, wq4, bias=None, activation=None, *, out_dtype=None):
        if x.dtype != torch.bfloat16:
            return orig(x, wq4, bias, activation, out_dtype=out_dtype)
        out = torch.matmul(x, wq4.dequantize(torch.bfloat16)).float()
        if bias is not None:
            out = out + bias.float()
        return resolve_activation(activation)(out).to(out_dtype or x.dtype)
    return fn


def flash_bf16_p(orig):
    import torch
    from simpleinfer_tpu_torch.kernels.attention import flash_attention_ref

    def fn(q, k, v, **kw):
        if q.dtype != torch.bfloat16:
            return orig(q, k, v, **kw)
        return flash_attention_ref(q, k, v, **kw)
    return fn


def flash_causal_off_by_one(orig):
    import torch

    def fn(q, k, v, *, causal=False, scale=None, sliding_window=None):
        if q.dtype != torch.bfloat16:
            return orig(q, k, v, causal=causal, scale=scale,
                        sliding_window=sliding_window)
        scale = scale or 1.0 / math.sqrt(q.shape[-1])
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones((lq, lk), dtype=torch.bool,
                          device=s.device).tril(diagonal=1)
        s = s.masked_fill(~keep, float("-inf"))
        return torch.matmul(torch.softmax(s, -1).to(q.dtype), v)
    return fn


def int4w_nibbles_swapped(orig):
    import torch
    from simpleinfer_tpu_torch.quant.tensor import Quantized4Tensor

    swapped = {}     # per weight: its bytes with the nibbles swapped

    def fn(x, wq4, bias=None, activation=None, *, out_dtype=None):
        if x.dtype != torch.bfloat16:
            return orig(x, wq4, bias, activation, out_dtype=out_dtype)
        key = wq4.packed.data_ptr()
        if key not in swapped:
            p = wq4.packed.to(torch.int32) & 0xFF
            b = (((p & 0xF) << 4) | (p >> 4)).to(torch.uint8)
            swapped[key] = Quantized4Tensor(packed=b.view(torch.int8),
                                            scale=wq4.scale,
                                            group=wq4.group, k=wq4.k)
        return orig(x, swapped[key], bias, activation, out_dtype=out_dtype)
    return fn


def s8s8_bf16_product(orig):
    import torch
    from simpleinfer_tpu_torch.kernels.matmul import resolve_activation

    def fn(x_q, w_q, scale, bias=None, activation=None, *,
           out_dtype=torch.bfloat16):
        acc = torch.matmul(x_q.to(torch.bfloat16), w_q.to(torch.bfloat16))
        out = acc.float() * scale.float()
        if bias is not None:
            out = out + bias.float()
        return resolve_activation(activation)(out).to(out_dtype)
    return fn


def s8s8_drop_k_tile(orig):
    from simpleinfer_tpu_torch.kernels.matmul import to_k_major

    def fn(x_q, w_q, scale, bias=None, activation=None, **kw):
        k = max(x_q.shape[1] - 64, 1)
        # w keeps the K-major layout the engine placed it in
        return orig(x_q[:, :k].contiguous(), to_k_major(w_q[:k]), scale,
                    bias, activation, **kw)
    return fn


def int8w_drop_k_tile(orig):
    def fn(x, w_q, scale, bias=None, activation=None, **kw):
        k = max(x.shape[1] - 32, 1)
        return orig(x[:, :k].contiguous(), w_q[:k].contiguous(), scale,
                    bias, activation, **kw)
    return fn


def c3_fp_taps(orig):
    def fn(x, *args, btl_b_scale=None, **kw):
        if btl_b_scale is None:
            return orig(x, *args, **kw)
        args = list(args)
        args[9] = (args[9].float() * btl_b_scale.float()[:, None, None, :]
                   ).to(x.dtype)
        return orig(x, *args, **kw)
    return fn


def c3_taps_mirrored(orig):
    def fn(x, *args, **kw):
        args = list(args)
        # tap = kh*3 + kw: swap kw 0 and 2
        args[9] = args[9][:, [2, 1, 0, 5, 4, 3, 8, 7, 6]].contiguous()
        return orig(x, *args, **kw)
    return fn


INT8_CONTROLS = {"s8s8_bf16_product": ("matmul", "matmul_s8s8",
                                       s8s8_bf16_product),
                 "s8s8_drop_k_tile": ("matmul", "matmul_s8s8",
                                      s8s8_drop_k_tile),
                 "int8w_drop_k_tile": ("matmul", "matmul_int8w",
                                       int8w_drop_k_tile),
                 "c3_fp_taps": ("c3block", "c3_block", c3_fp_taps),
                 "c3_taps_mirrored": ("c3block", "c3_block",
                                      c3_taps_mirrored)}

RESNET_CONTROLS = {k: INT8_CONTROLS[k] for k in (
    "s8s8_bf16_product", "s8s8_drop_k_tile", "int8w_drop_k_tile")}

CONTROLS = {"int4w_bf16_dequant": ("matmul", "matmul_int4w",
                                   int4w_bf16_dequant),
            "flash_bf16_p": ("attention", "flash_attention", flash_bf16_p),
            "flash_causal_off_by_one": ("attention", "flash_attention",
                                        flash_causal_off_by_one),
            "int4w_nibbles_swapped": ("matmul", "matmul_int4w",
                                      int4w_nibbles_swapped)}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_onoff_control.py needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(cs.device_and_build(device)["nvidia_smi"], flush=True)
    if "--resnet" in sys.argv[1:]:
        on, in_name, out_name = cs.resnet_engine(device, True)
        off = cs.resnet_engine(device, False)[0]
        run = cs.resnet_main_path(device, (on, off, in_name, out_name))
        del run["recorder"]
        summary = run_int8_controls(on, off, out_name, run["feeds"],
                                    RESNET_CONTROLS, resnet=True)
        print(json.dumps({"limits": {"on_vs_off": cs.RESNET_ONOFF_TOL},
                          "summary": summary}), flush=True)
        return 0 if not summary["sound"]["caught"] else 1
    if "--int8" in sys.argv[1:]:
        on, in_name, out_name = cs.int8_engine(device, True)
        off = cs.int8_engine(device, False)[0]
        run = cs.int8_main_path(device, (on, off, in_name, out_name))
        summary = run_int8_controls(on, off, out_name, run["feeds"])
        print(json.dumps({"limits": {"on_vs_off": cs.INT8_ONOFF_TOL},
                          "summary": summary}), flush=True)
        return 0 if not summary["sound"]["caught"] else 1
    on, _, _ = cs.llama_engine(device)
    off, _, _ = cs.llama_engine(device, use_kernels=False)
    ref, _, _ = cs.llama_engine(device, compute="float32")
    summary = run_controls(on, off, ref, device)
    print(json.dumps({"limits": {"on_vs_off": [cs.ONOFF_MAX_TOL,
                                               cs.ONOFF_MEAN_TOL],
                                 "vs_fp32_ratio": cs.ONOFF_VS_FP32},
                      "summary": summary}), flush=True)
    return 0 if not summary["sound"]["caught"] else 1


def run_controls(on, off, ref, device, **onoff_kw) -> dict:
    """Phase 7's readings, sound and under each control, and whether
    check_onoff fails each."""
    import importlib

    import chip_smoke as cs

    summary = {}
    for name in ("sound", *CONTROLS):
        restore = None
        if name != "sound":
            mod_name, attr, make = CONTROLS[name]
            mod = importlib.import_module(
                f"simpleinfer_tpu_torch.kernels.{mod_name}")
            restore = (mod, attr, getattr(mod, attr))
            setattr(mod, attr, make(restore[2]))
        try:
            res = cs.onoff(on, off, device, ref, **onoff_kw)
        finally:
            if restore:
                setattr(*restore)
        try:
            cs.check_onoff(res)
            failed = None
        except AssertionError as e:
            failed = str(e)[:200]
        v = res["vs_fp32"]
        summary[name] = {
            "caught": failed is not None,
            **{part: {"on_vs_off": [res[part]["max_abs_over_scale"],
                                    res[part]["mean_abs_over_scale"]],
                      "vs_fp32_ratio": [
                          v[part]["on"][k] / v[part]["off"][k]
                          for k in ("max_abs_over_scale",
                                    "mean_abs_over_scale")],
                      "argmax_equal": res[part]["argmax_equal"]}
               for part in ("prefill_logits", "decode_step_logits")}}
        print(json.dumps({"control": name, "failed": failed}), flush=True)
    return summary


def run_int8_controls(on, off, out_name, feeds, controls=INT8_CONTROLS,
                      resnet=False) -> dict:
    """The int8 phase's on-vs-off readings, sound and under each of
    `controls`, and whether chip_smoke.check_int8_onoff fails each (with
    resnet=True: the resnet_int8 phase's logits and check_resnet_onoff)."""
    import importlib

    import chip_smoke as cs

    summary = {}
    for name in ("sound", *controls):
        restore = None
        if name != "sound":
            mod_name, attr, make = controls[name]
            mod = importlib.import_module(
                f"simpleinfer_tpu_torch.kernels.{mod_name}")
            restore = (mod, attr, getattr(mod, attr))
            setattr(mod, attr, make(restore[2]))
        try:
            outs = [on.run(f)[out_name] for f in feeds]
        finally:
            if restore:
                setattr(*restore)
        if resnet:
            r = cs.resnet_onoff(off, out_name, feeds, outs)
            res = {"logits": r}
        else:
            res = cs.int8_onoff(off, out_name, feeds, outs)
        try:
            if resnet:
                cs.check_resnet_onoff(r)
            else:
                cs.check_int8_onoff({"vs_kernels_off": res})
            failed = None
        except AssertionError as e:
            failed = str(e)[:200]
        summary[name] = {"caught": failed is not None, **{
            part: [r["max_abs_over_scale"], r["mean_abs_over_scale"]]
            for part, r in res.items()}}
        if resnet:
            summary[name]["top1_agreement"] = r["top1_agreement"]
        print(json.dumps({"control": name, "failed": failed,
                          **summary[name]}), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(main())
