#!/usr/bin/env python3
"""Controls for chip_smoke.py's kernels-on-vs-off checks: can their
limits tell a kernel that is wrong from bf16 and int8 noise?

    python3 scripts/torch_onoff_control.py          # llama (phase 7)
    python3 scripts/torch_onoff_control.py --int8   # yolov5l int8 + C3
    python3 scripts/torch_onoff_control.py --resnet # ResNet-50 int8
    python3 scripts/torch_onoff_control.py --detect # YOLOv8s, UNet int8w
    python3 scripts/torch_onoff_control.py --lineages  # GPT-2 ... BERT

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

With --detect: chip_smoke.py's detect_v8 and segment comparisons, the
YOLOv8s-640-b8 bf16 int8w engine (box and scores each against its own
scale) and the UNet-128-b8 one (logits) against the same graphs with
use_kernels=False, sound and with:

- int8w_plain: matmul_int8w is its plain version (f32 products and
  sums; a precision change, not a fault);
- int8w_drop_k_tile: matmul_int8w loses the last 32 of K (a fault);
- int8w_cls_drop_k_tile: the same, only in the class-score convs (N
  the model's class count: YOLOv8s's three cls-branch 1x1s, UNet's
  head), the fault the whole-row scale would hide (a fault).

With --lineages: the attention lineages' comparisons (chip_smoke.py's
gpt2, llama_swa and attn_variants phases, each against its
LINEAGE_TOL): GPT-2 small and the sliding llama kernels on vs off, the
gemma2-ish llama and BLOOM bf16 int4w vs fp32, ViT-B/16 and BERT-base
int8w kernels on vs off, sound and with these stand-ins on the bf16
side (the fp32 yardsticks keep the real kernels):

- int4w_plain / int8w_plain: the weight-only matmul is its plain
  version (f32 dequantized products and sums; not a fault);
- flash_plain: flash_attention is its plain version (flash_bf16_p;
  not a fault);
- decode_plain: decode_attention is its plain version (not a fault);
- int4w_drop_k_group: matmul_int4w loses the last group (128) of K
  (a fault);
- int4w_nibbles_swapped, int8w_drop_k_tile: as above (faults);
- flash_causal_off_by_one: as above, inside the band where there is
  one (a fault);
- decode_drop_last_key: decode_attention loses each row's newest
  cache position (a fault).

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
        if sliding_window is not None:
            keep &= torch.ones_like(keep).triu(diagonal=1 - sliding_window)
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


def int4w_plain(orig):
    import torch
    from simpleinfer_tpu_torch.kernels.matmul import matmul_int4w_ref

    def fn(x, wq4, bias=None, activation=None, *, out_dtype=None):
        if x.dtype != torch.bfloat16:
            return orig(x, wq4, bias, activation, out_dtype=out_dtype)
        return matmul_int4w_ref(x, wq4, bias, activation,
                                out_dtype or x.dtype)
    return fn


def int4w_drop_k_group(orig):
    import torch

    def fn(x, wq4, bias=None, activation=None, *, out_dtype=None):
        if x.dtype == torch.bfloat16:
            x = x.clone()
            x[:, -wq4.group:] = 0
        return orig(x, wq4, bias, activation, out_dtype=out_dtype)
    return fn


def decode_plain(orig):
    import torch
    from simpleinfer_tpu_torch.kernels.decode_attn import \
        decode_attention_ref

    def fn(q, k_leaf, v_leaf, lengths, *, scale, **kw):
        if q.dtype != torch.bfloat16:
            return orig(q, k_leaf, v_leaf, lengths, scale=scale, **kw)
        return decode_attention_ref(q, k_leaf, v_leaf, lengths, scale=scale)
    return fn


def decode_drop_last_key(orig):
    import torch

    def fn(q, k_leaf, v_leaf, lengths, *, scale, **kw):
        if q.dtype == torch.bfloat16:
            lengths = torch.clamp(torch.as_tensor(lengths) - 1, min=0)
        return orig(q, k_leaf, v_leaf, lengths, scale=scale, **kw)
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


def int8w_drop_k_tile(orig, only_n=None):
    def fn(x, w_q, scale, bias=None, activation=None, **kw):
        if only_n is not None and w_q.shape[1] != only_n:
            return orig(x, w_q, scale, bias, activation, **kw)
        k = max(x.shape[1] - 32, 1)
        return orig(x[:, :k].contiguous(), w_q[:k].contiguous(), scale,
                    bias, activation, **kw)
    return fn


def int8w_plain(orig):
    from simpleinfer_tpu_torch.kernels.matmul import matmul_int8w_ref

    def fn(x, w_q, scale, bias=None, activation=None, *, out_dtype=None):
        return matmul_int8w_ref(x, w_q, scale, bias, activation,
                                out_dtype=out_dtype or x.dtype)
    return fn


def detect_controls(classes: int) -> dict:
    return {"int8w_plain": ("matmul", "matmul_int8w", int8w_plain),
            "int8w_drop_k_tile": ("matmul", "matmul_int8w",
                                  int8w_drop_k_tile),
            "int8w_cls_drop_k_tile": (
                "matmul", "matmul_int8w",
                lambda orig: int8w_drop_k_tile(orig, only_n=classes))}


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


INT4W_CONTROLS = {"int4w_plain": ("matmul", "matmul_int4w", int4w_plain),
                  "int4w_drop_k_group": ("matmul", "matmul_int4w",
                                         int4w_drop_k_group),
                  "int4w_nibbles_swapped": ("matmul", "matmul_int4w",
                                            int4w_nibbles_swapped)}
FLASH_CONTROLS = {"flash_plain": ("attention", "flash_attention",
                                  flash_bf16_p),
                  "flash_causal_off_by_one": ("attention", "flash_attention",
                                              flash_causal_off_by_one)}
DECODE_CONTROLS = {"decode_plain": ("decode_attn", "decode_attention",
                                    decode_plain),
                   "decode_drop_last_key": ("decode_attn", "decode_attention",
                                            decode_drop_last_key)}
INT8W_CONTROLS = {"int8w_plain": ("matmul", "matmul_int8w", int8w_plain),
                  "int8w_drop_k_tile": ("matmul", "matmul_int8w",
                                        int8w_drop_k_tile)}


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
    if "--lineages" in sys.argv[1:]:
        summary = run_lineage_controls(device)
        print(json.dumps({"limits": cs.LINEAGE_TOL, "summary": summary}),
              flush=True)
        return 0 if not any(summary[m]["sound"]["caught"]
                            for m in summary) else 1
    if "--detect" in sys.argv[1:]:
        summary = run_detect_controls(device)
        print(json.dumps({"limits": {"yolov8s": cs.V8_ONOFF_TOL,
                                     "unet": cs.UNET_ONOFF_TOL},
                          "summary": summary}), flush=True)
        return 0 if not any(summary[m]["sound"]["caught"]
                            for m in summary) else 1
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
    import chip_smoke as cs

    summary = {}
    for name in ("sound", *CONTROLS):
        res = under(CONTROLS.get(name),
                    lambda: cs.onoff(on, off, device, ref, **onoff_kw))
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


def under(control, fn):
    """fn() with `control` (an entry of the tables above, or None) in
    place of its kernel wrapper."""
    import importlib

    if control is None:
        return fn()
    mod_name, attr, make = control
    mod = importlib.import_module(f"simpleinfer_tpu_torch.kernels.{mod_name}")
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        return fn()
    finally:
        setattr(mod, attr, orig)


def run_lineage_controls(device) -> dict:
    """Each lineage comparison of chip_smoke.py's gpt2, llama_swa and
    attn_variants phases, sound and under each control its path can
    see, and whether the phase's check fails it."""
    import torch

    import chip_smoke as cs

    def failed_by(check):
        try:
            check()
            return None
        except AssertionError as e:
            return str(e)[:200]

    def brief(res, parts):
        return {part: [res[part]["max_abs_over_scale"],
                       res[part]["mean_abs_over_scale"]] for part in parts}

    summary = {}
    lm_parts = ("prefill_logits", "decode_step_logits")
    for model, build, cfg, controls in (
            ("gpt2", "build_gpt", cs.GPT2,
             {**INT4W_CONTROLS, **FLASH_CONTROLS, **DECODE_CONTROLS}),
            ("swa", "build_llama", cs.SWA,
             {**INT4W_CONTROLS, **FLASH_CONTROLS})):
        (on, off, ref), _, _ = cs.lm_engines(device, build, cfg, [
            ("bfloat16", "int4w", None), ("bfloat16", "int4w", False),
            ("float32", "int4w", None)])
        lens = (1000, 900) if model == "gpt2" else (2000, 1900)
        summary[model] = {}
        for name in ("sound", *controls):
            res = under(controls.get(name), lambda: cs.onoff(
                on, off, device, ref, prompt_lens=lens,
                phase=f"{model}_{name}", tol=cs.LINEAGE_TOL[model]))
            failed = failed_by(lambda: cs.check_onoff(res))
            v = res["vs_fp32"]
            summary[model][name] = {
                "caught": failed is not None, **brief(res, lm_parts),
                "vs_fp32_ratio": {part: [
                    v[part]["on"][k] / v[part]["off"][k] for k in (
                        "max_abs_over_scale", "mean_abs_over_scale")]
                    for part in lm_parts}}
            print(json.dumps({"model": model, "control": name,
                              "failed": failed, **summary[model][name]}),
                  flush=True)
        del on, off, ref
        torch.cuda.empty_cache()
    for model, build, cfg in (("gemma2ish", "build_llama", cs.GEMMA2ISH),
                              ("bloom", "build_bloom", cs.BLOOM560)):
        (eng, ref), _, _ = cs.lm_engines(device, build, cfg, [
            ("bfloat16", "int4w", None), ("float32", "int4w", None)])
        summary[model] = {}
        for name in ("sound", *INT4W_CONTROLS):
            res = under(INT4W_CONTROLS.get(name), lambda: cs.variant_vs_fp32(
                eng, ref, device, (2000, 1900), model))
            failed = None if all(cs.within(res[part], res["tol"])
                                 for part in lm_parts) else "past the limit"
            summary[model][name] = {"caught": failed is not None,
                                    **brief(res, lm_parts)}
            print(json.dumps({"model": model, "control": name,
                              "failed": failed, **summary[model][name]}),
                  flush=True)
        del eng, ref
        torch.cuda.empty_cache()
    feeds = cs.encoder_feeds(cs.VIT_B16, cs.BERT_BASE)
    for model, build, cfg in (("vit_b16", "build_vit", cs.VIT_B16),
                              ("bert_base", "build_bert", cs.BERT_BASE)):
        (on, off), _, _ = cs.lm_engines(device, build, cfg, [
            ("bfloat16", "int8w", None), ("bfloat16", "int8w", False)])
        feed = {on.input_names[0]: feeds[model]}
        want = torch.from_numpy(off.run(feed)[off.output_names[0]])
        summary[model] = {}
        for name in ("sound", *INT8W_CONTROLS):
            got = under(INT8W_CONTROLS.get(name), lambda: torch.from_numpy(
                on.run(feed)[on.output_names[0]]))
            r = cs.compare_logits(got, want)
            failed = None if cs.within(r, cs.LINEAGE_TOL[model]) else \
                "past the limit"
            summary[model][name] = {
                "caught": failed is not None,
                "logits": [r["max_abs_over_scale"], r["mean_abs_over_scale"]]}
            print(json.dumps({"model": model, "control": name,
                              "failed": failed, **summary[model][name]}),
                  flush=True)
        del on, off
        torch.cuda.empty_cache()
    return summary


def run_int8_controls(on, off, out_name, feeds, controls=INT8_CONTROLS,
                      resnet=False) -> dict:
    """The int8 phase's on-vs-off readings, sound and under each of
    `controls`, and whether chip_smoke.check_int8_onoff fails each (with
    resnet=True: the resnet_int8 phase's logits and check_resnet_onoff)."""
    import chip_smoke as cs

    summary = {}
    for name in ("sound", *controls):
        outs = under(controls.get(name),
                     lambda: [on.run(f)[out_name] for f in feeds])
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


def run_detect_controls(device) -> dict:
    """chip_smoke's YOLOv8s and UNet on-vs-off readings, sound and under
    each of detect_controls, and whether chip_smoke.check_parts fails
    each."""
    import numpy as np

    import chip_smoke as cs
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_unet
    from simpleinfer_tpu_torch.zoo.common import fetch_nhwc
    from simpleinfer_tpu_torch.zoo.segment import segment_images

    b, image = cs.DETECT["batch"], cs.DETECT["image"]
    on, in_name, out_name, _ = cs.detect_engine(device, "v8", "bfloat16",
                                                True, b, image)
    off = cs.detect_engine(device, "v8", "bfloat16", False, b, image)[0]
    feed = {in_name: cs.v8_feed(b, image)}
    want_v8 = off.run(feed)[out_name]
    del off
    graph, _, unet_out = build_unet(**cs.SEGMENT)
    unet_on, unet_off = [
        Engine(EngineConfig(compute_dtype="bfloat16", quant="int8w",
                            device=str(device), use_kernels=k)
               ).load_model(None, graph=graph) for k in (True, False)]
    images = cs.seeded_images(seed=3,
                              sizes=cs.DETECT_SIZES[:cs.SEGMENT["batch"]])
    segment_images(unet_off, images)
    want_unet = fetch_nhwc(unet_off, unet_out)
    del unet_off

    def unet_logits():
        segment_images(unet_on, images)
        return fetch_nhwc(unet_on, unet_out)

    models = {"yolov8s": (lambda: on.run(feed)[out_name], want_v8,
                          cs.V8_ONOFF_TOL, 80),
              "unet": (unet_logits, want_unet, cs.UNET_ONOFF_TOL,
                       int(want_unet.shape[-1]))}
    summary = {}
    for model, (run, want, tol, classes) in models.items():
        controls = detect_controls(classes)
        summary[model] = {}
        for name in ("sound", *controls):
            got = under(controls.get(name), run)
            res = cs.parts_onoff(got, want, tol)
            try:
                if not np.isfinite(got).all():
                    raise AssertionError("a non-finite output")
                cs.check_parts(res, f"{model} kernels on vs off")
                failed = None
            except AssertionError as e:
                failed = str(e)[:200]
            summary[model][name] = {"caught": failed is not None, **{
                part: [r["max_abs_over_scale"], r["mean_abs_over_scale"]]
                for part, r in res.items()}}
            print(json.dumps({"model": model, "control": name,
                              "failed": failed, **summary[model][name]}),
                  flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(main())
