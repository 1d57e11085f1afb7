#!/usr/bin/env python3
"""Controls for chip_smoke.py's llama kernels-on-vs-off check (phase 7):
can its limits tell a kernel that is wrong from bf16 noise?

    python3 scripts/torch_onoff_control.py     # from the root of a checkout

Loads the llama "base" bf16 int4w engine (kernels on), the same graph
with use_kernels=False, and the fp32 yardstick, as chip_smoke.py does,
and reads phase 7 once as it is (sound), then once per control, each
putting a plain PyTorch stand-in in place of one kernel wrapper for
bf16 inputs (the fp32 yardstick keeps the real kernels):

- int4w_bf16_dequant: matmul_int4w dequantizes to bf16 and multiplies
  in bf16, as the torch path does (a precision change, not a fault);
- flash_bf16_p: flash_attention rounds P to bf16 before P.V (its plain
  version; a precision change, not a fault);
- flash_causal_off_by_one: each query also sees the next key (a fault).

Prints one JSON line of readings per run, each with whether
chip_smoke.check_onoff fails it, then a summary line. Needs a CUDA card.
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


CONTROLS = {"int4w_bf16_dequant": ("matmul", "matmul_int4w",
                                   int4w_bf16_dequant),
            "flash_bf16_p": ("attention", "flash_attention", flash_bf16_p),
            "flash_causal_off_by_one": ("attention", "flash_attention",
                                        flash_causal_off_by_one)}


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


if __name__ == "__main__":
    sys.exit(main())
