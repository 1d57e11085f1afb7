#!/usr/bin/env python3
"""Why chip_smoke.py's service_vs_solo decodes each solo prompt over a
batch of the service's 16 rows: what a solo decode at batch 1 differs
in, and whether the token where it leaves the service's is a near tie.

    python3 scripts/torch_solo_drift.py

Serves GPT-2 small bf16 int4w as chip_smoke.py's gpt2 phase does (the
same 48 seeded greedy requests), then, for each of the 4 requests its
service_vs_solo takes, decodes the prompt alone with
CachedDecoder.generate (KV bf16, scratch blocks, blocks of 1 step) at
batch 1 with the decode kernel, at batch 1 with decode attention on
torch, and at batch 16 (every row that prompt) with the decode kernel,
and prints where each first leaves the service's tokens. For a batch-1
run that leaves them:

- the logits at the first differing token, in the batch-1 run and in
  the batch-16 run: the service's token and the solo one, each one's
  logit, and the gap between them;
- an op trace of the batch-16 and the batch-1 decode up to that token:
  every computing torch operation (TorchFunctionMode) and every kernel
  wrapper call, row 0 of its inputs and outputs compared bit for bit
  (OpTrace); the first whose inputs are equal and whose outputs are not
  is the one whose order of summation depends on the batch.

Prints one JSON line per reading and a summary line. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# operations that only move, view, convert or make values: the same
# inputs give the same outputs at any batch, and a decode at batch 1
# runs a few more of them (a [1, ...] constant looks batched there), so
# the trace leaves them out and keeps the operations that compute
_MOVES = {"__getitem__", "__setitem__", "__get__", "reshape", "view",
          "transpose", "permute", "contiguous", "to", "clone", "detach",
          "expand", "expand_as", "unsqueeze", "squeeze", "flatten", "t",
          "float", "bfloat16", "half", "type_as", "repeat", "cat", "stack",
          "select", "narrow", "split", "chunk", "index_select", "gather",
          "index_copy", "index_copy_", "copy_", "scatter", "scatter_",
          "masked_fill", "where", "as_tensor", "tensor", "arange", "zeros",
          "ones", "full", "zeros_like", "ones_like", "full_like", "empty",
          "empty_like", "empty_strided", "new_empty", "new_zeros",
          "new_ones", "new_full", "repeat_interleave", "roll", "clamp",
          "long", "int", "item", "tolist", "numpy", "cpu", "cuda"}


def _tensors(*xs):
    import torch

    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(_tensors(*x))
        elif isinstance(x, dict):
            out.extend(_tensors(*x.values()))
    return out


class OpTrace:
    """The inputs and outputs of every computing torch operation and
    every kernel wrapper call while active, in call order, each as its
    first dim0 / batch rows where the batch divides dim0 (a [N, ...] or
    a flattened [N*L, ...] tensor), else whole. With `want` (the records
    of a trace at a larger batch) each record is compared as it comes (a
    tensor taken whole here against the other's rows where the other cut
    it). `first` is the first operation whose inputs were equal and whose
    outputs were not: its order of summation depends on the batch (an
    operation without a batch dim, a count or a sum over the rows, is
    left out of it); `inputs_differ` the first whose inputs differed
    before any output did (a value that came another way than through a
    traced operation); `mismatch` where the two sequences part."""

    def __init__(self, batch, want=None):
        self.batch = batch
        self.want = want
        self.records = []
        self.n = 0
        self.inside = 0
        self.first = self.inputs_differ = self.mismatch = None

    def cut(self, ts):
        import torch

        rows = []
        for t in ts:
            t = t.detach()
            if t.dtype == torch.bool:
                t = t.to(torch.uint8)
            cut = t.ndim > 0 and t.shape[0] % self.batch == 0
            rows.append(((t[:t.shape[0] // self.batch] if cut else t).clone(),
                         cut and self.batch > 1))
        return rows

    def keep(self, name, ins, out):
        outs = self.cut(_tensors(out))
        if not outs:
            return
        rec = (name, self.cut(_tensors(ins)), outs)
        if self.want is None:
            self.records.append(rec)
        elif self.first is None and self.mismatch is None:
            self.compare(rec)
        self.n += 1

    @staticmethod
    def same(want, got):
        import torch

        for (w, batched), (g, _) in zip(want, got):
            if (batched and g.ndim == w.ndim and g.shape[1:] == w.shape[1:]
                    and g.shape[0] >= w.shape[0]):
                g = g[:w.shape[0]]
            if w.shape != g.shape or not torch.equal(w, g):
                return False
        return len(want) == len(got)

    def compare(self, rec):
        name, ins, outs = rec
        if self.n >= len(self.want) or self.want[self.n][0] != name:
            self.mismatch = {"index": self.n, "op": name, "want": (
                self.want[self.n][0] if self.n < len(self.want) else None)}
            return
        _, w_ins, w_outs = self.want[self.n]
        if self.same(w_outs, outs):
            return
        if not self.same(w_ins, ins):
            if self.inputs_differ is None:
                self.inputs_differ = {"index": self.n, "op": name}
            return
        if not any(b for _, b in w_outs):
            return                      # no batch dim: differs by nature
        (w, _), (g, _) = w_outs[0], outs[0]
        g = g[:w.shape[0]] if g.shape[1:] == w.shape[1:] else g
        self.first = {"index": self.n, "op": name, "shape": list(w.shape),
                      "max_abs_diff": float((w.float() - g.float()).abs()
                                            .max()) if w.shape == g.shape
                      else None}

    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        trace = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                name = getattr(func, "__name__", str(func))
                if not trace.inside and name not in _MOVES:
                    trace.keep(name, (args, kwargs), out)
                return out

        from simpleinfer_tpu_torch.kernels import attention as kattn
        from simpleinfer_tpu_torch.kernels import decode_attn as kdec
        from simpleinfer_tpu_torch.kernels import matmul as kmm

        self.patched = [(kmm, "matmul_int4w"), (kattn, "flash_attention"),
                        (kdec, "decode_attention")]
        self.orig = [getattr(m, a) for m, a in self.patched]

        def wrap(name, orig):
            def fn(*args, **kw):
                trace.inside += 1       # neither its ops nor keep's
                try:
                    out = orig(*args, **kw)
                    trace.keep(name, (args, kw), out)
                finally:
                    trace.inside -= 1
                return out
            return fn

        for (m, a), orig in zip(self.patched, self.orig):
            setattr(m, a, wrap(a, orig))
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for (m, a), orig in zip(self.patched, self.orig):
            setattr(m, a, orig)


def solo(dec, prompt, steps, batch, logits=None):
    """dec.generate of `prompt` over `batch` identical rows, blocks of 1
    step; row 0's tokens. With `logits` a list, row 0 of the logits of
    every sampled token is appended to it."""
    import numpy as np
    from simpleinfer_tpu_torch.zoo import generate as gen

    orig = gen.sample_logits

    def keep(lg, *a, **k):
        logits.append(lg[0].float().cpu())
        return orig(lg, *a, **k)

    if logits is not None:
        gen.sample_logits = keep
    try:
        return dec.generate(np.repeat(prompt[None], batch, axis=0),
                            steps=steps, block=1)[0]
    finally:
        gen.sample_logits = orig


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_solo_drift.py needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(cs.device_and_build(device)["nvidia_smi"], flush=True)
    (on,), _, _ = cs.lm_engines(device, "build_gpt", cs.GPT2,
                                [("bfloat16", "int4w", None)])
    run = cs.service_run(on, device, n_requests=cs.N_REQUESTS,
                         prompt_range=cs.GPT2_PROMPTS, max_new=cs.MAX_NEW,
                         phase="gpt2_service")
    decs = {attn: CachedDecoder(on, kv_dtype=cs.SERVICE["kv_dtype"],
                                scratch_blocks=True, decode_attn=attn)
            for attn in ("kernel", "torch")}
    picked = [i for i, p in enumerate(run["prompts"]) if len(p) > 256][:4]
    summary = []
    for i in picked:
        prompt = np.asarray(run["prompts"][i])
        want = np.asarray(run["results"][i])
        p, steps = len(prompt), len(want) - len(prompt)
        row = {"request": i, "prompt_len": p, "first_diff": {}}
        for attn, batch in (("kernel", 1), ("torch", 1), ("kernel", 16)):
            got = solo(decs[attn], prompt, steps, batch)
            diff = np.nonzero(got != want)[0]
            row["first_diff"][f"{attn}_b{batch}"] = (
                int(diff[0]) if diff.size else None)
        d = row["first_diff"]["kernel_b1"]
        if d is not None:
            n_steps = d - p + 1
            lg1, lg16 = [], []
            got1 = solo(decs["kernel"], prompt, n_steps, 1, lg1)
            solo(decs["kernel"], prompt, n_steps, 16, lg16)
            mine, theirs = int(got1[d]), int(want[d])
            row["at_first_diff"] = {
                "service_token": theirs, "solo_token": mine,
                "logits_dtype": str(on.config.compute_dtype),
                **{f"b{b}": {"service_logit": float(lg[-1][theirs]),
                             "solo_logit": float(lg[-1][mine]),
                             "gap": float(lg[-1][mine] - lg[-1][theirs]),
                             "top2": [float(v) for v in
                                      torch.topk(lg[-1], 2).values]}
                   for b, lg in ((1, lg1), (16, lg16))}}
            with OpTrace(16) as t16:
                solo(decs["kernel"], prompt, n_steps, 16)
            with OpTrace(1, want=t16.records) as t1:
                solo(decs["kernel"], prompt, n_steps, 1)
            row["op_trace"] = {"ops": len(t16.records),
                               "first_difference": t1.first,
                               "inputs_differ": t1.inputs_differ,
                               "sequence_mismatch": t1.mismatch}
            del t16, t1
            torch.cuda.empty_cache()
        summary.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
