"""Transformer op lowerings: torch.matmul / torch.bmm, torch.select,
nn.Embedding, F.scaled_dot_product_attention, nn.MultiheadAttention and
the llama-style si.RotaryAttention, with the RoPE / qk-norm / GQA / ALiBi
helpers the KV-cache decoder (zoo/generate.py) shares (counterparts of
simpleinfer_tpu/ops/attention.py's).

Attention logits and softmax run in f32, P·V at the compute dtype. When
kernels are on, kernels/attention.flash_attention takes:
- causal prefill past `flash_profitable` (Lk >= 256, the H100's
  crossover; the JAX package's TPU gate is 2048);
- sliding-window prefill past `flash_band_profitable` (the banded grid);
- non-causal SDPA / nn.MultiheadAttention past the non-causal gate.
Shorter sequences, softcapped and ALiBi ops take the unblocked torch
path, as the JAX package leaves them to XLA (the kernel's online softmax
has no tanh or position-bias hook). Rank-3 [N, L, E] tensors are
logical == physical; rank-4 operands of matmul / select / SDPA are NHWC
physical and run on their logical NCHW view.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ir.graph import PARAM_BOOL, PARAM_FLOAT, PARAM_INT
from ..kernels import attention as kattn
from ..quant.tensor import proj_nlo
from .extra import _to_logical, _to_physical
from .registry import OpImpl, register_op, require_attr, require_param

_NEG = torch.finfo(torch.float32).min


# ------------------------------------------------------------- matmul/bmm
def _lower_matmul(op, cfg):
    """Batched product at the operands' dtype (f32 in full f32: TF32 is
    off in the fp32 parity mode, engine.fp32_parity)."""
    def apply(weights, a, b):
        return _to_physical(torch.matmul(_to_logical(a), _to_logical(b)))

    return OpImpl(name=op.name, type=op.type, apply=apply)


for _t in ("torch.matmul", "torch.bmm"):
    register_op(_t)(_lower_matmul)


@register_op("torch.select")
def lower_select(op, cfg):
    dim = require_param(op, "dim", PARAM_INT).i
    index = require_param(op, "index", PARAM_INT).i

    def apply(weights, x):
        y = _to_logical(x)
        d = dim + y.ndim if dim < 0 else dim
        return _to_physical(torch.select(y, d, index))

    return OpImpl(name=op.name, type=op.type, apply=apply)


# ------------------------------------------------------------- embedding
@register_op("nn.Embedding")
def lower_embedding(op, cfg):
    num_embeddings = require_param(op, "num_embeddings", PARAM_INT).i
    embedding_dim = require_param(op, "embedding_dim", PARAM_INT).i
    w = require_attr(op, "weight").array()
    if list(w.shape) != [num_embeddings, embedding_dim]:
        raise ValueError(f"Embedding {op.name}: weight shape {w.shape} "
                         f"does not match params")
    weights = {"weight": torch.from_numpy(w.astype(np.float32))}

    def apply(weights, idx):
        # engine inputs arrive as float ids; the gather wants integers
        return weights["weight"][idx.long()]

    return OpImpl(name=op.name, type=op.type, apply=apply, weights=weights)


# --------------------------------------------------------------- core SDPA
def _sdpa(q, k, v, mask=None, is_causal=False, scale=None,
          mask_mode="sdpa"):
    """Scaled dot-product attention on [..., L, d]: f32 logits and
    softmax, P·V at the input dtype. mask_mode "sdpa": a bool mask's
    True means attend (F.scaled_dot_product_attention); "mha": True
    means mask out (nn.MultiheadAttention.attn_mask). A float mask is
    added. is_causal aligns bottom-right (Lq != Lk), as torch's SDPA."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            keep = mask if mask_mode == "sdpa" else ~mask
            logits = logits.masked_fill(~keep, _NEG)
        else:
            logits = logits + mask.float()
    if is_causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((lq, lk), dtype=torch.bool,
                            device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~causal, _NEG)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


@register_op("F.scaled_dot_product_attention")
def lower_sdpa(op, cfg):
    is_causal = (op.params["is_causal"].b
                 if op.has_param("is_causal", PARAM_BOOL) else False)
    scale = (op.params["scale"].f
             if op.has_param("scale", PARAM_FLOAT) else None)
    use_kernels = cfg.kernels_enabled

    def apply(weights, *inputs):
        # [N, h, L, d] inputs are rank 4, hence physically NHWC
        q, k, v = (_to_logical(t) for t in inputs[:3])
        mask = _to_logical(inputs[3]) if len(inputs) > 3 else None
        # causal Lq != Lk stays on torch: the kernel aligns a causal mask
        # top-left and requires Lq == Lk, SDPA bottom-right, so the gate
        # changes only speed, never the result
        if (mask is None and use_kernels
                and (not is_causal or q.shape[-2] == k.shape[-2])
                and kattn.flash_profitable(q.shape[-2], k.shape[-2],
                                           causal=is_causal)):
            # the kernel reads the head dim contiguous
            return _to_physical(kattn.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=is_causal, scale=scale))
        return _to_physical(_sdpa(q, k, v, mask=mask, is_causal=is_causal,
                                  scale=scale, mask_mode="sdpa"))

    return OpImpl(name=op.name, type=op.type, apply=apply)


# ------------------------------------------------------- rotary helpers
def rope_cos_sin(positions, dim, theta):
    """HF-convention RoPE tables: positions [...] int -> (cos, sin)
    [..., dim] f32, frequencies duplicated across the two halves."""
    half = dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device)
                           / float(half)))
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin, interleaved: bool = False):
    """Rotate the last dim of x [..., D] by (cos, sin) broadcastable to
    [..., R] (HF rotate_half: [x1, x2] -> [-x2, x1]); R < D is partial
    rotary (dims [R:] pass through). interleaved=True is the GPT-J
    rotate_every_two wiring: frequency f rotates (x[2f], x[2f+1]), the
    tables read off their first half."""
    d = x.shape[-1]
    r = cos.shape[-1]
    xr = x[..., :r] if r != d else x
    half = r // 2
    dt = x.dtype
    if interleaved:
        ch, sh = cos[..., :half, None], sin[..., :half, None]
        xp = xr.float().reshape(*xr.shape[:-1], half, 2)
        x0, x1 = xp[..., 0:1], xp[..., 1:2]
        out = torch.cat([x0 * ch - x1 * sh, x0 * sh + x1 * ch], dim=-1)
        out = out.reshape(xr.shape).to(dt)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([-x2, x1], dim=-1)
        out = (xr.float() * cos + rot.float() * sin).to(dt)
    if r != d:
        out = torch.cat([out, x[..., r:]], dim=-1)
    return out


def apply_qk_norm(qh, kh, w, eps: float = 1e-6):
    """Per-head RMSNorm on q/k heads BEFORE RoPE (qwen3 lineage); a
    no-op when the op carries no norm weights (f32 [D] wqn / wkn)."""
    wq, wk = w.get("wqn"), w.get("wkn")
    if wq is None and wk is None:
        return qh, kh

    def rms(x, wgt):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * wgt).to(x.dtype)

    return ((rms(qh, wq) if wq is not None else qh),
            (rms(kh, wk) if wk is not None else kh))


def repeat_kv(x, group):
    """GQA: [N, Hkv, L, D] -> [N, Hkv*group, L, D] (each kv head serves
    `group` query heads)."""
    if group == 1:
        return x
    return torch.repeat_interleave(x, group, dim=1)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Train-free ALiBi head slopes (Press et al.), [H] float32: the
    geometric ladder 2^(-8i/n) for the largest power-of-two n <= H, plus
    (for other H) every other step of the 2n ladder, as transformers'
    build_alibi_tensor. The bias is slopes[h] * key_position: it differs
    from the paper's -slopes[h] * (q - k) by a per-row constant that the
    softmax cancels, so cached keys never need re-biasing."""
    n = 1 << (num_heads.bit_length() - 1)   # largest power of 2 <= H

    def ladder(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    slopes = ladder(n)
    if n < num_heads:
        slopes += ladder(2 * n)[0::2][:num_heads - n]
    return np.asarray(slopes, np.float32)


def resolve_alibi_slopes(info) -> np.ndarray:
    """[H] f32 effective slopes of an ALiBi op: its alibi_slopes attr
    when present (MPT's non-power-of-two heads), else the closed form;
    times alibi_scale (falcon-rw's shared 1/sqrt(d)). One source for the
    op lowering and every KV-cache decode path."""
    sl = info.get("alibi_slopes")
    s = (np.asarray(sl, np.float32) if sl is not None
         else alibi_slopes(info["num_heads"]))
    return s * np.float32(info.get("alibi_scale") or 1.0)


def cap_logits(s, softcap):
    """gemma2 tanh logit capping (applied before the mask, in f32)."""
    return torch.tanh(s / softcap) * softcap if softcap is not None else s


def causal_context(qh, kh, vh, scale, use_kernels: bool,
                   sliding_window=None, softcap=None, alibi=None):
    """Aligned-causal attention context [N, H, L, D] (kh/vh already
    repeated to H heads); `alibi` is the [H] slopes array of an ALiBi op.
    With kernels on: the banded flash kernel for a sliding op past
    flash_band_profitable, the causal one for a plain op past
    flash_profitable (a flash result is a strided [N, H, L, D] view of
    [N, L, H, D] memory); a band of L or more is plain causal. Else, and
    always for softcapped and ALiBi ops: f32 scores, the cap, the slopes
    x key position, the (banded) causal finfo.min mask, an f32 softmax
    and P·V at the input dtype."""
    l = qh.shape[2]
    if sliding_window is not None and sliding_window >= l:
        sliding_window = None       # the band holds every causal key
    if use_kernels and softcap is None and alibi is None:
        if sliding_window is not None:
            if kattn.flash_band_profitable(l, l, sliding_window):
                return kattn.flash_attention(qh, kh, vh, causal=True,
                                             scale=scale,
                                             sliding_window=sliding_window)
        elif kattn.flash_profitable(l, l):
            return kattn.flash_attention(qh, kh, vh, causal=True,
                                         scale=scale)
    s = cap_logits(torch.matmul(qh.float(), kh.float().transpose(-1, -2))
                   * scale, softcap)
    ki = torch.arange(l, device=s.device)
    if alibi is not None:
        s = s + torch.as_tensor(alibi, device=s.device)[
            None, :, None, None] * ki.float()
    keep = ki[None, :] <= ki[:, None]
    if sliding_window is not None:
        keep &= ki[None, :] > ki[:, None] - sliding_window
    s = s.masked_fill(~keep, _NEG)
    p = torch.softmax(s, dim=-1).to(qh.dtype)
    return torch.matmul(p, vh)


def merge_heads(ctx):
    """[N, H, L, D] -> [N, L, H*D]."""
    n, h, l, d = ctx.shape
    return ctx.transpose(1, 2).reshape(n, l, h * d)


def split_heads(y, heads, d):
    """[N, L, H*D] -> [N, H, L, D] (a transposed view)."""
    n, l = y.shape[0], y.shape[1]
    return y.reshape(n, l, heads, d).transpose(1, 2)


def project(x, w, key, heads, d, dt, use_kernels):
    """q/k/v projection of x [N, L, E] through weight `w{key}` (+ bias
    `b{key}`): [N, heads, L, D] at dt."""
    y = proj_nlo(x, w[f"w{key}"], dt, use_kernels)
    if f"b{key}" in w:
        y = y + w[f"b{key}"]
    return split_heads(y.to(dt), heads, d)


def project_out(ctx, w, dt, use_kernels):
    """Output projection ctx [N, L, H*D] @ wo (+ bo) at dt."""
    out = proj_nlo(ctx, w["wo"], dt, use_kernels)
    if "bo" in w:
        out = out + w["bo"]
    return out.to(dt)


# ----------------------------------------------------- MultiheadAttention
@register_op("nn.MultiheadAttention")
def lower_multihead_attention(op, cfg):
    """nn.MultiheadAttention, pnnx module capture. Params num_heads,
    embed_dim, batch_first, kdim/vdim (separate projections); attrs
    in_proj_weight [3E, E] + in_proj_bias [3E] (packed) or
    q/k/v_proj_weight, plus out_proj.weight / out_proj.bias. Inputs: 1
    (self-attention), 2 (q, kv) or 3 (q, k, v); a trailing operand that
    is rank 2 or whose last dim is not the k/v feature dim is attn_mask
    (True = mask out, or added). Outputs: attn_output [+ the head-averaged
    attention weights when the graph declares 2 outputs, torch's
    average_attn_weights=True default]. Past the non-causal flash gate,
    with no mask and one output, the kernel computes the context."""
    embed_dim = require_param(op, "embed_dim", PARAM_INT).i
    num_heads = require_param(op, "num_heads", PARAM_INT).i
    batch_first = (op.params["batch_first"].b
                   if op.has_param("batch_first", PARAM_BOOL) else False)
    if embed_dim % num_heads:
        raise ValueError(f"MultiheadAttention {op.name}: embed_dim "
                         f"{embed_dim} not divisible by {num_heads} heads")
    kdim, vdim = (op.params[k].i if op.has_param(k, PARAM_INT)
                  else embed_dim for k in ("kdim", "vdim"))
    use_kernels = cfg.kernels_enabled
    d = embed_dim // num_heads
    scale = 1.0 / math.sqrt(d)

    if op.has_attr("in_proj_weight"):
        w = require_attr(op, "in_proj_weight").array()
        if list(w.shape) != [3 * embed_dim, embed_dim]:
            raise ValueError(f"MultiheadAttention {op.name}: in_proj_weight "
                             f"shape {w.shape}")
        wq, wk, wv = np.split(w, 3, axis=0)
    else:
        wq = require_attr(op, "q_proj_weight").array()
        wk = require_attr(op, "k_proj_weight").array()
        wv = require_attr(op, "v_proj_weight").array()

    def t32(a):                # [out, in] -> [in, out], the linear order
        return torch.from_numpy(np.ascontiguousarray(a.T).astype(np.float32))

    weights = {"wq": t32(wq), "wk": t32(wk), "wv": t32(wv),
               "wo": t32(require_attr(op, "out_proj.weight").array())}
    if op.has_attr("in_proj_bias"):
        b = require_attr(op, "in_proj_bias").array().astype(np.float32)
        for key, part in zip(("bq", "bk", "bv"), np.split(b, 3)):
            weights[key] = torch.from_numpy(np.ascontiguousarray(part))
    if op.has_attr("out_proj.bias"):
        weights["bo"] = torch.from_numpy(
            require_attr(op, "out_proj.bias").array().astype(np.float32))
    n_declared = max(1, len(op.outputs))

    def apply(weights, *inputs):
        xs = list(inputs)
        mask = None
        if len(xs) == 4:
            mask = xs.pop()
        elif len(xs) in (2, 3):
            expect = kdim if len(xs) == 2 else vdim
            if xs[-1].ndim == 2 or xs[-1].shape[-1] != expect:
                mask = xs.pop()
        q = xs[0]
        k = xs[1] if len(xs) > 1 else q
        v = xs[2] if len(xs) > 2 else k
        if not batch_first:  # [L, N, E] -> [N, L, E]
            q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        dt = q.dtype
        qh = project(q, weights, "q", num_heads, d, dt, use_kernels)
        kh = project(k, weights, "k", num_heads, d, dt, use_kernels)
        vh = project(v, weights, "v", num_heads, d, dt, use_kernels)
        probs = None
        if (mask is None and n_declared == 1 and use_kernels
                and kattn.flash_profitable(qh.shape[-2], kh.shape[-2],
                                           causal=False)):
            ctx = kattn.flash_attention(qh, kh, vh, scale=scale)
        else:
            if mask is not None and mask.ndim == 3:
                # [N*h, Lq, Lk] -> [N, h, Lq, Lk]
                mask = mask.reshape(qh.shape[0], num_heads,
                                    *mask.shape[-2:])
            logits = torch.matmul(qh.float(),
                                  kh.float().transpose(-1, -2)) * scale
            if mask is not None:
                if mask.dtype == torch.bool:   # True = mask out
                    logits = logits.masked_fill(mask, _NEG)
                else:
                    logits = logits + mask.float()
            probs = torch.softmax(logits, dim=-1)
            ctx = torch.matmul(probs.to(dt), vh)
        out = project_out(merge_heads(ctx), weights, dt, use_kernels)
        if not batch_first:
            out = out.transpose(0, 1)
        if n_declared == 1:
            return out
        return out, probs.mean(dim=1).to(dt)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        n_outputs=n_declared,
        quantizable={"wq": 1, "wk": 1, "wv": 1, "wo": 1},
        decode_info={"embed_dim": embed_dim, "num_heads": num_heads,
                     "batch_first": batch_first, "kdim": kdim,
                     "vdim": vdim},
    )


# ------------------------------------------------------- rotary attention
@register_op("si.RotaryAttention")
def lower_rotary_attention(op, cfg):
    """Llama-style decoder self-attention as ONE composite op: q/k/v/o
    projections, RoPE (HF rotate_half, or the interleaved GPT-J wiring;
    partial rotary_dim), grouped-query attention, optional qwen3 per-head
    qk RMSNorm, a decoupled head_dim and attention scale, and an
    intrinsic causal mask. Options: sliding_window (mistral: the last W
    positions), logit_softcap (gemma2: tanh capping before the mask, in
    f32) and alibi (BLOOM / MPT: no RoPE, slopes[h] x key position on the
    logits; alibi_scale and an alibi_slopes attr fold into the slopes).
    Attrs {q,k,v,o}_proj.weight ([out, in]) and optional biases; input x
    [N, L, E], output [N, L, E]."""
    embed_dim = require_param(op, "embed_dim", PARAM_INT).i
    num_heads = require_param(op, "num_heads", PARAM_INT).i
    num_kv = (op.params["num_kv_heads"].i
              if op.has_param("num_kv_heads", PARAM_INT) else num_heads)
    theta = (op.params["rope_theta"].f
             if op.has_param("rope_theta", PARAM_FLOAT) else 10000.0)
    sw = (op.params["sliding_window"].i
          if op.has_param("sliding_window", PARAM_INT) else None)
    if sw is not None and sw < 1:
        raise ValueError(f"RotaryAttention {op.name}: sliding_window "
                         f"must be >= 1, got {sw}")
    alibi = bool(op.params["alibi"].i
                 if op.has_param("alibi", PARAM_INT) else 0)
    if alibi and sw is not None:
        raise ValueError(f"RotaryAttention {op.name}: alibi and "
                         f"sliding_window are mutually exclusive (no "
                         f"model family combines them)")
    # BLOOM adds the slopes after the 1/sqrt(d) scaling (alibi_scale 1);
    # falcon-rw scales scores and bias together (1/sqrt(d) in the slopes)
    alibi_scale = (op.params["alibi_scale"].f
                   if op.has_param("alibi_scale", PARAM_FLOAT) else 1.0)
    alibi_sl = None
    if op.has_attr("alibi_slopes"):
        alibi_sl = require_attr(op, "alibi_slopes").array().astype(
            np.float32)
        if list(alibi_sl.shape) != [num_heads]:
            raise ValueError(f"RotaryAttention {op.name}: alibi_slopes "
                             f"shape {alibi_sl.shape} != [{num_heads}]")
    if num_heads % num_kv:
        raise ValueError(f"RotaryAttention {op.name}: num_heads "
                         f"{num_heads} not divisible by num_kv_heads "
                         f"{num_kv}")
    if op.has_param("head_dim", PARAM_INT):
        d = op.params["head_dim"].i
        if d < 1:
            raise ValueError(f"RotaryAttention {op.name}: head_dim "
                             f"must be >= 1, got {d}")
    else:
        if embed_dim % num_heads:
            raise ValueError(f"RotaryAttention {op.name}: embed_dim "
                             f"{embed_dim} not divisible by "
                             f"{num_heads} heads (declare head_dim)")
        d = embed_dim // num_heads
    if d % 2 and not alibi:
        raise ValueError(f"RotaryAttention {op.name}: head_dim {d} must "
                         f"be even for RoPE")
    rot_dim = (op.params["rotary_dim"].i
               if op.has_param("rotary_dim", PARAM_INT) else d)
    if not alibi and (rot_dim % 2 or not (2 <= rot_dim <= d)):
        raise ValueError(f"RotaryAttention {op.name}: rotary_dim "
                         f"{rot_dim} must be even and in [2, {d}]")
    rope_il = bool(op.params["rope_interleaved"].i
                   if op.has_param("rope_interleaved", PARAM_INT) else 0)
    group = num_heads // num_kv
    use_kernels = cfg.kernels_enabled

    weights: dict = {}
    for key, out_dim in (("q", num_heads * d), ("k", num_kv * d),
                         ("v", num_kv * d), ("o", embed_dim)):
        w = require_attr(op, f"{key}_proj.weight").array()
        in_dim = num_heads * d if key == "o" else embed_dim
        if list(w.shape) != [out_dim, in_dim]:
            raise ValueError(f"RotaryAttention {op.name}: "
                             f"{key}_proj.weight shape {w.shape} != "
                             f"[{out_dim}, {in_dim}]")
        weights[f"w{key}"] = torch.from_numpy(
            np.ascontiguousarray(w.T).astype(np.float32))
        if op.has_attr(f"{key}_proj.bias"):
            weights[f"b{key}"] = torch.from_numpy(
                require_attr(op, f"{key}_proj.bias").array()
                .astype(np.float32))
    qk_eps = (op.params["qk_norm_eps"].f
              if op.has_param("qk_norm_eps", PARAM_FLOAT) else 1e-6)
    attn_scale = (op.params["attn_scale"].f
                  if op.has_param("attn_scale", PARAM_FLOAT)
                  else 1.0 / math.sqrt(d))
    softcap = (op.params["logit_softcap"].f
               if op.has_param("logit_softcap", PARAM_FLOAT) else None)
    if softcap is not None and softcap <= 0:
        raise ValueError(f"RotaryAttention {op.name}: logit_softcap "
                         f"must be > 0, got {softcap}")
    for key, wkey in (("q_norm.weight", "wqn"), ("k_norm.weight", "wkn")):
        if op.has_attr(key):
            nw = require_attr(op, key).array().astype(np.float32)
            if list(nw.shape) != [d]:
                raise ValueError(f"RotaryAttention {op.name}: {key} "
                                 f"shape {nw.shape} != [{d}]")
            weights[wkey] = torch.from_numpy(nw)
    decode_info = {"embed_dim": embed_dim, "num_heads": num_heads,
                   "num_kv_heads": num_kv, "head_dim": d,
                   "rope_theta": theta, "rotary": not alibi,
                   "alibi": alibi, "alibi_scale": alibi_scale,
                   "alibi_slopes": alibi_sl, "rotary_dim": rot_dim,
                   "rope_interleaved": rope_il,
                   "batch_first": True, "sliding_window": sw,
                   "qk_norm_eps": qk_eps, "attn_scale": attn_scale,
                   "logit_softcap": softcap}
    slopes = resolve_alibi_slopes(decode_info) if alibi else None

    def apply(weights, x):
        dt = x.dtype
        l = x.shape[1]
        qh = project(x, weights, "q", num_heads, d, dt, use_kernels)
        kh = project(x, weights, "k", num_kv, d, dt, use_kernels)
        vh = project(x, weights, "v", num_kv, d, dt, use_kernels)
        qh, kh = apply_qk_norm(qh, kh, weights, qk_eps)
        if not alibi:
            cos, sin = rope_cos_sin(torch.arange(l, device=x.device),
                                    rot_dim, theta)       # [L, R]
            qh = apply_rope(qh, cos, sin, interleaved=rope_il)
            kh = apply_rope(kh, cos, sin, interleaved=rope_il)
        ctx = causal_context(qh, repeat_kv(kh, group), repeat_kv(vh, group),
                             attn_scale, use_kernels, sliding_window=sw,
                             softcap=softcap, alibi=slopes)
        return project_out(merge_heads(ctx), weights, dt, use_kernels)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"wq": 1, "wk": 1, "wv": 1, "wo": 1},
        # qk-norm weights stay f32 (the rsqrt normalization is
        # precision-sensitive and the vectors are tiny)
        fp32_keys=("wqn", "wkn"),
        decode_info=decode_info,
    )
