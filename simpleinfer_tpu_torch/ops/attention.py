"""Transformer op lowerings, ported subset: nn.Embedding and the
llama-style si.RotaryAttention, with the RoPE / qk-norm / GQA helpers
the KV-cache decoder (zoo/generate.py) shares (counterparts of
simpleinfer_tpu/ops/attention.py's).

Attention logits and softmax run in f32, P·V at the compute dtype. Past
the flash gate (kernels/attention.flash_profitable, causal Lk >= 256 by
default, the H100's crossover; the JAX package's TPU gate is 2048)
prefill runs kernels/attention.flash_attention when kernels are on;
shorter sequences take the unblocked torch path, as the JAX package
leaves them to XLA. Rank-3 [N, L, E] tensors are logical == physical.

Not ported yet: alibi, logit_softcap and sliding_window on the op (the
flash kernel computes the band; the op and the cache do not),
F.scaled_dot_product_attention, nn.MultiheadAttention, torch.matmul /
torch.bmm / torch.select.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ir.graph import PARAM_FLOAT, PARAM_INT
from ..kernels import attention as kattn
from ..quant.tensor import proj_nlo
from .registry import OpImpl, register_op, require_attr, require_param


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


def causal_context(qh, kh, vh, scale, use_kernels: bool):
    """Aligned-causal attention context [N, H, L, D] (kh/vh already
    repeated to H heads): the flash kernel past its gate when kernels
    are on, else f32 scores, a finfo.min mask, an f32 softmax and P·V at
    the input dtype. The flash result is a strided [N, H, L, D] view of
    [N, L, H, D] memory."""
    l = qh.shape[2]
    if use_kernels and kattn.flash_profitable(l, l):
        return kattn.flash_attention(qh, kh, vh, causal=True, scale=scale)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    keep = torch.ones((l, l), dtype=torch.bool, device=s.device).tril()
    s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(qh.dtype)
    return torch.matmul(p, vh)


def merge_heads(ctx):
    """[N, H, L, D] -> [N, L, H*D]."""
    n, h, l, d = ctx.shape
    return ctx.transpose(1, 2).reshape(n, l, h * d)


def project(x, w, key, heads, d, dt, use_kernels):
    """q/k/v projection of x [N, L, E] through weight `w{key}` (+ bias
    `b{key}`): [N, heads, L, D] at dt."""
    n, l = x.shape[0], x.shape[1]
    y = proj_nlo(x, w[f"w{key}"], dt, use_kernels)
    if f"b{key}" in w:
        y = y + w[f"b{key}"]
    return y.to(dt).reshape(n, l, heads, d).transpose(1, 2)


def project_out(ctx, w, dt, use_kernels):
    """Output projection ctx [N, L, H*D] @ wo (+ bo) at dt."""
    out = proj_nlo(ctx, w["wo"], dt, use_kernels)
    if "bo" in w:
        out = out + w["bo"]
    return out.to(dt)


# ------------------------------------------------------- rotary attention
@register_op("si.RotaryAttention")
def lower_rotary_attention(op, cfg):
    """Llama-style decoder self-attention as ONE composite op: q/k/v/o
    projections, RoPE (HF rotate_half, or the interleaved GPT-J wiring;
    partial rotary_dim), grouped-query attention, optional qwen3 per-head
    qk RMSNorm, a decoupled head_dim and attention scale, and an
    intrinsic causal mask. Attrs {q,k,v,o}_proj.weight ([out, in]) and
    optional biases; input x [N, L, E], output [N, L, E]."""
    embed_dim = require_param(op, "embed_dim", PARAM_INT).i
    num_heads = require_param(op, "num_heads", PARAM_INT).i
    num_kv = (op.params["num_kv_heads"].i
              if op.has_param("num_kv_heads", PARAM_INT) else num_heads)
    theta = (op.params["rope_theta"].f
             if op.has_param("rope_theta", PARAM_FLOAT) else 10000.0)
    for key in ("sliding_window", "alibi", "logit_softcap"):
        if op.has_param(key) and not (key == "alibi"
                                      and op.params[key].i == 0):
            raise NotImplementedError(
                f"RotaryAttention {op.name}: {key} is not ported yet")
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
    if d % 2:
        raise ValueError(f"RotaryAttention {op.name}: head_dim {d} must "
                         f"be even for RoPE")
    rot_dim = (op.params["rotary_dim"].i
               if op.has_param("rotary_dim", PARAM_INT) else d)
    if rot_dim % 2 or not (2 <= rot_dim <= d):
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
    for key, wkey in (("q_norm.weight", "wqn"), ("k_norm.weight", "wkn")):
        if op.has_attr(key):
            nw = require_attr(op, key).array().astype(np.float32)
            if list(nw.shape) != [d]:
                raise ValueError(f"RotaryAttention {op.name}: {key} "
                                 f"shape {nw.shape} != [{d}]")
            weights[wkey] = torch.from_numpy(nw)

    def apply(weights, x):
        dt = x.dtype
        l = x.shape[1]
        qh = project(x, weights, "q", num_heads, d, dt, use_kernels)
        kh = project(x, weights, "k", num_kv, d, dt, use_kernels)
        vh = project(x, weights, "v", num_kv, d, dt, use_kernels)
        qh, kh = apply_qk_norm(qh, kh, weights, qk_eps)
        cos, sin = rope_cos_sin(torch.arange(l, device=x.device), rot_dim,
                                theta)                    # [L, R]
        qh = apply_rope(qh, cos, sin, interleaved=rope_il)
        kh = apply_rope(kh, cos, sin, interleaved=rope_il)
        ctx = causal_context(qh, repeat_kv(kh, group), repeat_kv(vh, group),
                             attn_scale, use_kernels)
        return project_out(merge_heads(ctx), weights, dt, use_kernels)

    return OpImpl(
        name=op.name, type=op.type, apply=apply, weights=weights,
        quantizable={"wq": 1, "wk": 1, "wv": 1, "wo": 1},
        # qk-norm weights stay f32 (the rsqrt normalization is
        # precision-sensitive and the vectors are tiny)
        fp32_keys=("wqn", "wkn"),
        decode_info={"embed_dim": embed_dim, "num_heads": num_heads,
                     "num_kv_heads": num_kv, "head_dim": d,
                     "rope_theta": theta, "rotary": True,
                     "rotary_dim": rot_dim, "rope_interleaved": rope_il,
                     "batch_first": True, "qk_norm_eps": qk_eps,
                     "attn_scale": attn_scale},
    )
