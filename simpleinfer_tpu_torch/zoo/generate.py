"""Autoregressive generation for causal LMs: the counterparts of
simpleinfer_tpu/zoo/generate's greedy_generate (fixed-window re-forward,
one engine forward per token) and CachedDecoder (KV-cache decode) for
both attention lineages: nn.MultiheadAttention (GPT: learned positions,
the graph's causal-mask operand dropped, since causality is implicit in
the cache) and si.RotaryAttention (llama, mistral's sliding windows,
gemma2's softcap, BLOOM's ALiBi).

The JAX package re-traces the engine's plan into jitted step / block /
prefill executables over donated cache buffers. PyTorch runs eagerly, so
here the same plan walk runs op by op on the device, and the caches are
updated IN PLACE (the methods still return them, so callers read like
the JAX package's). Nothing in a decode block waits for the host:
positions, tokens and the sampled ids stay on the device, and only the
caller's fetch of a block's tokens synchronises, so a service can
enqueue the next block before fetching the last one. An fp32 engine's
decoder runs with TF32 off (engine.fp32_parity), as Engine.forward does.

Cache leaves per attention op: (k, v) [N, KV, L, D] at the storage dtype
(float32 or bfloat16), or (k_q, k_s, v_q, v_s) for int8 — values
[N, KV, L, D] int8 and per-vector f32 scales [N, KV, L, 1]. A sliding
op's L is a RING of R = ceil((W + RING_HEADROOM) / 8) * 8 slots when
that is shorter than the window: position p lives at slot p % R.

Not ported yet: kv_prefix rungs, decode_chunk_verify, fuse_qkv,
sample_cap, window overrides and tensor-parallel meshes. The JAX
spellings decode_attn="xla" / "pallas" are "torch" / "kernel" here.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..engine import fp32_parity
from ..kernels import decode_attn as kdec
from ..ops.attention import (
    apply_qk_norm,
    apply_rope,
    cap_logits,
    causal_context,
    merge_heads,
    project,
    project_out,
    repeat_kv,
    resolve_alibi_slopes,
    rope_cos_sin,
)
from .sampling import all_greedy, sample_logits, step_generator

_NEG = torch.finfo(torch.float32).min
_ATTN = ("nn.MultiheadAttention", "si.RotaryAttention")


def _kv_quantize(x):
    """Symmetric int8 quantization of k/v vectors with one f32 scale per
    vector (over head_dim): x [..., D] -> (int8 [..., D], f32 [..., 1])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def greedy_generate(engine, prompt_ids, steps: int, *,
                    input_name: str | None = None,
                    output_name: str | None = None,
                    eos_id: int | None = None) -> np.ndarray:
    """Greedy-decode `steps` tokens after each prompt row by re-running
    the engine's whole window per token (O(L^2) a token, no cache).

    prompt_ids: [N, P] ints, P + steps <= the model's window L. Returns
    [N, P + steps] int64 (shorter once every row hit eos_id; rows that
    hit it earlier are padded with 0)."""
    input_name = input_name or engine.input_names[0]
    output_name = output_name or engine.output_names[0]
    prompt = np.asarray(prompt_ids)
    if prompt.ndim != 2:
        raise ValueError(f"prompt_ids must be [N, P], got {prompt.shape}")
    n, p = prompt.shape
    spec = next(s for s in engine.program.inputs if s.name == input_name)
    if not spec.shape or len(spec.shape) != 2:
        raise ValueError(f"input {input_name!r} is not a declared [N, L] "
                         f"token buffer: {spec.shape}")
    length = int(spec.shape[1])
    if p + steps > length:
        raise ValueError(f"prompt ({p}) + steps ({steps}) exceeds the "
                         f"window {length}")
    buf = np.zeros((n, length), np.float32)
    buf[:, :p] = prompt
    done = np.zeros(n, bool)
    cur = p
    for _ in range(steps):
        logits = engine.run({input_name: buf})[output_name]
        nxt = np.argmax(logits[:, cur - 1, :], axis=-1)
        buf[:, cur] = np.where(done, 0, nxt)
        if eos_id is not None:
            done |= (nxt == eos_id)
        cur += 1
        if eos_id is not None and done.all():
            break
    return buf[:, :cur].astype(np.int64)


class CachedDecoder:
    """KV-cache decode for causal-LM engines: O(L) per generated token.

    Walks the engine's plan (Program.plan): attention ops project only
    the new token's q/k/v (RoPE at each row's position for rotary ops),
    write k/v into the per-layer caches and attend over the cache under
    a position mask (banded for sliding ops, with the cap and the ALiBi
    slopes where the op has them); token-pointwise ops run as lowered,
    and graph constants spanning the window (position tables) are
    sliced at each row's position. Anything else raises.
    """

    _POINTWISE = {
        "nn.Embedding", "pnnx.Attribute", "BinaryOp", "nn.LayerNorm",
        "nn.RMSNorm", "nn.Linear", "nn.GELU", "nn.ReLU", "nn.SiLU",
        "nn.Tanh", "nn.Sigmoid", "nn.Softmax", "nn.Identity", "nn.Dropout",
    }

    #: ring slots beyond the sliding window, and the widest decode block
    #: over a ring (the JAX package's bound, set for its chunk verify,
    #: whose in-flight appends must not overwrite keys it still reads)
    RING_HEADROOM = 64

    def __init__(self, engine, kv_dtype: str | None = None,
                 scratch_blocks: bool = False, decode_attn: str = "torch"):
        """kv_dtype: KV-cache storage — None/"float32" (exact),
        "bfloat16" (half the cache bytes) or "int8" (a quarter; per-
        vector scales folded onto the scores and probabilities).

        scratch_blocks: decode_block keeps the block's new k/v in a
        small [N, KV, K, D] scratch, attends over frozen cache + scratch
        (the same key set, split masks) and writes the scratch into the
        cache once per block. Logits match the per-step path up to f32
        summation order.

        decode_attn: "torch" (default) or "kernel": the frozen-cache
        attention of scratch-mode blocks runs the per-row CUDA kernel
        (kernels/decode_attn.decode_attention; its plain version on a
        CPU engine). Requires scratch_blocks=True and a model with no
        sliding window (the kernel's mask has no band)."""
        if kv_dtype not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype must be float32/bfloat16/int8, "
                             f"got {kv_dtype!r}")
        if decode_attn not in ("torch", "kernel"):
            raise ValueError(f"decode_attn must be 'torch' or 'kernel', "
                             f"got {decode_attn!r}")
        if decode_attn == "kernel" and not scratch_blocks:
            raise ValueError("decode_attn='kernel' reads a FROZEN cache "
                             "per block; it requires scratch_blocks=True")
        self._kernel_decode = decode_attn == "kernel"
        self._kv_int8 = kv_dtype == "int8"
        self._kv_store = torch.bfloat16 if kv_dtype == "bfloat16" \
            else torch.float32
        self._scratch_blocks = bool(scratch_blocks)

        program = engine.program
        self._device = engine.device
        self._use_kernels = engine.config.kernels_enabled
        self._fp32 = engine.config.compute_torch_dtype == torch.float32
        if len(program.input_names) != 1 or len(program.output_names) != 1:
            raise ValueError("CachedDecoder expects one input (token "
                             "ids) and one output (logits)")
        spec = program.inputs[0]
        if not spec.shape or len(spec.shape) != 2:
            raise ValueError(f"token input must be [N, L], got "
                             f"{spec.shape}")
        self._window = int(spec.shape[1])
        self._in_name = program.input_names[0]
        self._out_name = program.output_names[0]
        self._plan = program.plan
        self._weights = engine._device_weights
        self._mha_ops = []
        last_attn = -1
        for i, (impl, _ins, _outs) in enumerate(self._plan):
            if impl.type == "nn.MultiheadAttention":
                info = impl.decode_info
                if not info or not info.get("batch_first"):
                    raise ValueError(f"{impl.name}: KV-cache decode needs "
                                     f"batch_first self-attention")
                if (info["kdim"] != info["embed_dim"]
                        or info["vdim"] != info["embed_dim"]):
                    raise ValueError(f"{impl.name}: kdim/vdim != "
                                     f"embed_dim unsupported")
            elif impl.type != "si.RotaryAttention" and \
                    impl.type not in self._POINTWISE:
                raise ValueError(
                    f"KV-cache decode: unsupported op type {impl.type!r} "
                    f"({impl.name}); supported: "
                    f"{sorted(self._POINTWISE)} + {list(_ATTN)}")
            if impl.type in _ATTN:
                self._mha_ops.append((impl.name, impl.decode_info))
                last_attn = i
        if self._kernel_decode and any(
                info.get("sliding_window") for _, info in self._mha_ops):
            raise ValueError("decode_attn='kernel' does not take sliding-"
                             "window attention (the kernel's mask has no "
                             "band); use decode_attn='torch'")
        # every op after the last attention op is token-pointwise, so
        # prefill runs them on each row's last prompt position only
        self._last_attn = max(last_attn, 0)
        self._has_ring = any(self._op_ring(info) is not None
                             for _, info in self._mha_ops)

    # ---- helpers ----------------------------------------------------------
    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, dtype=dtype, device=self._device)

    @contextlib.contextmanager
    def _mode(self):
        """inference mode, and TF32 off for an fp32 engine."""
        with torch.inference_mode(), fp32_parity(self._fp32):
            yield

    @staticmethod
    def _geometry(info):
        heads = info["num_heads"]
        kvh = info.get("num_kv_heads") or heads
        d = info.get("head_dim") or info["embed_dim"] // heads
        return heads, kvh, d

    def _proj_qkv(self, w, x, info, pos):
        """q/k/v of x [N, L, E] as [N, H, L, D] / [N, KV, L, D] x2, with
        the qk norm and, for rotary ops, RoPE at positions `pos` ([N]
        per-row for one token, or [L] shared across rows for a
        prefill)."""
        heads, kvh, d = self._geometry(info)
        dt = x.dtype
        qh = project(x, w, "q", heads, d, dt, self._use_kernels)
        kh = project(x, w, "k", kvh, d, dt, self._use_kernels)
        vh = project(x, w, "v", kvh, d, dt, self._use_kernels)
        qh, kh = apply_qk_norm(qh, kh, w, info.get("qk_norm_eps", 1e-6))
        if not info.get("rotary"):
            return qh, kh, vh
        cos, sin = rope_cos_sin(pos, info.get("rotary_dim") or d,
                                info["rope_theta"])
        if x.shape[1] == 1:                 # per-row positions [N, R]
            cos, sin = cos[:, None, None, :], sin[:, None, None, :]
        il = bool(info.get("rope_interleaved"))
        return (apply_rope(qh, cos, sin, interleaved=il),
                apply_rope(kh, cos, sin, interleaved=il), vh)

    @staticmethod
    def _scale(info, d):
        return info.get("attn_scale") or 1.0 / (d ** 0.5)

    @staticmethod
    def _slopes(info):
        return resolve_alibi_slopes(info) if info.get("alibi") else None

    def _logits(self, s, info, key_pos):
        """Raw f32 scores [N, H, Q, L] -> scaled, capped (gemma2) and
        ALiBi-biased by the absolute key positions `key_pos`
        (broadcastable to s), the op's order before its mask."""
        _, _, d = self._geometry(info)
        s = cap_logits(s * self._scale(info, d), info.get("logit_softcap"))
        slopes = self._slopes(info)
        if slopes is not None:
            s = s + torch.as_tensor(slopes, device=s.device)[
                None, :, None, None] * key_pos.float()
        return s

    def _store(self, kh, vh):
        """A prefill's captured k/v (views of the projections) as
        contiguous cache leaves."""
        if self._kv_int8:
            return tuple(t.contiguous() for t in (*_kv_quantize(kh),
                                                  *_kv_quantize(vh)))
        return (kh.to(self._kv_store).contiguous(),
                vh.to(self._kv_store).contiguous())

    # ---- cache ------------------------------------------------------------
    def _op_ring(self, info):
        """Ring length of a sliding op's cache (None = window storage): a
        sliding op never attends past its window W, so its cache holds
        W + RING_HEADROOM slots (8-aligned), where appends overwrite the
        oldest positions; both the memory and the per-step attention
        read are bounded by W instead of the window. Window storage
        when the ring would not be shorter."""
        sw = (info or {}).get("sliding_window")
        if sw is None:
            return None
        r = -(-(sw + self.RING_HEADROOM) // 8) * 8
        return r if r < self._window else None

    def _cache_len(self, info):
        return self._op_ring(info) or self._window

    def init_cache(self, batch: int, dtype=None):
        """Zeroed per-layer KV cache on the engine's device (int8 scales
        start at 1), each sliding op's sized to its ring."""
        dtype = dtype or self._kv_store
        caches = {}
        for name, info in self._mha_ops:
            _, kvh, d = self._geometry(info)
            shape = (batch, kvh, self._cache_len(info), d)
            if self._kv_int8:
                sshape = shape[:-1] + (1,)
                z8 = dict(dtype=torch.int8, device=self._device)
                f32 = dict(dtype=torch.float32, device=self._device)
                caches[name] = (torch.zeros(shape, **z8),
                                torch.ones(sshape, **f32),
                                torch.zeros(shape, **z8),
                                torch.ones(sshape, **f32))
            else:
                caches[name] = (
                    torch.zeros(shape, dtype=dtype, device=self._device),
                    torch.zeros(shape, dtype=dtype, device=self._device))
        return caches

    def cache_nbytes(self, batch: int, dtype=None) -> int:
        """Bytes init_cache(batch, dtype) would allocate, from the leaf
        shapes alone."""
        item = torch.empty((), dtype=dtype or self._kv_store).element_size()
        total = 0
        for _name, info in self._mha_ops:
            _, kvh, d = self._geometry(info)
            vec = batch * kvh * self._cache_len(info)
            total += (2 * vec * d + 2 * vec * 4 if self._kv_int8
                      else 2 * vec * d * item)
        return total

    def _cache_append(self, cache, kh, vh, pos, ring=None):
        """Write the new token's k/v ([N, KV, 1, D]) at each row's
        position (slot pos % ring for a ring), in place; returns the
        dense-readable (k, v) leaves."""
        rows = torch.arange(kh.shape[0], device=kh.device)
        slot = pos if ring is None else torch.remainder(pos, ring)
        if self._kv_int8:
            k_q, k_s, v_q, v_s = cache
            kq, ks = _kv_quantize(kh[:, :, 0, :])
            vq, vs = _kv_quantize(vh[:, :, 0, :])
            k_q[rows, :, slot] = kq
            k_s[rows, :, slot] = ks
            v_q[rows, :, slot] = vq
            v_s[rows, :, slot] = vs
            return (k_q, k_s), (v_q, v_s)
        k_cache, v_cache = cache
        k_cache[rows, :, slot] = kh[:, :, 0, :].to(k_cache.dtype)
        v_cache[rows, :, slot] = vh[:, :, 0, :].to(v_cache.dtype)
        return k_cache, v_cache

    def _leaves(self, cache):
        if self._kv_int8:
            return (cache[0], cache[1]), (cache[2], cache[3])
        return cache

    def _attn_scores(self, qh, k_leaf, group, dt):
        """Raw scores [N, H, Q, L] (f32) against the cached keys; the
        int8 scale is constant over head_dim, so it multiplies the
        scores."""
        if self._kv_int8:
            k_q, k_s = k_leaf
            s = torch.matmul(qh.float(), repeat_kv(
                k_q.to(dt), group).float().transpose(-1, -2))
            return s * repeat_kv(k_s.transpose(2, 3), group)
        return torch.matmul(qh.float(), repeat_kv(
            k_leaf.to(dt), group).float().transpose(-1, -2))

    def _attn_ctx(self, p, v_leaf, group, dt):
        """Context [N, H, Q, D] = probs @ cached values (the int8 value
        scale folds into the probs)."""
        if self._kv_int8:
            v_q, v_s = v_leaf
            p = p * repeat_kv(v_s.transpose(2, 3), group).to(p.dtype)
            return torch.matmul(p, repeat_kv(v_q.to(dt), group))
        return torch.matmul(p, repeat_kv(v_leaf.to(dt), group))

    @staticmethod
    def _ring_keep(top, idx, ring, q_pos, sw):
        """Live keys of a ring written up to position top <= q_pos: slot
        s holds the latest position <= top congruent to s, top - ((top -
        s) % R); live when it exists and lies in the query's band
        (q_pos - sw, q_pos]."""
        p_abs = top - torch.remainder(top - idx, ring)
        return (p_abs >= 0) & (p_abs > q_pos - sw), p_abs

    # ---- one step ---------------------------------------------------------
    def _attn_decode(self, w, x, cache, pos, info):
        """One decode step of either lineage against the full cache: the
        new k/v appended at each row's position (its ring slot for a
        ring), then the masked attention over the cache."""
        heads, kvh, d = self._geometry(info)
        group = heads // kvh
        dt = x.dtype
        sw = info.get("sliding_window")
        ring = self._op_ring(info)
        qh, kh, vh = self._proj_qkv(w, x, info, pos)
        k_leaf, v_leaf = self._cache_append(cache, kh, vh, pos, ring)
        raw = self._attn_scores(qh, k_leaf, group, dt)
        idx = torch.arange(raw.shape[-1], device=raw.device)
        pe = pos[:, None, None, None]
        if ring is not None:
            keep, p_abs = self._ring_keep(pe, idx, ring, pe, sw)
        else:
            p_abs = idx
            keep = idx <= pe
            if sw is not None:          # mistral band: last sw positions
                keep &= idx > pe - sw
        s = self._logits(raw, info, p_abs).masked_fill(~keep, _NEG)
        p = torch.softmax(s, dim=-1).to(dt)
        ctx = self._attn_ctx(p, v_leaf, group, dt)
        return project_out(merge_heads(ctx), w, dt, self._use_kernels)

    def _attn_decode_scratch(self, w, x, frozen, scratch, pos, step_i,
                             pos0, info, kernel_attn):
        """One decode step against the FROZEN cache (positions < pos0,
        never rewritten inside a block) plus the block's scratch (slot j
        holds block step j <= step_i): together exactly the per-step
        path's key set (`_attend_frozen_scratch`)."""
        dt = x.dtype
        qh, kh, vh = self._proj_qkv(w, x, info, pos)
        k_scr, v_scr = scratch                   # [N, KV, K, D]
        k_scr[:, :, step_i] = kh[:, :, 0, :].to(k_scr.dtype)
        v_scr[:, :, step_i] = vh[:, :, 0, :].to(v_scr.dtype)
        ctx = self._attend_frozen_scratch(qh, frozen, scratch, step_i, pos,
                                          pos0, info, dt, kernel_attn)
        return project_out(merge_heads(ctx), w, dt, self._use_kernels)

    def _attend_frozen_scratch(self, qh, frozen, scratch, step_i, pos, pos0,
                               info, dt, kernel_attn):
        """Context [N, H, 1, D] (at dt) of the queries qh [N, H, 1, D] at
        positions `pos` = pos0 + step_i over the frozen cache (positions
        < pos0; for a ring, the latest position < pos0 of each slot) and
        the scratch slots <= step_i, each banded for a sliding op. With
        `kernel_attn` the frozen part runs
        kernels/decode_attn.decode_attention and merges with the scratch
        part by online-softmax combination; else the f32 torch matmuls
        over the whole cache and one softmax over both parts."""
        n, heads, _, d = qh.shape
        _, kvh, _ = self._geometry(info)
        group = heads // kvh
        sw = info.get("sliding_window")
        ring = self._op_ring(info)
        k_scr, v_scr = scratch
        k_leaf, v_leaf = self._leaves(frozen)
        p0 = pos0[:, None, None, None]
        raw_new = torch.matmul(qh.float(), repeat_kv(
            k_scr.to(dt), group).float().transpose(-1, -2))
        sidx = torch.arange(raw_new.shape[-1], device=qh.device)
        s_new = self._logits(raw_new, info, p0 + sidx)
        keep_new = sidx <= step_i
        if sw is not None:          # scratch key j sits at pos0 + j
            keep_new = keep_new & (sidx > step_i - sw)
        s_new = s_new.masked_fill(~keep_new, _NEG)

        if kernel_attn:
            scale = self._scale(info, d)
            q4 = qh[:, :, 0, :].reshape(n, kvh, group, d).contiguous()
            of, mf, lf = kdec.decode_attention(q4, k_leaf, v_leaf, pos0,
                                               scale=scale)
            of = of.reshape(n, heads, 1, d)
            mf = mf.reshape(n, heads, 1, 1)
            lf = lf.reshape(n, heads, 1, 1)
            m_tot = torch.maximum(mf, s_new.amax(dim=-1, keepdim=True))
            p_new = torch.exp(s_new - m_tot)       # masked -> exact 0.0
            ctx_new = torch.matmul(p_new, repeat_kv(v_scr, group).float())
            carry = torch.exp(mf - m_tot)          # 0 when frozen empty
            l_tot = lf * carry + p_new.sum(dim=-1, keepdim=True)
            return ((of * carry + ctx_new) / l_tot).to(dt)
        raw_old = self._attn_scores(qh, k_leaf, group, dt)
        idx = torch.arange(raw_old.shape[-1], device=qh.device)
        q_pos = pos[:, None, None, None]
        if ring is not None:
            keep_old, p_abs = self._ring_keep(p0 - 1, idx, ring, q_pos, sw)
        else:
            p_abs = idx
            keep_old = idx < p0
            if sw is not None:      # band vs the query at pos0 + step_i
                keep_old = keep_old & (idx > q_pos - sw)
        s_old = self._logits(raw_old, info, p_abs).masked_fill(~keep_old,
                                                               _NEG)
        p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1).to(dt)
        p_old, p_new = p[..., :s_old.shape[-1]], p[..., s_old.shape[-1]:]
        return self._attn_ctx(p_old, v_leaf, group, dt) + torch.matmul(
            p_new, repeat_kv(v_scr.to(dt), group))

    def _slice_seq(self, args, pos):
        """A graph constant spanning the window (a learned position
        table [1, L, E]) beside a one-token activation [N, 1, E] is
        gathered at each row's position (clamped to the window)."""
        lens = [a.shape[1] if isinstance(a, torch.Tensor) and a.ndim == 3
                else None for a in args]
        if 1 not in lens or self._window not in lens or self._window == 1:
            return args
        n = pos.shape[0]
        idx = torch.clamp(pos, max=self._window - 1)[:, None]     # [N, 1]
        rows = torch.arange(n, device=pos.device)[:, None]
        return [a.expand(n, -1, -1)[rows, idx] if lens[i] == self._window
                else a for i, a in enumerate(args)]

    def _walk(self, token, attend, pos):
        """Run the plan on one token per row ([N, 1] float ids); `attend
        (impl, w, x)` computes each attention op. Returns logits
        [N, 1, V]."""
        env = {self._in_name: token}
        for impl, ins, outs in self._plan:
            w = self._weights.get(impl.name, {})
            if impl.type in _ATTN:
                env[outs[0]] = attend(impl, w, env[ins[0]])
                for o in outs[1:]:
                    env[o] = None
                continue
            args = [env[n] for n in ins]
            if len(args) > 1:
                args = self._slice_seq(args, pos)
            r = impl.apply(w, *args)
            if impl.n_outputs == 1:
                env[outs[0]] = r
            else:
                env.update(zip(outs, r))
        return env[self._out_name]

    def _step_fn(self, token, pos, caches):
        return self._walk(token, lambda impl, w, x: self._attn_decode(
            w, x, caches[impl.name], pos, impl.decode_info), pos)

    def _step_fn_scratch(self, token, pos, caches, scratches, step_i, pos0,
                         kernel_attn):
        return self._walk(token, lambda impl, w, x: self._attn_decode_scratch(
            w, x, caches[impl.name], scratches[impl.name], pos, step_i, pos0,
            impl.decode_info, kernel_attn), pos)

    def _scratch_merge(self, cache, scratch, pos0, k_steps, ring=None):
        """Write a block's scratch into the cache in one pass: position
        pos0[row] + j takes scratch slot j (ring slot (pos0 + j) % R;
        RING_HEADROOM >= K keeps them distinct). Positions past the
        window are clamped onto its last slot, which no live row reads
        (a row's last fed position is below its end, and its end is
        <= the window)."""
        k_scr, v_scr = scratch
        n = k_scr.shape[0]
        length = cache[0].shape[2]
        cols = pos0[:, None] + torch.arange(k_steps, device=pos0.device)
        cols = (torch.remainder(cols, ring) if ring is not None
                else torch.clamp(cols, max=length - 1))          # [N, K]
        rows = torch.arange(n, device=pos0.device)[:, None].expand(
            n, k_steps)
        ks, vs = k_scr.transpose(1, 2), v_scr.transpose(1, 2)  # [N,K,KV,D]
        if self._kv_int8:
            k_q, k_s, v_q, v_s = cache
            for leaf, val in zip((k_q, k_s, v_q, v_s),
                                 (*_kv_quantize(ks), *_kv_quantize(vs))):
                leaf[rows, :, cols] = val
        else:
            cache[0][rows, :, cols] = ks.to(cache[0].dtype)
            cache[1][rows, :, cols] = vs.to(cache[1].dtype)
        return cache

    # ---- prefill ----------------------------------------------------------
    def _attn_prefill(self, w, x, info):
        """Full-width attention of either lineage with k/v capture (the
        rotated k for rotary ops), causal whatever mask operand the graph
        carries."""
        heads, kvh, d = self._geometry(info)
        group = heads // kvh
        l = x.shape[1]
        qh, kh, vh = self._proj_qkv(
            w, x, info, torch.arange(l, device=x.device))
        ctx = causal_context(qh, repeat_kv(kh, group), repeat_kv(vh, group),
                             self._scale(info, d), self._use_kernels,
                             sliding_window=info.get("sliding_window"),
                             softcap=info.get("logit_softcap"),
                             alibi=self._slopes(info))
        out = project_out(merge_heads(ctx), w, x.dtype, self._use_kernels)
        return out, (kh, vh)

    @staticmethod
    def _ring_fold(t, ring, last_pos):
        """Captured k or v [N, KV, Lb, D] -> the ring layout [N, KV, R,
        D]: slot s takes the latest position <= each row's prompt end
        congruent to s (older turns lie outside the band; slots no
        position reaches hold clipped junk that the masks never read
        before an append overwrites them)."""
        n, kvh, lb, d = t.shape
        s_idx = torch.arange(ring, device=t.device)[None, :]
        p_s = last_pos[:, None] - torch.remainder(
            last_pos[:, None] - s_idx, ring)                     # [N, R]
        idx = torch.clamp(p_s, 0, lb - 1)[:, None, :, None].expand(
            n, kvh, ring, d)
        return torch.gather(t, 2, idx)

    def _prefill_plan(self, tokens, last_pos):
        """Walk the plan at [N, W], W <= the window, capturing each
        attention op's k/v as a cache of extent W (R for a ring). Returns
        (logits [N, V] at each row's last_pos, caches). Past the last
        attention op every op is token-pointwise, so the rest of the
        plan runs on each row's last position only (the same values the
        full-width walk gives there, for a fraction of the lm-head
        work)."""
        n, width = tokens.shape
        caches = {}
        env = {self._in_name: tokens}
        rows = torch.arange(n, device=tokens.device)
        for i, (impl, ins, outs) in enumerate(self._plan):
            w = self._weights.get(impl.name, {})
            if impl.type in _ATTN:
                info = impl.decode_info
                out, (kh, vh) = self._attn_prefill(w, env[ins[0]], info)
                ring = self._op_ring(info)
                if ring is not None:
                    kh = self._ring_fold(kh, ring, last_pos)
                    vh = self._ring_fold(vh, ring, last_pos)
                caches[impl.name] = self._store(kh, vh)
                env[outs[0]] = out
                for o in outs[1:]:
                    env[o] = None
            else:
                args = [env[n_] for n_ in ins]
                if len(args) > 1 and width != self._window:
                    # window-spanning constants (position tables) cut
                    # to the bucket's leading positions
                    lens = [a.shape[1] if isinstance(a, torch.Tensor)
                            and a.ndim == 3 else None for a in args]
                    if width in lens:
                        args = [a[:, :width] if lens[j] == self._window
                                else a for j, a in enumerate(args)]
                r = impl.apply(w, *args)
                if impl.n_outputs == 1:
                    env[outs[0]] = r
                else:
                    env.update(zip(outs, r))
            if i == self._last_attn:
                env = {k: (v[rows, last_pos][:, None]
                           if isinstance(v, torch.Tensor) and v.ndim == 3
                           and v.shape[0] == n and v.shape[1] == width
                           else v)
                       for k, v in env.items()}
        return env[self._out_name][:, -1, :], caches

    def _last_pos(self, lengths):
        return self._tensor(np.asarray(lengths) - 1, torch.long)

    def prefill(self, tokens, lengths):
        """Batched prompt prefill: tokens [N, L] padded to the window,
        lengths [N]. Returns (logits [N, V] at each row's last prompt
        position, caches ready for decode at pos = length)."""
        tokens = np.asarray(tokens)
        if tokens.shape[1] != self._window:
            raise ValueError(f"prefill tokens must span the window "
                             f"[N, {self._window}], got {tokens.shape}")
        with self._mode():
            return self._prefill_plan(self._tensor(tokens, torch.float32),
                                      self._last_pos(lengths))

    def prefill_sample(self, tokens, lengths, seed, step, temperature,
                       top_k, top_p):
        """prefill + sampling of the first new token: (token [N], caches)."""
        with self._mode():
            last, caches = self._prefill_plan(
                self._tensor(tokens, torch.float32), self._last_pos(lengths))
            return self._sample(last, seed, step, temperature, top_k,
                                top_p), caches

    def _sample(self, logits, seed, step, temperature, top_k, top_p):
        gen = None if all_greedy(temperature) else step_generator(
            self._device, seed, step)
        return sample_logits(logits, gen, temperature, top_k, top_p)

    def prefill_install(self, tokens, lengths, seed, step, temperature,
                        top_k, top_p, pool_caches, rows):
        """Admission: batched prefill at the bucket width W = tokens
        .shape[1] (<= the window), sampling of the first new token, and
        the write of each row's cache into pool rows `rows` (positions
        < W, or the whole ring; rows[j] >= the pool size drops row j).
        Returns (token [N], pool caches, updated in place)."""
        width = int(np.shape(tokens)[1])
        if width > self._window:
            raise ValueError(f"prefill tokens width {width} exceeds the "
                             f"window {self._window}")
        if int(np.max(np.asarray(lengths))) > width:
            raise ValueError("a row's length exceeds the prefill bucket "
                             "width")
        tok, caches = self.prefill_sample(tokens, lengths, seed, step,
                                          temperature, top_k, top_p)
        return tok, self.install_rows(pool_caches, caches, rows)

    def install_row(self, pool_caches, row_caches, row: int):
        """Write a batch-1 prefilled cache into pool row `row`."""
        return self.install_rows(pool_caches, row_caches, [row])

    def install_rows(self, pool_caches, batch_caches, rows):
        """Write a batch-S prefilled cache (extent W <= the window, or a
        whole ring) into pool rows `rows`, in place; rows[j] >= the pool
        size drops row j (padding)."""
        rows = np.asarray(rows)
        n_pool = next(iter(pool_caches.values()))[0].shape[0]
        sel = np.nonzero(rows < n_pool)[0]
        src = self._tensor(sel, torch.long)
        dst = self._tensor(rows[sel], torch.long)
        with torch.inference_mode():
            for name, leaves in batch_caches.items():
                for pool, new in zip(pool_caches[name], leaves):
                    pool[dst, :, :new.shape[2]] = new[src].to(pool.dtype)
        return pool_caches

    def merge_tokens(self, carry, admitted, rows):
        """Scatter freshly admitted rows' first tokens (slot order) into
        the pool-order token vector `carry`, on the device; rows[j] >=
        len(carry) drops entry j."""
        rows = np.asarray(rows)
        with torch.inference_mode():
            carry = self._tensor(carry, torch.long).reshape(-1).clone()
            sel = np.nonzero(rows < carry.shape[0])[0]
            carry[self._tensor(rows[sel], torch.long)] = admitted[
                self._tensor(sel, torch.long)].long()
        return carry

    # ---- decode -----------------------------------------------------------
    def step(self, tokens, pos, caches):
        """One decode step: tokens [N, 1], pos [N]. Returns (logits
        [N, 1, V], caches updated in place)."""
        with self._mode():
            pos_t = self._tensor(pos, torch.long)
            return self._step_fn(self._tensor(tokens, torch.float32), pos_t,
                                 caches), caches

    def step_sample(self, tokens, pos, caches, seed, step, temperature,
                    top_k, top_p):
        """One decode step returning the sampled token [N]."""
        logits, caches = self.step(tokens, pos, caches)
        with torch.inference_mode():
            return self._sample(logits[:, 0, :], seed, step, temperature,
                                top_k, top_p), caches

    @property
    def kernel_ok(self) -> bool:
        """True when the per-row decode kernel path is usable: scratch
        mode and no sliding window, logit softcap or ALiBi (the kernel's
        online softmax has no band, tanh or position-bias hook; the JAX
        package's rule)."""
        return self._scratch_blocks and not any(
            info.get("sliding_window") or info.get("logit_softcap")
            or info.get("alibi") for _, info in self._mha_ops)

    def decode_block(self, tokens, pos, caches, seed, step0, temperature,
                     top_k, top_p, k_steps: int, attn_impl="default"):
        """K decode steps: tokens [N] (the last sampled token per row — a
        host array or a device tensor from a previous block), pos [N]
        (its position). Returns (sampled tokens [N, K], last token [N],
        caches), all on the device and nothing waited for. Step i draws
        from the generator of step step0 + i, so streams do not depend
        on the block size. Tokens past a row's end are garbage the
        caller discards. Over ring caches K is at most RING_HEADROOM.

        attn_impl: "default" (the decoder's decode_attn), "torch" or
        "kernel" (requires kernel_ok) for the frozen-cache attention of
        scratch-mode blocks."""
        if attn_impl == "default":
            kernel_attn = self._kernel_decode
        elif attn_impl in ("torch", "kernel"):
            kernel_attn = attn_impl == "kernel"
        else:
            raise ValueError(f"attn_impl must be 'default', 'torch' or "
                             f"'kernel', got {attn_impl!r}")
        if kernel_attn and not self.kernel_ok:
            raise ValueError("attn_impl='kernel' needs scratch_blocks and "
                             "no sliding window, softcap or ALiBi")
        k_steps = int(k_steps)
        if self._has_ring and k_steps > self.RING_HEADROOM:
            raise ValueError(
                f"decode blocks over ring-stored sliding caches are "
                f"limited to {self.RING_HEADROOM} steps, got {k_steps}")
        last = self._window - 1
        greedy = all_greedy(temperature)
        with self._mode():
            tok = self._tensor(tokens, torch.long).reshape(-1)
            # a chained block may be fed past the window: clamp so its
            # writes stay in bounds
            p = torch.clamp(self._tensor(pos, torch.long), max=last)
            pos0 = p
            n = tok.shape[0]
            scratches = {}
            if self._scratch_blocks:
                for name, info in self._mha_ops:
                    _, kvh, d = self._geometry(info)
                    scratches[name] = tuple(
                        torch.zeros((n, kvh, k_steps, d),
                                    dtype=self._kv_store,
                                    device=self._device) for _ in range(2))
            toks = []
            for i in range(k_steps):
                x = tok.float()[:, None]
                if self._scratch_blocks:
                    logits = self._step_fn_scratch(x, p, caches, scratches, i,
                                                   pos0, kernel_attn)
                else:
                    logits = self._step_fn(x, p, caches)
                gen = None if greedy else step_generator(
                    self._device, seed, int(step0) + i)
                tok = sample_logits(logits[:, 0, :], gen, temperature, top_k,
                                    top_p)
                toks.append(tok)
                p = torch.clamp(p + 1, max=last)
            if self._scratch_blocks:
                for name, info in self._mha_ops:
                    self._scratch_merge(caches[name], scratches[name], pos0,
                                        k_steps, self._op_ring(info))
            return torch.stack(toks, dim=1), tok, caches

    def generate(self, prompt_ids, steps: int, eos_id: int | None = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 block: int | None = None) -> np.ndarray:
        """Decode with the KV cache: the prompt prefills in one pass,
        then tokens come in decode blocks of `block` steps
        (min(32, steps - 1) by default). temperature <= 0 is greedy.
        Returns [N, P + steps] int64 (shorter once every row hit
        eos_id)."""
        prompt = np.asarray(prompt_ids)
        n, p = prompt.shape
        if p + steps > self._window:
            raise ValueError(f"prompt ({p}) + steps ({steps}) exceeds "
                             f"the window {self._window}")
        t_arr = np.full(n, temperature, np.float32)
        k_arr = np.full(n, top_k, np.int64)
        p_arr = np.full(n, top_p, np.float32)
        blk = int(block) if block else max(1, min(32, steps - 1))

        buf = np.zeros((n, p + steps), np.int64)
        buf[:, :p] = prompt
        window = np.zeros((n, self._window), np.float32)
        window[:, :p] = prompt
        caches = self.init_cache(n)
        tok, caches = self.prefill_install(window, np.full(n, p), seed, 0,
                                           t_arr, k_arr, p_arr, caches,
                                           np.arange(n))
        if eos_id is None:
            # enqueue every block, chained on the device, then fetch
            handles, last, fed, step_no, rem = [], tok, p, 1, steps - 1
            while rem > 0:
                toks, last, caches = self.decode_block(
                    last, np.full(n, fed), caches, seed, step_no, t_arr,
                    k_arr, p_arr, blk)
                handles.append(toks)
                step_no, fed, rem = step_no + blk, fed + blk, rem - blk
            buf[:, p] = tok.cpu().numpy()
            if handles:
                gen = torch.cat(handles, dim=1).cpu().numpy()
                buf[:, p + 1:] = gen[:, :steps - 1]
            return buf

        done = np.zeros(n, bool)
        pending = [tok.cpu().numpy()]
        last_raw = pending[0]
        t, step_no = p, 1
        while t < p + steps:
            if not pending:
                toks, _last, caches = self.decode_block(
                    last_raw, np.full(n, t - 1), caches, seed, step_no,
                    t_arr, k_arr, p_arr, blk)
                toks = toks.cpu().numpy()
                step_no += blk
                last_raw = toks[:, -1]
                pending = [toks[:, j] for j in range(blk)]
            nxt = pending.pop(0)
            buf[:, t] = np.where(done, 0, nxt)
            done |= (nxt == eos_id)
            if done.all():
                return buf[:, :t + 1]
            t += 1
        return buf
