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

Beyond one token a step: kv_prefix rungs bound a decode block's read of
the position-indexed caches (a ring is read whole), sample_cap draws
among the top candidates, fuse_qkv runs one q|k|v projection a step,
window= caps the caches below the model's seq_len (the tiered pools of
serving/llm.py), and decode_chunk_verify feeds K tokens a row through
the cache in one pass (zoo/speculative.py). The JAX spellings
decode_attn="xla" / "pallas" are "torch" / "kernel" here.

On a tensor-parallel engine (EngineConfig.mesh with model > 1) each rank
decodes its own heads: an attention op whose heads divide the model
axis runs this rank's q / kv heads (the caches hold its kv heads, the
kernels run at those shapes) and reduces its output projection over
the model group (an all_reduce, or the ring of parallel/tp in tp_mode
"ring"); an op whose heads do not divide runs whole on every rank with
a whole cache. Column-sharded linears and embeddings all-gather their
output columns. Every rank then holds the same logits: greedy decode
agrees by construction, and a sampled draw is broadcast from the
model axis' first rank.
"""
from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ..engine import fp32_parity
from ..kernels import decode_attn as kdec
from ..ops.attention import (
    alibi_slopes,
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
    split_heads,
)
from ..parallel.mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SPATIAL,
                             all_gather, axis_group, axis_index, axis_size)
from ..quant.tensor import Quantized4Tensor, QuantizedTensor, proj_nlo
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
                 scratch_blocks: bool = False, fuse_qkv: bool = False,
                 sample_cap: int | None = None, decode_attn: str = "torch",
                 window: int | None = None):
        """window: cap the cache length and every position bound below
        the model's seq_len (the tiered pools of serving/llm.py): rows
        must never outgrow it (generate and prefill check). None = the
        model's seq_len.

        kv_dtype: KV-cache storage — None/"float32" (exact),
        "bfloat16" (half the cache bytes) or "int8" (a quarter; per-
        vector scales folded onto the scores and probabilities).

        scratch_blocks: decode_block keeps the block's new k/v in a
        small [N, KV, K, D] scratch, attends over frozen cache + scratch
        (the same key set, split masks) and writes the scratch into the
        cache once per block. Logits match the per-step path up to f32
        summation order.

        fuse_qkv: each attention op's q, k and v weights are concatenated
        along N once, here (int4 nibbles and group scales, int8 data and
        channel scales, or dense), and a decode step runs one [E,
        (H + 2 KV) D] projection instead of three; prefill and chunk
        verification keep the three. Per-column math is unchanged.

        sample_cap: draw among the `sample_cap` highest-scoring tokens
        (zoo/sampling.sample_logits' cap): exact for greedy rows and rows
        with 0 < top_k <= cap; nucleus-only rows are truncated to the
        cap. decode_block and prefill_install override it per call.

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
        if sample_cap is not None and int(sample_cap) < 1:
            raise ValueError(f"sample_cap must be >= 1, got {sample_cap}")
        # public: serving/llm.py checks requests against the exact regime
        self.sample_cap = None if sample_cap is None else int(sample_cap)
        self._trunc_warned = False
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
        # graph constants (position tables) span the MODEL's seq_len; the
        # caches and position bounds span self._window, which a window
        # override makes shorter
        self._model_window = int(spec.shape[1])
        self._window = self._model_window
        if window is not None:
            if not 1 <= int(window) <= self._model_window:
                raise ValueError(
                    f"window override must be in [1, "
                    f"{self._model_window}] (the model's seq_len), got "
                    f"{window}")
            self._window = int(window)
        self._in_name = program.input_names[0]
        self._out_name = program.output_names[0]
        self._plan = program.plan
        self._weights = engine._device_weights
        self._mesh = getattr(engine, "mesh", None)
        modes = {}
        if self._mesh is not None:
            # tensor-parallel decode: the engine's weights are already
            # this rank's shards (executor.op_shardings); the slot batch
            # stays whole on every rank. Spread THROUGHPUT over a DP
            # engine pool (serving/batcher.py), use TP to fit / speed up
            # one model
            if axis_size(self._mesh, AXIS_DATA) > 1 or \
                    axis_size(self._mesh, AXIS_SPATIAL) > 1:
                raise ValueError(
                    "CachedDecoder shards over the `model` axis only; "
                    "use a DP engine pool for data parallelism")
            from ..parallel.tp import RowParallel

            modes = engine.op_modes
            self._reduce = RowParallel(self._mesh, engine.config.tp_mode,
                                       self._use_kernels)
        self._gather_ops = {n for n, m in modes.items() if m == "column"}
        self._info = {}
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
                info = impl.decode_info
                if modes.get(impl.name) == "heads":
                    info = self._rank_heads(info)
                self._info[impl.name] = info
                self._mha_ops.append((impl.name, info))
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
        if fuse_qkv:
            self._weights = self._fuse_attention_weights(self._weights)

    def _rank_heads(self, info):
        """The decode_info of this rank's heads of a head-sharded op: its
        q and kv heads, its ALiBi slopes, and the model-group reduce of
        its output projection."""
        heads, kvh, d = self._geometry(info)
        m = axis_size(self._mesh, AXIS_MODEL)
        j = axis_index(self._mesh, AXIS_MODEL)
        hl = heads // m
        local = dict(info, num_heads=hl, num_kv_heads=kvh // m,
                     head_dim=d, tp_reduce=self._reduce.project)
        if info.get("alibi"):
            sl = info.get("alibi_slopes")
            sl = (np.asarray(sl, np.float32) if sl is not None
                  else alibi_slopes(heads))
            local["alibi_slopes"] = sl[j * hl:(j + 1) * hl]
        return local

    def _apply(self, impl, w, args):
        """A non-attention op of the plan; a column-sharded one (under a
        mesh) all-gathers its output columns over the model group."""
        r = impl.apply(w, *args)
        if impl.name in self._gather_ops:
            r = all_gather(r, self._mesh, AXIS_MODEL, -1)
        return r

    def _out(self, ctx, w, dt, info):
        """Output projection of a context [N, H, L, D]; reduced over the
        model group for a head-sharded op."""
        return project_out(merge_heads(ctx), w, dt, self._use_kernels,
                           info.get("tp_reduce"))

    def _agree(self, tok, greedy: bool):
        """Every rank's sampled token [N] equal: greedy draws are by
        construction (every rank holds the same logits); a sampled draw
        is the model axis' first rank's, broadcast."""
        if self._mesh is None or greedy:
            return tok
        import torch.distributed as dist

        group = axis_group(self._mesh, AXIS_MODEL)
        tok = tok.contiguous()
        dist.broadcast(tok, src=dist.get_global_rank(group, 0), group=group)
        return tok

    def _fuse_attention_weights(self, weights):
        """A copy of the weights where each attention op's dict also
        holds "wqkv" (+ "bqkv"): q, k and v concatenated along N. int4
        packs along K, so the nibbles and the group scales concatenate
        along N as they are; int8 weights concatenate data and channel
        scales; mixed or partly biased triples stay unfused. The
        original keys stay (prefill and chunk verification use them)."""
        out = dict(weights)
        for name, _info in self._mha_ops:
            w = dict(weights.get(name, {}))
            if not all(k in w for k in ("wq", "wk", "wv")):
                continue
            parts = [w["wq"], w["wk"], w["wv"]]
            if all(isinstance(p, QuantizedTensor) and p.axis == 1
                   for p in parts):
                fused = QuantizedTensor(
                    data=torch.cat([p.data for p in parts], dim=1),
                    scale=torch.cat([p.scale for p in parts]), axis=1)
            elif all(isinstance(p, Quantized4Tensor) for p in parts) and \
                    len({(p.group, p.k) for p in parts}) == 1:
                fused = Quantized4Tensor(
                    packed=torch.cat([p.packed for p in parts], dim=1),
                    scale=torch.cat([p.scale for p in parts], dim=1),
                    group=parts[0].group, k=parts[0].k)
            elif all(isinstance(p, torch.Tensor) for p in parts):
                fused = torch.cat(parts, dim=1)
            else:
                continue
            biases = [f"b{k}" in w for k in "qkv"]
            if any(biases) and not all(biases):
                continue
            w["wqkv"] = fused
            if all(biases):
                w["bqkv"] = torch.cat([w["bq"], w["bk"], w["bv"]])
            out[name] = w
        return out

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
        per-row for one token, [L] shared across rows for a prefill, or
        [N, L] per row and token for a verify chunk). A decode step
        takes the fused projection where fuse_qkv made one."""
        heads, kvh, d = self._geometry(info)
        dt = x.dtype
        if "wqkv" in w and x.shape[1] == 1:
            y = proj_nlo(x, w["wqkv"], dt, self._use_kernels)
            if "bqkv" in w:
                y = y + w["bqkv"]
            y = y.to(dt)
            qd, kd = heads * d, kvh * d
            qh, kh, vh = (split_heads(y[..., :qd], heads, d),
                          split_heads(y[..., qd:qd + kd], kvh, d),
                          split_heads(y[..., qd + kd:], kvh, d))
        else:
            qh = project(x, w, "q", heads, d, dt, self._use_kernels)
            kh = project(x, w, "k", kvh, d, dt, self._use_kernels)
            vh = project(x, w, "v", kvh, d, dt, self._use_kernels)
        qh, kh = apply_qk_norm(qh, kh, w, info.get("qk_norm_eps", 1e-6))
        if not info.get("rotary"):
            return qh, kh, vh
        cos, sin = rope_cos_sin(pos, info.get("rotary_dim") or d,
                                info["rope_theta"])
        if pos.ndim == 2:                   # per row and token [N, L, R]
            cos, sin = cos[:, None], sin[:, None]
        elif x.shape[1] == 1:               # per-row positions [N, R]
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

    @staticmethod
    def _kv_slice(leaf, kv_prefix):
        """A cache leaf (a tensor or an int8 (values, scales) pair) cut
        to its first kv_prefix positions (axis 2): the attention reads
        [*, P, *] instead of the window. Exact when every live row's
        keys lie below the rung: the positions dropped were masked to
        exact zeros. Rings are never cut (their slots are not
        positions)."""
        if kv_prefix is None:
            return leaf
        if isinstance(leaf, tuple):
            return tuple(a[:, :, :kv_prefix] for a in leaf)
        return leaf[:, :, :kv_prefix]

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
    def _attn_decode(self, w, x, cache, pos, info, kv_prefix=None):
        """One decode step of either lineage against the full cache: the
        new k/v appended at each row's position (its ring slot for a
        ring), then the masked attention over the cache (its first
        kv_prefix positions when a rung is given and the op has no
        ring)."""
        heads, kvh, d = self._geometry(info)
        group = heads // kvh
        dt = x.dtype
        sw = info.get("sliding_window")
        ring = self._op_ring(info)
        qh, kh, vh = self._proj_qkv(w, x, info, pos)
        k_leaf, v_leaf = self._cache_append(cache, kh, vh, pos, ring)
        if ring is None:            # ring slots are not position-sliced
            k_leaf = self._kv_slice(k_leaf, kv_prefix)
            v_leaf = self._kv_slice(v_leaf, kv_prefix)
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
        return self._out(ctx, w, dt, info)

    def _attn_decode_scratch(self, w, x, frozen, scratch, pos, step_i,
                             pos0, info, kernel_attn, kv_prefix=None):
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
                                          pos0, info, dt, kernel_attn,
                                          kv_prefix)
        return self._out(ctx, w, dt, info)

    def _attend_frozen_scratch(self, qh, frozen, scratch, step_i, pos, pos0,
                               info, dt, kernel_attn, kv_prefix=None):
        """Context [N, H, 1, D] (at dt) of the queries qh [N, H, 1, D] at
        positions `pos` = pos0 + step_i over the frozen cache (positions
        < pos0; for a ring, the latest position < pos0 of each slot) and
        the scratch slots <= step_i, each banded for a sliding op. With
        `kernel_attn` the frozen part runs
        kernels/decode_attn.decode_attention (a rung `kv_prefix` is its
        max_len) and merges with the scratch part by online-softmax
        combination; else the f32 torch matmuls over the cache (its
        first kv_prefix positions, unless the op has a ring) and one
        softmax over both parts."""
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
                                               scale=scale, max_len=kv_prefix)
            of = of.reshape(n, heads, 1, d)
            mf = mf.reshape(n, heads, 1, 1)
            lf = lf.reshape(n, heads, 1, 1)
            m_tot = torch.maximum(mf, s_new.amax(dim=-1, keepdim=True))
            p_new = torch.exp(s_new - m_tot)       # masked -> exact 0.0
            ctx_new = torch.matmul(p_new, repeat_kv(v_scr, group).float())
            carry = torch.exp(mf - m_tot)          # 0 when frozen empty
            l_tot = lf * carry + p_new.sum(dim=-1, keepdim=True)
            return ((of * carry + ctx_new) / l_tot).to(dt)
        if ring is None:
            k_leaf = self._kv_slice(k_leaf, kv_prefix)
            v_leaf = self._kv_slice(v_leaf, kv_prefix)
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

    def _slice_seq(self, args, pos, width: int = 1):
        """A graph constant spanning the model's window (a learned
        position table [1, L, E]) beside an activation of `width` tokens
        a row ([N, width, E]: one for a decode step, K for a verify
        chunk) is gathered at each row's positions pos .. pos + width - 1
        (clamped to the window)."""
        mw = self._model_window
        lens = [a.shape[1] if isinstance(a, torch.Tensor) and a.ndim == 3
                else None for a in args]
        if width not in lens or mw not in lens or mw == width:
            return args
        n = pos.shape[0]
        idx = torch.clamp(pos[:, None] + torch.arange(
            width, device=pos.device), max=mw - 1)             # [N, W]
        rows = torch.arange(n, device=pos.device)[:, None]
        return [a.expand(n, -1, -1)[rows, idx] if lens[i] == mw
                else a for i, a in enumerate(args)]

    def _walk(self, token, attend, pos):
        """Run the plan on W tokens per row ([N, W] float ids, fed at
        positions pos .. pos + W - 1); `attend(impl, w, x)` computes each
        attention op. Returns logits [N, W, V]."""
        width = token.shape[1]
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
                args = self._slice_seq(args, pos, width)
            r = self._apply(impl, w, args)
            if impl.n_outputs == 1:
                env[outs[0]] = r
            else:
                env.update(zip(outs, r))
        return env[self._out_name]

    def _step_fn(self, token, pos, caches, kv_prefix=None):
        return self._walk(token, lambda impl, w, x: self._attn_decode(
            w, x, caches[impl.name], pos, self._info[impl.name],
            kv_prefix), pos)

    def _step_fn_scratch(self, token, pos, caches, scratches, step_i, pos0,
                         kernel_attn, kv_prefix=None):
        return self._walk(token, lambda impl, w, x: self._attn_decode_scratch(
            w, x, caches[impl.name], scratches[impl.name], pos, step_i, pos0,
            self._info[impl.name], kernel_attn, kv_prefix), pos)

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
        out = self._out(ctx, w, x.dtype, info)
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
                info = self._info[impl.name]
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
                mw = self._model_window
                if len(args) > 1 and width != mw:
                    # constants spanning the model's window (position
                    # tables) cut to the bucket's leading positions
                    lens = [a.shape[1] if isinstance(a, torch.Tensor)
                            and a.ndim == 3 else None for a in args]
                    if width in lens:
                        args = [a[:, :width] if lens[j] == mw
                                else a for j, a in enumerate(args)]
                r = self._apply(impl, w, args)
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
                       top_k, top_p, sample_cap="default"):
        """prefill + sampling of the first new token: (token [N], caches)."""
        with self._mode():
            last, caches = self._prefill_plan(
                self._tensor(tokens, torch.float32), self._last_pos(lengths))
            return self._sample(last, seed, step, temperature, top_k,
                                top_p, self._cap_of(sample_cap)), caches

    def _cap_of(self, sample_cap):
        """A per-call sampler cap: "default" is the decoder's, None the
        exact full-vocabulary sampler, an int that cap."""
        if sample_cap == "default":
            return self.sample_cap
        return None if sample_cap is None else int(sample_cap)

    def _sample(self, logits, seed, step, temperature, top_k, top_p,
                cap=None):
        greedy = all_greedy(temperature)
        gen = None if greedy else step_generator(self._device, seed, step)
        return self._agree(sample_logits(logits, gen, temperature, top_k,
                                         top_p, cap), greedy)

    def prefill_install(self, tokens, lengths, seed, step, temperature,
                        top_k, top_p, pool_caches, rows,
                        sample_cap="default"):
        """Admission: batched prefill at the bucket width W = tokens
        .shape[1] (<= the window), sampling of the first new token, and
        the write of each row's cache into pool rows `rows` (positions
        < W, or the whole ring; rows[j] >= the pool size drops row j).
        sample_cap: the wave's sampler cap, as decode_block's. Returns
        (token [N], pool caches, updated in place)."""
        width = int(np.shape(tokens)[1])
        if width > self._window:
            raise ValueError(f"prefill tokens width {width} exceeds the "
                             f"window {self._window}")
        if int(np.max(np.asarray(lengths))) > width:
            raise ValueError("a row's length exceeds the prefill bucket "
                             "width")
        tok, caches = self.prefill_sample(tokens, lengths, seed, step,
                                          temperature, top_k, top_p,
                                          sample_cap)
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
    def _check_prefix(self, kv_prefix):
        """A validated rung: None, or an int in [1, window) (the window
        itself is no rung)."""
        if kv_prefix is None:
            return None
        kv_prefix = int(kv_prefix)
        if not 1 <= kv_prefix <= self._window:
            raise ValueError(f"kv_prefix must be in [1, {self._window}], "
                             f"got {kv_prefix}")
        return None if kv_prefix == self._window else kv_prefix

    def step(self, tokens, pos, caches, kv_prefix: int | None = None):
        """One decode step: tokens [N, 1], pos [N]. Returns (logits
        [N, 1, V], caches updated in place). kv_prefix: a rung bounding
        the read of position-indexed caches, as decode_block's."""
        kv_prefix = self._check_prefix(kv_prefix)
        with self._mode():
            pos_t = self._tensor(pos, torch.long)
            return self._step_fn(self._tensor(tokens, torch.float32), pos_t,
                                 caches, kv_prefix), caches

    def step_sample(self, tokens, pos, caches, seed, step, temperature,
                    top_k, top_p):
        """One decode step returning the sampled token [N]."""
        logits, caches = self.step(tokens, pos, caches)
        with torch.inference_mode():
            return self._sample(logits[:, 0, :], seed, step, temperature,
                                top_k, top_p, self.sample_cap), caches

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
                     top_k, top_p, k_steps: int,
                     kv_prefix: int | None = None, sample_cap="default",
                     attn_impl="default"):
        """K decode steps: tokens [N] (the last sampled token per row — a
        host array or a device tensor from a previous block), pos [N]
        (its position). Returns (sampled tokens [N, K], last token [N],
        caches), all on the device and nothing waited for. Step i draws
        from the generator of step step0 + i, so streams do not depend
        on the block size. Tokens past a row's end are garbage the
        caller discards. Over ring caches K is at most RING_HEADROOM.

        kv_prefix: a rung bounding the attention read of the
        position-indexed caches: the torch route reads their first
        kv_prefix positions, the kernel route gets it as
        decode_attention's max_len; ring caches are read whole. Exact
        when every LIVE row has pos + k_steps <= kv_prefix; rows the
        caller discards may exceed it. The caches keep their shape.

        sample_cap: this block's sampler cap — "default" (the decoder's),
        None (the exact full-vocabulary sampler) or an int.

        attn_impl: "default" (the decoder's decode_attn), "torch" or
        "kernel" (requires kernel_ok) for the frozen-cache attention of
        scratch-mode blocks."""
        kv_prefix = self._check_prefix(kv_prefix)
        cap = self._cap_of(sample_cap)
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
                                                   pos0, kernel_attn,
                                                   kv_prefix)
                else:
                    logits = self._step_fn(x, p, caches, kv_prefix)
                gen = None if greedy else step_generator(
                    self._device, seed, int(step0) + i)
                tok = self._agree(sample_logits(
                    logits[:, 0, :], gen, temperature, top_k, top_p, cap),
                    greedy)
                toks.append(tok)
                p = torch.clamp(p + 1, max=last)
            if self._scratch_blocks:
                for name, info in self._mha_ops:
                    self._scratch_merge(caches[name], scratches[name], pos0,
                                        k_steps, self._op_ring(info))
            return torch.stack(toks, dim=1), tok, caches

    # ---- verify chunks ----------------------------------------------------
    def _chunk_append(self, cache, kh, vh, pos, ring):
        """Write a chunk's k/v ([N, KV, K, D]) at positions pos .. pos +
        K - 1 (ring slots (pos + j) % R), in place. Positions past the
        window clamp onto its last slot, and every write that lands
        there carries the chunk entry of the last position inside the
        window, so the duplicates agree and the window's last real key
        survives (the JAX package drops those writes)."""
        n, _, k, _ = kh.shape
        j = torch.arange(k, device=pos.device)
        cols = pos[:, None] + j                                  # [N, K]
        if ring is not None:
            cols = torch.remainder(cols, ring)
            src = j.expand(n, k)
        else:
            cols = torch.clamp(cols, max=cache[0].shape[2] - 1)
            src = cols - pos[:, None]                   # min(j, L-1-pos)
        rows = torch.arange(n, device=pos.device)[:, None].expand(n, k)
        idx = src[:, None, :, None].expand(-1, kh.shape[1], -1, kh.shape[3])
        ks = torch.gather(kh, 2, idx).transpose(1, 2)          # [N,K,KV,D]
        vs = torch.gather(vh, 2, idx).transpose(1, 2)
        if self._kv_int8:
            for leaf, val in zip(cache, (*_kv_quantize(ks),
                                         *_kv_quantize(vs))):
                leaf[rows, :, cols] = val
        else:
            cache[0][rows, :, cols] = ks.to(cache[0].dtype)
            cache[1][rows, :, cols] = vs.to(cache[1].dtype)
        return self._leaves(cache)

    def _attn_chunk(self, w, x, cache, pos, info):
        """A verify chunk through one attention op: project (and rotate)
        the K tokens a row of x [N, K, E], append their k/v at pos ..
        pos + K - 1, and attend each chunk query q_i over the cache
        positions <= pos + i (banded for a sliding op; a ring's slots
        resolved to the latest position <= pos + K - 1). The K-token
        counterpart of _attn_decode."""
        heads, kvh, _ = self._geometry(info)
        group = heads // kvh
        dt = x.dtype
        k = x.shape[1]
        sw = info.get("sliding_window")
        ring = self._op_ring(info)
        positions = torch.clamp(pos[:, None] + torch.arange(
            k, device=pos.device), max=self._window - 1)          # [N, K]
        qh, kh, vh = self._proj_qkv(w, x, info, positions)
        k_leaf, v_leaf = self._chunk_append(cache, kh, vh, pos, ring)
        raw = self._attn_scores(qh, k_leaf, group, dt)       # [N, H, K, L]
        idx = torch.arange(raw.shape[-1], device=raw.device)
        q_pos = positions[:, None, :, None]
        if ring is not None:
            top = (pos + k - 1)[:, None, None, None]
            keep, p_abs = self._ring_keep(top, idx, ring, q_pos, sw)
            keep &= p_abs <= q_pos
        else:
            p_abs = idx
            keep = idx <= q_pos
            if sw is not None:
                keep &= idx > q_pos - sw
        s = self._logits(raw, info, p_abs).masked_fill(~keep, _NEG)
        p = torch.softmax(s, dim=-1).to(dt)
        ctx = self._attn_ctx(p, v_leaf, group, dt)             # [N, H, K, D]
        return self._out(ctx, w, dt, info)

    def _chunk_fn(self, tokens, pos, caches):
        """The plan at chunk width K: tokens [N, K] fed at pos .. pos + K
        - 1, every attention op appending K cache entries. Returns
        logits [N, K, V]."""
        return self._walk(tokens, lambda impl, w, x: self._attn_chunk(
            w, x, caches[impl.name], pos, self._info[impl.name]), pos)

    def decode_chunk_verify(self, tokens, pos, caches):
        """Feed K tokens per row through the cache in one pass and return
        each position's greedy token: (greedy [N, K] on the device,
        caches with the K entries appended at pos .. pos + K - 1, in
        place).

        The substrate of speculative verification (zoo/speculative.py):
        tokens[:, 0] is each row's last accepted token, tokens[:, 1:] a
        draft's proposals, and greedy[:, i] the model's prediction after
        tokens[:, :i + 1]. Entries appended past the accepted position
        are stale but never read: the position masks stop at each row's
        position and later appends overwrite them. Over ring caches K is
        at most RING_HEADROOM."""
        k = int(np.shape(tokens)[1])
        if not 1 <= k <= self._window:
            raise ValueError(f"chunk width must be in [1, {self._window}],"
                             f" got {k}")
        if self._has_ring and k > self.RING_HEADROOM:
            raise ValueError(
                f"verify chunks over ring-stored sliding caches are "
                f"limited to {self.RING_HEADROOM} tokens, got {k}")
        with self._mode():
            pos_t = torch.clamp(self._tensor(pos, torch.long),
                                max=self._window - 1)
            logits = self._chunk_fn(self._tensor(tokens, torch.float32),
                                    pos_t, caches)
            return torch.argmax(logits.float(), dim=-1), caches

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
        cap = self.sample_cap
        if (cap is not None and temperature > 0.0
                and not 0 < top_k <= cap and not self._trunc_warned):
            # a nucleus-only or wide top-k draw under a cap is truncated
            # to the top-cap candidates: warn once per decoder
            self._trunc_warned = True
            logging.getLogger(__name__).warning(
                "sample_cap=%d truncates this draw: top_k=%d is outside "
                "the exact regime 0 < top_k <= cap; further occurrences "
                "are not logged", cap, top_k)
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
