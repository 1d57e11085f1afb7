"""HuggingFace llama-family -> ir.Graph converter (the port's copy of
simpleinfer_tpu/frontends/hf_llama.py: the same graphs, byte for byte
through Graph.save. Where it differs: weights go to numpy through a cast
in torch (torch_export.numpy_f32), so a bf16 state dict converts;
falcon_graph_from_hf rejects a non-default rope_scaling, as
llama_graph_from_hf does, instead of ignoring it; and the graph is built
without drawing the builder's random weights, which the checkpoint's
replace (weightless_builder)).

Real-model import for the LLM serving path: takes an in-memory
`transformers` causal-LM (llama / qwen2 / mistral / gemma / phi3 /
stablelm (LayerNorm + partial rotary) —
the RMSNorm + RoPE + GQA + gated-MLP lineage; gemma's (1+w) RMSNorm
convention and sqrt(hidden) embedding scaling fold into the imported
weights, phi3's fused qkv/gate_up projections are split) and emits the
same graph shape as
zoo.build_llama, with the checkpoint's actual weights. The resulting
engine is a drop-in for greedy_generate / CachedDecoder /
GenerationService, and tests/test_torch_hf_import.py checks logits
parity against the HF forward — the independent-oracle discipline the repo
uses everywhere (tests/torch_ref.py, SURVEY.md §4.4).

The reference has no model importer at all (models arrive as pnnx
files, SURVEY.md §1.6); frontends/torch_export.py covers torch.fx
module export, and this module covers the HF transformer lineage whose
attention would otherwise be captured as an opaque python callable.
`neox_graph_from_hf` (round-5) extends the reach to the LayerNorm +
parallel-residual + partial-rotary lineage (phi-2, GPT-NeoX/Pythia,
stablelm-class), and `bloom_graph_from_hf` to the ALiBi lineage
(BLOOM: no position embeddings, per-head linear key-position logit
bias — ops/attention.alibi_slopes).
"""
from __future__ import annotations

import numpy as np

from ..ir.graph import Attribute, Parameter
from ..zoo.builders import GraphBuilder
from .torch_export import numpy_f32


class _NoDraws:
    """A GraphBuilder `rng` that draws nothing. The HF converters build
    through GraphBuilder, which draws a seeded random weight for every
    op, and then put the checkpoint's weight in its place: zeros in place
    of the draws give the same graph (tests/test_torch_hf_import.py holds
    the bytes to the JAX converters') without the draws, most of a large
    model's conversion time."""

    @staticmethod
    def standard_normal(shape):
        return np.zeros(shape)

    @staticmethod
    def uniform(low, high, size):
        return np.zeros(size)


def weightless_builder() -> GraphBuilder:
    """A GraphBuilder for a converter that sets every weight itself."""
    b = GraphBuilder()
    b.rng = _NoDraws()
    return b


_SUPPORTED = ("llama", "qwen2", "mistral", "gemma", "phi3", "qwen3",
              "gemma2", "stablelm")


def llama_graph_from_hf(model, batch: int = 1,
                        seq_len: int | None = None) -> tuple:
    """Convert a transformers LlamaForCausalLM-style model.

    Returns (graph, input_name, output_name): token ids [batch,
    seq_len] -> logits [batch, seq_len, vocab]. seq_len defaults to
    config.max_position_embeddings (the compile-time window).
    """
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt not in _SUPPORTED:
        raise ValueError(f"unsupported model_type {mt!r}; expected one "
                         f"of {_SUPPORTED} (RMSNorm+RoPE+SwiGLU lineage)")
    heads = cfg.num_attention_heads
    kv = getattr(cfg, "num_key_value_heads", heads) or heads
    e = cfg.hidden_size
    d = getattr(cfg, "head_dim", None) or e // heads
    # qwen3 decouples head_dim from hidden/heads (si.RotaryAttention
    # takes an explicit head_dim param); other families must still
    # satisfy the classic geometry
    decoupled = d * heads != e
    if decoupled and mt not in ("qwen3", "gemma2"):
        raise ValueError(f"head_dim {d} * heads {heads} != hidden {e} "
                         f"(unsupported projection geometry for {mt})")
    seq_len = int(seq_len or cfg.max_position_embeddings)
    theta = float(getattr(cfg, "rope_theta", 10000.0))
    # stablelm: llama wiring but LayerNorm (w+b) and PARTIAL rotary
    layer_norms = mt == "stablelm"
    if layer_norms:
        if getattr(cfg, "qk_layernorm", False):
            raise ValueError("stablelm qk_layernorm=True not supported")
        if getattr(cfg, "use_parallel_residual", False):
            raise ValueError("stablelm use_parallel_residual=True: use "
                             "neox_graph_from_hf-style wiring (not "
                             "supported here)")
    eps = float(getattr(cfg, "layer_norm_eps", 1e-5) if layer_norms
                else getattr(cfg, "rms_norm_eps", 1e-6))
    rot_pct = float(getattr(cfg, "partial_rotary_factor", 1.0) or 1.0)
    rot_dim = (max(2, int(d * rot_pct) // 2 * 2)
               if rot_pct < 1.0 else None)
    scaling = getattr(cfg, "rope_scaling", None)
    if scaling and scaling.get("rope_type", scaling.get("type")) not in (
            None, "default"):
        raise ValueError(f"rope_scaling {scaling!r} not supported")

    # sliding-window attention, per HF family semantics: mistral/phi3
    # apply cfg.sliding_window whenever set; qwen2 only when
    # use_sliding_window=True and then only to layers >=
    # max_window_layers (the lower layers stay full attention);
    # llama/gemma(v1) have none. HF's mask keeps q - sw < k <= q —
    # exactly si.RotaryAttention's band.
    # gemma2: attention scale from query_pre_attn_scalar, tanh
    # softcapping of attention logits and final logits
    attn_scale = None
    attn_softcap = None
    final_softcap = None
    if mt == "gemma2":
        qpas = getattr(cfg, "query_pre_attn_scalar", None)
        if qpas:
            attn_scale = float(qpas) ** -0.5
        attn_softcap = getattr(cfg, "attn_logit_softcapping", None)
        final_softcap = getattr(cfg, "final_logit_softcapping", None)

    sw_cfg = getattr(cfg, "sliding_window", None)
    use_sw = sw_cfg is not None and mt in ("mistral", "phi3", "qwen2",
                                           "qwen3", "gemma2")
    if mt in ("qwen2", "qwen3"):
        use_sw = use_sw and bool(getattr(cfg, "use_sliding_window",
                                         False))

    def layer_sliding(i):
        if not use_sw:
            return None
        if mt in ("qwen2", "qwen3"):
            mwl = int(getattr(cfg, "max_window_layers", 0) or 0)
            return int(sw_cfg) if i >= mwl else None
        if mt == "gemma2":
            # alternating layers; read the EFFECTIVE per-layer window
            # off the HF module itself (robust to HF convention
            # changes), falling back to the even-layer rule
            try:
                lsw = getattr(model.model.layers[i].self_attn,
                              "sliding_window", "__missing__")
                if lsw != "__missing__":
                    return int(lsw) if lsw else None
            except (AttributeError, IndexError):
                pass
            return int(sw_cfg) if i % 2 == 0 else None
        return int(sw_cfg)

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}

    if mt in ("gemma", "gemma2"):
        # gemma RMSNorm computes x_hat * (1 + w): fold into the weight
        for k in list(sd):
            if k.endswith("layernorm.weight") or k == "model.norm.weight":
                sd[k] = sd[k] + 1.0
        # gemma scales embeddings by sqrt(hidden); the tied lm_head uses
        # the UNSCALED matrix, so keep it under a separate key
        sd["__lm_head__"] = sd.get("lm_head.weight",
                                   sd["model.embed_tokens.weight"])
        sd["model.embed_tokens.weight"] = (
            sd["model.embed_tokens.weight"] * np.float32(np.sqrt(e)))
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        qkv = sd.pop(f"{p}.self_attn.qkv_proj.weight", None)
        if qkv is not None:  # phi3 fused projections: split q/k/v rows
            q_rows = heads * d
            kv_rows = kv * d
            sd[f"{p}.self_attn.q_proj.weight"] = qkv[:q_rows]
            sd[f"{p}.self_attn.k_proj.weight"] = qkv[q_rows:q_rows + kv_rows]
            sd[f"{p}.self_attn.v_proj.weight"] = qkv[q_rows + kv_rows:]
        gu = sd.pop(f"{p}.mlp.gate_up_proj.weight", None)
        if gu is not None:   # phi3 fused gate/up
            sd[f"{p}.mlp.gate_proj.weight"] = gu[:cfg.intermediate_size]
            sd[f"{p}.mlp.up_proj.weight"] = gu[cfg.intermediate_size:]

    # gated-MLP activation: silu (llama lineage) or tanh-gelu (gemma).
    # GemmaMLP reads cfg.hidden_activation and IGNORES hidden_act
    # (original gemma checkpoints carry the legacy hidden_act="gelu"
    # that HF deliberately overrides to tanh-gelu) — match that
    # precedence exactly, or such checkpoints silently get erf-gelu.
    if mt in ("gemma", "gemma2"):
        hidden_act = (getattr(cfg, "hidden_activation", None)
                      or "gelu_pytorch_tanh")
    else:
        hidden_act = getattr(cfg, "hidden_act", None) or "silu"
    if hidden_act in ("silu", "swish"):
        gated_act = "silu"
    elif hidden_act in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        gated_act = ("gelu_exact" if hidden_act == "gelu" else "gelu")
    else:
        raise ValueError(f"unsupported hidden_act {hidden_act!r}")

    def attr(b, op_out, key, array):
        # attach a weight attribute onto the op that PRODUCED op_out
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def mknorm(b, x, wkey):
        # one helper for every pre/post norm site: rms (llama lineage)
        # or affine LayerNorm with bias (stablelm)
        y = b.layer_norm(x) if layer_norms else b.rms_norm(x)
        op = b.g.get_operand(y).producer
        op.attrs["weight"] = Attribute.from_array(sd[wkey + ".weight"])
        if layer_norms:
            op.attrs["bias"] = Attribute.from_array(sd[wkey + ".bias"])
        op.params["eps"] = Parameter.from_value(eps)
        return y

    b = weightless_builder()
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd["model.embed_tokens.weight"])

    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        y = mknorm(b, x, f"{p}.input_layernorm")

        bias = f"{p}.self_attn.q_proj.bias" in sd  # qwen2-style
        y = b.rotary_attention(y, heads, num_kv_heads=kv,
                               rope_theta=theta, bias=bias,
                               sliding_window=layer_sliding(i),
                               head_dim=d if decoupled else None,
                               attn_scale=attn_scale,
                               logit_softcap=attn_softcap,
                               rotary_dim=rot_dim)
        aop = b.g.get_operand(y).producer
        for key in ("q", "k", "v", "o"):
            aop.attrs[f"{key}_proj.weight"] = Attribute.from_array(
                np.ascontiguousarray(sd[f"{p}.self_attn.{key}_proj"
                                        f".weight"]))
            bkey = f"{p}.self_attn.{key}_proj.bias"
            if bkey in sd:
                aop.attrs[f"{key}_proj.bias"] = Attribute.from_array(
                    sd[bkey])
        # qwen3 per-head q/k RMSNorm (eps = rms_norm_eps, HF
        # Qwen3Attention.q_norm/k_norm)
        for nk, ak in ((f"{p}.self_attn.q_norm.weight",
                        "q_norm.weight"),
                       (f"{p}.self_attn.k_norm.weight",
                        "k_norm.weight")):
            if nk in sd:
                aop.attrs[ak] = Attribute.from_array(sd[nk])
                aop.params["qk_norm_eps"] = Parameter.from_value(eps)
        if mt == "gemma2":
            # gemma2 normalizes the attention OUTPUT before the
            # residual add (post_attention_layernorm here is the
            # sandwich norm, NOT llama's pre-MLP norm)
            y = b.rms_norm(y)
            attr(b, y, "weight",
                 sd[f"{p}.post_attention_layernorm.weight"])
            b.g.get_operand(y).producer.params["eps"] = \
                Parameter.from_value(eps)
        x = b.add(x, y)

        y = mknorm(b, x, f"{p}.pre_feedforward_layernorm"
                   if mt == "gemma2"
                   else f"{p}.post_attention_layernorm")
        gate = b.linear(y, cfg.intermediate_size, bias=False)
        attr(b, gate, "weight", sd[f"{p}.mlp.gate_proj.weight"])
        if gated_act == "silu":
            gate = b.silu_act(gate)
        else:
            gate = b.gelu(gate)
            if gated_act == "gelu":  # tanh approximation (HF *_tanh/new)
                b.g.get_operand(gate).producer.params["approximate"] = \
                    Parameter.from_value("tanh")
        up = b.linear(y, cfg.intermediate_size, bias=False)
        attr(b, up, "weight", sd[f"{p}.mlp.up_proj.weight"])
        y = b.mul(gate, up)
        y = b.linear(y, e, bias=False)
        attr(b, y, "weight", sd[f"{p}.mlp.down_proj.weight"])
        if mt == "gemma2":
            y = b.rms_norm(y)
            attr(b, y, "weight",
                 sd[f"{p}.post_feedforward_layernorm.weight"])
            b.g.get_operand(y).producer.params["eps"] = \
                Parameter.from_value(eps)
        x = b.add(x, y)

    x = mknorm(b, x, "model.norm")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    head = ("__lm_head__" if "__lm_head__" in sd  # gemma: pre-scaling tie
            else "lm_head.weight" if "lm_head.weight" in sd
            else "model.embed_tokens.weight")  # tied embeddings
    attr(b, logits, "weight", sd[head])
    if final_softcap:
        # logits' = tanh(logits / c) * c via graph ops (BinaryOp
        # broadcast against scalar constants; pointwise in the decode
        # plan, so KV-cache decode gets it for free). Direct BinaryOp
        # nodes, NOT b.mul's pnnx.Expression — the expansion pass
        # renames the output operand, which would break the returned
        # output_name contract.
        inv = b.attr_const(np.asarray([1.0 / final_softcap],
                                      np.float32))
        capc = b.attr_const(np.asarray([float(final_softcap)],
                                       np.float32))

        def bmul(a_op, b_op):
            (out,) = b._op("BinaryOp", b._name("softcap_mul"),
                           [a_op, b_op], params={"0": 2})  # ncnn mul
            b.shape[out] = list(b.shape[a_op])
            return out

        logits = bmul(b.tanh(bmul(logits, inv)), capc)
    b.output(logits)
    return b.build(), "0", logits


_SUPPORTED_NEOX = ("phi", "gpt_neox", "gptj")


def neox_graph_from_hf(model, batch: int = 1,
                       seq_len: int | None = None) -> tuple:
    """Convert a transformers PhiForCausalLM / GPTNeoXForCausalLM
    (Pythia) model — the LayerNorm + PARALLEL-residual + partial-rotary
    + GELU-MLP lineage `llama_graph_from_hf` cannot express:

        x + attn(ln1(x)) + mlp(ln2(x))        (neox; phi shares ln1)

    GPT-NeoX's fused query_key_value projection stores per-head
    [q(d), k(d), v(d)] row blocks (GPTNeoXAttention's view(heads, 3*d)
    split) and is de-interleaved here; rotary_pct /
    partial_rotary_factor flows to si.RotaryAttention's rotary_dim.
    use_parallel_residual=False (some Pythia sizes) takes the
    sequential wiring. Returns (graph, input_name, output_name);
    drop-in for greedy_generate / CachedDecoder / GenerationService.
    """
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt not in _SUPPORTED_NEOX:
        raise ValueError(f"unsupported model_type {mt!r}; expected one "
                         f"of {_SUPPORTED_NEOX} (LayerNorm + parallel "
                         f"residual lineage — llama-family goes through "
                         f"llama_graph_from_hf)")
    if mt == "phi" and getattr(cfg, "qk_layernorm", False):
        raise ValueError("phi qk_layernorm=True not supported")
    heads = cfg.num_attention_heads
    kv = getattr(cfg, "num_key_value_heads", heads) or heads
    e = cfg.hidden_size
    if e % heads:
        raise ValueError(f"hidden {e} not divisible by heads {heads}")
    d = e // heads
    if mt == "gptj":        # absolute rotary_dim, not a fraction
        rot = int(getattr(cfg, "rotary_dim", None) or d)
    else:
        pct = float(getattr(cfg, "partial_rotary_factor", None)
                    or getattr(cfg, "rotary_pct", None) or 1.0)
        rot = max(2, int(d * pct) // 2 * 2)
    theta = float(getattr(cfg, "rope_theta", None)
                  or getattr(cfg, "rotary_emb_base", None) or 10000.0)
    eps = float(getattr(cfg, "layer_norm_eps", None)
                or getattr(cfg, "layer_norm_epsilon", None)
                or 1e-5)
    seq_len = int(seq_len or cfg.max_position_embeddings)
    parallel = (bool(getattr(cfg, "use_parallel_residual", True))
                if mt == "gpt_neox" else True)
    inter = (4 * e if mt == "gptj" and cfg.n_inner is None
             else (cfg.n_inner if mt == "gptj"
                   else cfg.intermediate_size))
    act = (cfg.activation_function if mt == "gptj"
           else getattr(cfg, "hidden_act", "gelu_new" if mt == "phi"
                        else "gelu"))
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_fast"):
        raise ValueError(f"unsupported hidden_act {act!r}")
    tanh_gelu = act != "gelu"

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}

    if mt == "phi":
        emb_key = "model.embed_tokens.weight"
        pre = "model.layers.{}."
        attn_out = "self_attn.dense"
        fc1, fc2 = "mlp.fc1", "mlp.fc2"
        final_ln = "model.final_layernorm"
        head_key, head_bias_key = "lm_head.weight", "lm_head.bias"
    elif mt == "gptj":
        emb_key = "transformer.wte.weight"
        pre = "transformer.h.{}."
        attn_out = "attn.out_proj"
        fc1, fc2 = "mlp.fc_in", "mlp.fc_out"
        final_ln = "transformer.ln_f"
        head_key, head_bias_key = "lm_head.weight", "lm_head.bias"
        for i in range(cfg.num_hidden_layers):   # bias-free separate
            pp = pre.format(i)                   # q/k/v under attn.
            for nm in ("q", "k", "v"):
                sd[f"{pp}self_attn.{nm}_proj.weight"] = \
                    sd.pop(f"{pp}attn.{nm}_proj.weight")
        # GPT-J blocks use ONE LayerNorm (ln_1) for both branches and
        # name it ln_1, not input_layernorm
        for i in range(cfg.num_hidden_layers):
            pp = pre.format(i)
            sd[f"{pp}input_layernorm.weight"] = sd.pop(
                f"{pp}ln_1.weight")
            sd[f"{pp}input_layernorm.bias"] = sd.pop(f"{pp}ln_1.bias")
    else:
        emb_key = "gpt_neox.embed_in.weight"
        pre = "gpt_neox.layers.{}."
        attn_out = "attention.dense"
        fc1, fc2 = "mlp.dense_h_to_4h", "mlp.dense_4h_to_h"
        final_ln = "gpt_neox.final_layer_norm"
        head_key, head_bias_key = "embed_out.weight", "embed_out.bias"
        # de-interleave the fused qkv: rows are per-head [q, k, v]
        for i in range(cfg.num_hidden_layers):
            p = pre.format(i)
            w = sd.pop(f"{p}attention.query_key_value.weight")
            bq = sd.pop(f"{p}attention.query_key_value.bias", None)
            w = w.reshape(heads, 3, d, e)
            for j, name in enumerate(("q", "k", "v")):
                sd[f"{p}self_attn.{name}_proj.weight"] = \
                    np.ascontiguousarray(w[:, j].reshape(heads * d, e))
                if bq is not None:
                    sd[f"{p}self_attn.{name}_proj.bias"] = \
                        np.ascontiguousarray(
                            bq.reshape(heads, 3, d)[:, j].reshape(-1))

    def attr(b, op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def ln(b, x, wkey):
        y = b.layer_norm(x)
        op = b.g.get_operand(y).producer
        op.attrs["weight"] = Attribute.from_array(sd[wkey + ".weight"])
        op.attrs["bias"] = Attribute.from_array(sd[wkey + ".bias"])
        op.params["eps"] = Parameter.from_value(eps)
        return y

    b = weightless_builder()
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd[emb_key])

    for i in range(cfg.num_hidden_layers):
        p = pre.format(i)
        qp = f"{p}self_attn."      # neox keys were normalized above
        ln1 = ln(b, x, f"{p}input_layernorm")
        attn = b.rotary_attention(ln1, heads, num_kv_heads=kv,
                                  rope_theta=theta,
                                  bias=f"{qp}q_proj.bias" in sd,
                                  rotary_dim=rot,
                                  rope_interleaved=(mt == "gptj"))
        aop = b.g.get_operand(attn).producer
        for key in ("q", "k", "v"):
            aop.attrs[f"{key}_proj.weight"] = Attribute.from_array(
                np.ascontiguousarray(sd[f"{qp}{key}_proj.weight"]))
            bkey = f"{qp}{key}_proj.bias"
            if bkey in sd:
                aop.attrs[f"{key}_proj.bias"] = Attribute.from_array(
                    sd[bkey])
        aop.attrs["o_proj.weight"] = Attribute.from_array(
            np.ascontiguousarray(sd[f"{p}{attn_out}.weight"]))
        if f"{p}{attn_out}.bias" in sd:
            aop.attrs["o_proj.bias"] = Attribute.from_array(
                sd[f"{p}{attn_out}.bias"])

        def mlp_from(src):
            h = b.linear(src, inter, bias=True)
            attr(b, h, "weight", sd[f"{p}{fc1}.weight"])
            attr(b, h, "bias", sd[f"{p}{fc1}.bias"])
            h = b.gelu(h)
            if tanh_gelu:
                b.g.get_operand(h).producer.params["approximate"] = \
                    Parameter.from_value("tanh")
            h = b.linear(h, e, bias=True)
            attr(b, h, "weight", sd[f"{p}{fc2}.weight"])
            attr(b, h, "bias", sd[f"{p}{fc2}.bias"])
            return h

        if parallel:
            ln2 = (ln1 if mt in ("phi", "gptj")
                   else ln(b, x, f"{p}post_attention_layernorm"))
            x = b.add(b.add(x, attn), mlp_from(ln2))
        else:
            x = b.add(x, attn)
            ln2 = ln(b, x, f"{p}post_attention_layernorm")
            x = b.add(x, mlp_from(ln2))

    x = ln(b, x, final_ln)
    logits = b.linear(x, cfg.vocab_size,
                      bias=head_bias_key in sd)
    attr(b, logits, "weight", sd.get(head_key, sd[emb_key]))
    if head_bias_key in sd:
        attr(b, logits, "bias", sd[head_bias_key])
    b.output(logits)
    return b.build(), "0", logits


def bloom_graph_from_hf(model, batch: int = 1,
                        seq_len: int = 64) -> tuple:
    """Convert a transformers BloomForCausalLM — the ALiBi lineage:
    no position embeddings at all; si.RotaryAttention's alibi=1 adds
    the per-head slopes[h] * key_position logit bias instead
    (ops/attention.alibi_slopes == transformers build_alibi_tensor).

    BloomAttention's fused query_key_value stores per-head [q, k, v]
    row blocks (its _split_heads view(heads, 3, d) — the same
    interleave GPT-NeoX uses) and is de-interleaved here; the
    embedding LayerNorm (word_embeddings_layernorm) and tanh-GELU MLP
    map to existing ops. seq_len must be given (ALiBi has no
    max_position_embeddings). Returns (graph, input_name,
    output_name); drop-in for greedy_generate / CachedDecoder /
    GenerationService.
    """
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt != "bloom":
        raise ValueError(f"unsupported model_type {mt!r}; expected "
                         f"'bloom' (the ALiBi lineage)")
    heads = cfg.n_head
    e = cfg.hidden_size
    if e % heads:
        raise ValueError(f"hidden {e} not divisible by heads {heads}")
    d = e // heads
    eps = float(getattr(cfg, "layer_norm_epsilon", 1e-5))

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}
    pre = "transformer.h.{}."
    for i in range(cfg.n_layer):        # de-interleave fused qkv
        p = pre.format(i)
        w = sd.pop(f"{p}self_attention.query_key_value.weight")
        bq = sd.pop(f"{p}self_attention.query_key_value.bias", None)
        w = w.reshape(heads, 3, d, e)
        for j, name in enumerate(("q", "k", "v")):
            sd[f"{p}{name}_proj.weight"] = \
                np.ascontiguousarray(w[:, j].reshape(heads * d, e))
            if bq is not None:
                sd[f"{p}{name}_proj.bias"] = np.ascontiguousarray(
                    bq.reshape(heads, 3, d)[:, j].reshape(-1))

    def attr(b, op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def ln(b, x, wkey):
        y = b.layer_norm(x)
        op = b.g.get_operand(y).producer
        op.attrs["weight"] = Attribute.from_array(sd[wkey + ".weight"])
        op.attrs["bias"] = Attribute.from_array(sd[wkey + ".bias"])
        op.params["eps"] = Parameter.from_value(eps)
        return y

    b = weightless_builder()
    ids = b.input([batch, int(seq_len)], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd["transformer.word_embeddings.weight"])
    x = ln(b, x, "transformer.word_embeddings_layernorm")

    for i in range(cfg.n_layer):
        p = pre.format(i)
        y = ln(b, x, f"{p}input_layernorm")
        attn = b.rotary_attention(y, heads, bias=True, o_bias=True,
                                  alibi=True)
        aop = b.g.get_operand(attn).producer
        for key in ("q", "k", "v"):
            aop.attrs[f"{key}_proj.weight"] = Attribute.from_array(
                sd[f"{p}{key}_proj.weight"])
            bkey = f"{p}{key}_proj.bias"
            if bkey in sd:
                aop.attrs[f"{key}_proj.bias"] = Attribute.from_array(
                    sd[bkey])
        aop.attrs["o_proj.weight"] = Attribute.from_array(
            np.ascontiguousarray(sd[f"{p}self_attention.dense.weight"]))
        aop.attrs["o_proj.bias"] = Attribute.from_array(
            sd[f"{p}self_attention.dense.bias"])

        y = ln(b, x := b.add(x, attn), f"{p}post_attention_layernorm")
        h = b.linear(y, 4 * e, bias=True)
        attr(b, h, "weight", sd[f"{p}mlp.dense_h_to_4h.weight"])
        attr(b, h, "bias", sd[f"{p}mlp.dense_h_to_4h.bias"])
        h = b.gelu(h, approximate="tanh")   # BloomGelu == tanh GELU
        h = b.linear(h, e, bias=True)
        attr(b, h, "weight", sd[f"{p}mlp.dense_4h_to_h.weight"])
        attr(b, h, "bias", sd[f"{p}mlp.dense_4h_to_h.bias"])
        x = b.add(x, h)

    x = ln(b, x, "transformer.ln_f")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    attr(b, logits, "weight",
         sd.get("lm_head.weight",
                sd["transformer.word_embeddings.weight"]))
    b.output(logits)
    return b.build(), "0", logits


def falcon_graph_from_hf(model, batch: int = 1,
                         seq_len: int | None = None) -> tuple:
    """Convert a transformers FalconForCausalLM — all three block
    wirings the family shipped:

      new_decoder_architecture (40B/180B class):
          x + attn(ln_attn(x)) + mlp(ln_mlp(x)), GQA (num_kv_heads)
      old + parallel_attn (7B class):
          x + attn(ln(x)) + mlp(ln(x)), MQA (multi_query -> 1 kv head)
      old + parallel_attn=False (falcon-rw class):
          sequential pre-LN blocks, optionally ALiBi positions

    FalconAttention's fused query_key_value layout differs per arch
    (its _split_heads): grouped [kv, group q.. k v, d] rows for the
    new arch, contiguous [all-q, k, v] for multi_query, per-head
    [q, k, v] interleave otherwise — each de-fused here. cfg.alibi
    maps to si.RotaryAttention alibi=1 (rotary off), cfg.bias to the
    q/k/v/o biases. Returns (graph, input_name, output_name).
    """
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt != "falcon":
        raise ValueError(f"unsupported model_type {mt!r}; expected "
                         f"'falcon'")
    heads = cfg.num_attention_heads
    e = cfg.hidden_size
    if e % heads:
        raise ValueError(f"hidden {e} not divisible by heads {heads}")
    d = e // heads
    new_arch = bool(cfg.new_decoder_architecture)
    if new_arch:
        kv = int(getattr(cfg, "num_kv_heads", None) or heads)
    else:
        kv = 1 if cfg.multi_query else heads
    alibi = bool(cfg.alibi)
    parallel = bool(cfg.parallel_attn) or new_arch
    if alibi and parallel:
        raise ValueError("falcon alibi + parallel_attn not shipped by "
                         "any checkpoint; unsupported")
    theta = float(getattr(cfg, "rope_theta", None) or 10000.0)
    scaling = getattr(cfg, "rope_scaling", None)
    if scaling and scaling.get("rope_type", scaling.get("type")) not in (
            None, "default"):
        raise ValueError(f"rope_scaling {scaling!r} not supported")
    eps = float(getattr(cfg, "layer_norm_epsilon", 1e-5))
    seq_len = int(seq_len or 64)

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}
    pre = "transformer.h.{}."
    for i in range(cfg.num_hidden_layers):      # de-fuse qkv
        p = pre.format(i)
        w = sd.pop(f"{p}self_attention.query_key_value.weight")
        bq = sd.pop(f"{p}self_attention.query_key_value.bias", None)
        if new_arch:        # [kv, group+2, d, e]: q block then k, v
            g = heads // kv
            w = w.reshape(kv, g + 2, d, e)
            qw = w[:, :g].reshape(heads * d, e)
            kw, vw = w[:, g].reshape(kv * d, e), w[:, g + 1].reshape(
                kv * d, e)
            if bq is not None:
                bq = bq.reshape(kv, g + 2, d)
                bs = (bq[:, :g].reshape(-1), bq[:, g].reshape(-1),
                      bq[:, g + 1].reshape(-1))
        elif cfg.multi_query:   # contiguous [heads*d | d | d]
            qw, kw, vw = (w[:heads * d], w[heads * d:heads * d + d],
                          w[heads * d + d:])
            if bq is not None:
                bs = (bq[:heads * d], bq[heads * d:heads * d + d],
                      bq[heads * d + d:])
        else:                   # per-head [q, k, v] interleave
            w = w.reshape(heads, 3, d, e)
            qw, kw, vw = (w[:, 0].reshape(heads * d, e),
                          w[:, 1].reshape(heads * d, e),
                          w[:, 2].reshape(heads * d, e))
            if bq is not None:
                bq = bq.reshape(heads, 3, d)
                bs = (bq[:, 0].reshape(-1), bq[:, 1].reshape(-1),
                      bq[:, 2].reshape(-1))
        for name, arr in (("q", qw), ("k", kw), ("v", vw)):
            sd[f"{p}{name}_proj.weight"] = np.ascontiguousarray(arr)
        if bq is not None:
            for name, arr in zip(("q", "k", "v"), bs):
                sd[f"{p}{name}_proj.bias"] = np.ascontiguousarray(arr)

    def attr(b, op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def ln(b, x, wkey):
        y = b.layer_norm(x)
        op = b.g.get_operand(y).producer
        op.attrs["weight"] = Attribute.from_array(sd[wkey + ".weight"])
        op.attrs["bias"] = Attribute.from_array(sd[wkey + ".bias"])
        op.params["eps"] = Parameter.from_value(eps)
        return y

    b = weightless_builder()
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd["transformer.word_embeddings.weight"])

    has_bias = any(f"{pre.format(0)}{k}_proj.bias" in sd
                   for k in ("q", "k", "v"))
    for i in range(cfg.num_hidden_layers):
        p = pre.format(i)

        def fill_attn(src):
            a = b.rotary_attention(
                src, heads, num_kv_heads=kv, rope_theta=theta,
                bias=has_bias,
                o_bias=f"{p}self_attention.dense.bias" in sd,
                alibi=alibi,
                # falcon-rw semantics: (scores + alibi) scaled
                # together, so the bias carries 1/sqrt(d) (original RW
                # code and transformers' sdpa path; HF's eager falcon
                # path double-adds alibi — a known-divergent path we
                # deliberately don't match)
                alibi_scale=(d ** -0.5 if alibi else None))
            aop = b.g.get_operand(a).producer
            for key in ("q", "k", "v"):
                aop.attrs[f"{key}_proj.weight"] = Attribute.from_array(
                    sd[f"{p}{key}_proj.weight"])
                bkey = f"{p}{key}_proj.bias"
                if bkey in sd:
                    aop.attrs[f"{key}_proj.bias"] = \
                        Attribute.from_array(sd[bkey])
            aop.attrs["o_proj.weight"] = Attribute.from_array(
                np.ascontiguousarray(
                    sd[f"{p}self_attention.dense.weight"]))
            if f"{p}self_attention.dense.bias" in sd:
                aop.attrs["o_proj.bias"] = Attribute.from_array(
                    sd[f"{p}self_attention.dense.bias"])
            return a

        def mlp_from(src):
            h = b.linear(src, sd[f"{p}mlp.dense_h_to_4h.weight"]
                         .shape[0],
                         bias=f"{p}mlp.dense_h_to_4h.bias" in sd)
            attr(b, h, "weight", sd[f"{p}mlp.dense_h_to_4h.weight"])
            if f"{p}mlp.dense_h_to_4h.bias" in sd:
                attr(b, h, "bias", sd[f"{p}mlp.dense_h_to_4h.bias"])
            h = b.gelu(h)       # falcon hidden act: exact gelu
            h = b.linear(h, e,
                         bias=f"{p}mlp.dense_4h_to_h.bias" in sd)
            attr(b, h, "weight", sd[f"{p}mlp.dense_4h_to_h.weight"])
            if f"{p}mlp.dense_4h_to_h.bias" in sd:
                attr(b, h, "bias", sd[f"{p}mlp.dense_4h_to_h.bias"])
            return h

        if parallel:
            if new_arch and f"{p}ln_attn.weight" in sd:
                ln1 = ln(b, x, f"{p}ln_attn")
                ln2 = ln(b, x, f"{p}ln_mlp")
            else:               # 7B class: one shared ln
                ln1 = ln2 = ln(b, x, f"{p}input_layernorm")
            x = b.add(b.add(x, fill_attn(ln1)), mlp_from(ln2))
        else:                   # falcon-rw sequential wiring
            x = b.add(x, fill_attn(ln(b, x, f"{p}input_layernorm")))
            x = b.add(x, mlp_from(
                ln(b, x, f"{p}post_attention_layernorm")))

    x = ln(b, x, "transformer.ln_f")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    attr(b, logits, "weight",
         sd.get("lm_head.weight",
                sd["transformer.word_embeddings.weight"]))
    b.output(logits)
    return b.build(), "0", logits


def mpt_slopes(num_heads: int, alibi_bias_max: float = 8.0):
    """MPT's ALiBi slope ladder (transformers build_mpt_alibi_tensor /
    mosaicml attention.py): the 2^ceil(log2(H)) ladder with odd-index-
    first selection for non-power-of-two H — a DIFFERENT interpolation
    than BLOOM's (ops/attention.alibi_slopes), hence shipped as the
    explicit alibi_slopes attr."""
    import math

    n = 2 ** math.ceil(math.log2(num_heads))
    base = np.arange(1, n + 1, dtype=np.float64) * (alibi_bias_max / n)
    slopes = (1.0 / np.power(2.0, base)).astype(np.float32)
    if n != num_heads:
        slopes = np.concatenate([slopes[1::2],
                                 slopes[0::2]])[:num_heads]
    return slopes


def mpt_graph_from_hf(model, batch: int = 1,
                      seq_len: int | None = None) -> tuple:
    """Convert a transformers MptForCausalLM — MosaicML's ALiBi
    lineage: bias-free Linears throughout (no_bias), weight-only
    LayerNorms (zero beta supplied), contiguous-thirds fused Wqkv
    split (MptAttention's chunk(3) — NOT the per-head interleave
    BLOOM/NeoX use), exact GELU MLP, and MPT's own slope ladder via
    the explicit alibi_slopes attr. Returns (graph, input_name,
    output_name); drop-in for greedy_generate / CachedDecoder /
    GenerationService.
    """
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt != "mpt":
        raise ValueError(f"unsupported model_type {mt!r}; expected "
                         f"'mpt'")
    if getattr(cfg.attn_config, "clip_qkv", None):
        raise ValueError("mpt clip_qkv not supported")
    heads = cfg.n_heads
    e = cfg.hidden_size
    if e % heads:
        raise ValueError(f"hidden {e} not divisible by heads {heads}")
    d = e // heads
    eps = float(getattr(cfg, "layer_norm_epsilon", 1e-5))
    seq_len = int(seq_len or cfg.max_seq_len)
    slopes = mpt_slopes(
        heads, float(getattr(cfg.attn_config, "alibi_bias_max", 8.0)))
    # MPT softmax_scale (default 1/sqrt(d)) scales ONLY the scores;
    # the bias is added unscaled (alibi_scale stays 1)
    if getattr(cfg.attn_config, "softmax_scale", None):
        raise ValueError("mpt custom softmax_scale not supported")

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}
    pre = "transformer.blocks.{}."
    for i in range(cfg.n_layers):   # contiguous-thirds Wqkv split
        p = pre.format(i)
        w = sd.pop(f"{p}attn.Wqkv.weight")
        for j, name in enumerate(("q", "k", "v")):
            sd[f"{p}{name}_proj.weight"] = \
                np.ascontiguousarray(w[j * e:(j + 1) * e])

    def attr(b, op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def ln(b, x, wkey):
        y = b.layer_norm(x)
        op = b.g.get_operand(y).producer
        w = sd[wkey + ".weight"]
        op.attrs["weight"] = Attribute.from_array(w)
        # no_bias checkpoints carry weight-only norms: zero beta
        op.attrs["bias"] = Attribute.from_array(
            sd.get(wkey + ".bias", np.zeros_like(w)))
        op.params["eps"] = Parameter.from_value(eps)
        return y

    b = weightless_builder()
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd["transformer.wte.weight"])

    for i in range(cfg.n_layers):
        p = pre.format(i)
        y = ln(b, x, f"{p}norm_1")
        a = b.rotary_attention(y, heads, alibi=True,
                               alibi_slopes=slopes)
        aop = b.g.get_operand(a).producer
        for key in ("q", "k", "v"):
            aop.attrs[f"{key}_proj.weight"] = Attribute.from_array(
                sd[f"{p}{key}_proj.weight"])
        aop.attrs["o_proj.weight"] = Attribute.from_array(
            np.ascontiguousarray(sd[f"{p}attn.out_proj.weight"]))
        x = b.add(x, a)
        y = ln(b, x, f"{p}norm_2")
        h = b.linear(y, sd[f"{p}ffn.up_proj.weight"].shape[0],
                     bias=False)
        attr(b, h, "weight", sd[f"{p}ffn.up_proj.weight"])
        h = b.gelu(h)               # MptMLP: exact GELU
        h = b.linear(h, e, bias=False)
        attr(b, h, "weight", sd[f"{p}ffn.down_proj.weight"])
        x = b.add(x, h)

    x = ln(b, x, "transformer.norm_f")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    attr(b, logits, "weight",
         sd.get("lm_head.weight", sd["transformer.wte.weight"]))
    b.output(logits)
    return b.build(), "0", logits


def opt_graph_from_hf(model, batch: int = 1,
                      seq_len: int | None = None) -> tuple:
    """Convert a transformers OPTForCausalLM — the learned-positions
    lineage (no rotary, no alibi): token embedding + learned position
    embedding (OPT's famous +2 offset baked in by slicing
    embed_positions[2:2+L]), pre-LN blocks of nn.MultiheadAttention
    (separate q/k/v packed into the op's in_proj layout) + ReLU MLP,
    final LayerNorm, tied head. The decode paths treat the position
    table as a window-spanning graph constant (_slice_seq), exactly
    like zoo.build_gpt. do_layer_norm_before=False (the post-LN 350m)
    and word_embed_proj_dim != hidden_size are rejected.
    Returns (graph, input_name, output_name)."""
    cfg = model.config
    mt = getattr(cfg, "model_type", None)
    if mt != "opt":
        raise ValueError(f"unsupported model_type {mt!r}; expected "
                         f"'opt'")
    if not getattr(cfg, "do_layer_norm_before", True):
        raise ValueError("opt do_layer_norm_before=False (350m-class "
                         "post-LN) not supported")
    e = cfg.hidden_size
    if getattr(cfg, "word_embed_proj_dim", e) != e:
        raise ValueError("opt word_embed_proj_dim != hidden_size not "
                         "supported")
    if getattr(cfg, "activation_function", "relu") != "relu":
        raise ValueError("opt non-relu activation not supported")
    heads = cfg.num_attention_heads
    seq_len = int(seq_len or 64)

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}
    pre = "model.decoder.layers.{}."

    def attr(b, op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def ln(b, x, wkey):
        y = b.layer_norm(x)
        op = b.g.get_operand(y).producer
        op.attrs["weight"] = Attribute.from_array(sd[wkey + ".weight"])
        op.attrs["bias"] = Attribute.from_array(sd[wkey + ".bias"])
        op.params["eps"] = Parameter.from_value(1e-5)
        return y

    b = weightless_builder()
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(b, x, "weight", sd["model.decoder.embed_tokens.weight"])
    # learned positions with the +2 offset baked in
    pos_tab = sd["model.decoder.embed_positions.weight"][
        2:2 + seq_len][None]
    x = b.add(x, b.attr_const(pos_tab))

    causal = np.triu(np.full((seq_len, seq_len), -1e9, np.float32), k=1)
    mask = b.attr_const(causal)

    for i in range(cfg.num_hidden_layers):
        p = pre.format(i)
        y = ln(b, x, f"{p}self_attn_layer_norm")
        a = b.mha(y, heads, mask=mask)
        aop = b.g.get_operand(a).producer
        aop.attrs["in_proj_weight"] = Attribute.from_array(
            np.ascontiguousarray(np.concatenate(
                [sd[f"{p}self_attn.{k}_proj.weight"]
                 for k in ("q", "k", "v")], axis=0)))
        aop.attrs["in_proj_bias"] = Attribute.from_array(
            np.concatenate([sd[f"{p}self_attn.{k}_proj.bias"]
                            for k in ("q", "k", "v")]))
        aop.attrs["out_proj.weight"] = Attribute.from_array(
            np.ascontiguousarray(sd[f"{p}self_attn.out_proj.weight"]))
        aop.attrs["out_proj.bias"] = Attribute.from_array(
            sd[f"{p}self_attn.out_proj.bias"])
        x = b.add(x, a)
        y = ln(b, x, f"{p}final_layer_norm")
        h = b.linear(y, cfg.ffn_dim, bias=True)
        attr(b, h, "weight", sd[f"{p}fc1.weight"])
        attr(b, h, "bias", sd[f"{p}fc1.bias"])
        h = b.relu(h)
        h = b.linear(h, e, bias=True)
        attr(b, h, "weight", sd[f"{p}fc2.weight"])
        attr(b, h, "bias", sd[f"{p}fc2.bias"])
        x = b.add(x, h)

    x = ln(b, x, "model.decoder.final_layer_norm")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    attr(b, logits, "weight",
         sd.get("lm_head.weight",
                sd["model.decoder.embed_tokens.weight"]))
    b.output(logits)
    return b.build(), "0", logits
