"""HuggingFace GPT-2 -> ir.Graph converter (the port's copy of
simpleinfer_tpu/frontends/hf_gpt2.py: the same graph, byte for byte
through Graph.save; weights go to numpy through a cast in torch, so a
bf16 state dict converts, and the builder draws no random weights).

The non-RoPE half of the real-architecture import surface
(frontends/hf_llama.py covers the RMSNorm+RoPE lineage): takes an
in-memory `transformers` GPT2LMHeadModel and emits the same graph shape
as zoo.build_gpt — learned position embeddings, pre-LN blocks,
nn.MultiheadAttention with an additive causal mask operand, tanh-gelu
MLP — with the checkpoint's actual weights. GPT-2's Conv1D modules
store weights [in, out] (transposed vs nn.Linear); they are transposed
at import. Logits parity vs the transformers forward is tested in
tests/test_torch_hf_import.py (the independent-oracle discipline).
"""
from __future__ import annotations

import numpy as np

from ..ir.graph import Attribute, Parameter
from .hf_llama import weightless_builder
from .torch_export import numpy_f32


def gpt2_graph_from_hf(model, batch: int = 1,
                       seq_len: int | None = None) -> tuple:
    """Convert a transformers GPT2LMHeadModel.

    Returns (graph, input_name, output_name): token ids [batch,
    seq_len] -> logits [batch, seq_len, vocab]. seq_len defaults to
    config.n_positions (the compile-time window)."""
    cfg = model.config
    if getattr(cfg, "model_type", None) != "gpt2":
        raise ValueError(f"expected model_type 'gpt2', got "
                         f"{getattr(cfg, 'model_type', None)!r}")
    e, heads = cfg.n_embd, cfg.n_head
    seq_len = int(seq_len or cfg.n_positions)
    if seq_len > cfg.n_positions:
        raise ValueError(f"seq_len {seq_len} exceeds the checkpoint's "
                         f"learned positions {cfg.n_positions}")
    eps = float(cfg.layer_norm_epsilon)
    act = getattr(cfg, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh", "gelu"):
        raise ValueError(f"unsupported activation {act!r}")

    sd = {k: numpy_f32(v) for k, v in model.state_dict().items()}

    b = weightless_builder()

    def attr(op_out, key, array):
        op = b.g.get_operand(op_out).producer
        op.attrs[key] = Attribute.from_array(np.ascontiguousarray(array))

    def set_param(op_out, key, value):
        b.g.get_operand(op_out).producer.params[key] = \
            Parameter.from_value(value)

    def ln(x, prefix):
        y = b.layer_norm(x)
        attr(y, "weight", sd[f"{prefix}.weight"])
        attr(y, "bias", sd[f"{prefix}.bias"])
        set_param(y, "eps", eps)
        return y

    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, cfg.vocab_size, e)
    attr(x, "weight", sd["transformer.wte.weight"])
    pos = b.attr_const(sd["transformer.wpe.weight"][None, :seq_len])
    x = b.add(x, pos)

    causal = np.triu(np.full((seq_len, seq_len), -1e9, np.float32), k=1)
    mask = b.attr_const(causal)

    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        y = ln(x, f"{p}.ln_1")
        y = b.mha(y, heads, mask=mask)
        # GPT-2 Conv1D weights are [in, out]; torch MHA wants [out, in]
        attr(y, "in_proj_weight", sd[f"{p}.attn.c_attn.weight"].T)
        attr(y, "in_proj_bias", sd[f"{p}.attn.c_attn.bias"])
        attr(y, "out_proj.weight", sd[f"{p}.attn.c_proj.weight"].T)
        attr(y, "out_proj.bias", sd[f"{p}.attn.c_proj.bias"])
        x = b.add(x, y)

        y = ln(x, f"{p}.ln_2")
        y = b.linear(y, cfg.n_inner or 4 * e)
        attr(y, "weight", sd[f"{p}.mlp.c_fc.weight"].T)
        attr(y, "bias", sd[f"{p}.mlp.c_fc.bias"])
        y = b.gelu(y)
        if act != "gelu":
            set_param(y, "approximate", "tanh")
        y = b.linear(y, e)
        attr(y, "weight", sd[f"{p}.mlp.c_proj.weight"].T)
        attr(y, "bias", sd[f"{p}.mlp.c_proj.bias"])
        x = b.add(x, y)

    x = ln(x, "transformer.ln_f")
    logits = b.linear(x, cfg.vocab_size, bias=False)
    attr(logits, "weight", sd.get("lm_head.weight",
                                  sd["transformer.wte.weight"]))
    b.output(logits)
    return b.build(), "0", logits
