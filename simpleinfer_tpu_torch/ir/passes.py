"""Load-time graph rewrite passes (inference fusions), ported subset.

A copy of the passes of simpleinfer_tpu/ir/passes.py that the port's
path runs: fuse_conv_bn, fuse_conv_activation and fuse_cat_conv1x1. The
W-packed chain marking (a TPU layout means), the C3 collapse (its kernel
is not ported yet) and static-int8 chain marking (a later slice) are
left out.

The reference has exactly one graph pass — expand_expression
(SURVEY.md §2.2 #12) — and leaves op fusion to nobody (each layer runs
standalone; conv+bn+relu is three pipeline nodes). Here three
inference fusions run on the IR before lowering:

- fuse_conv_bn: Conv2d (bias optional) followed by BatchNorm2d folds the
  BN affine into the conv weights/bias (f64 arithmetic at load). Besides
  saving an op, this is REQUIRED for int8 weight-only accuracy: quantizing
  pre-BN weights and applying BN after dequant would double the effective
  quantization noise; folding first keeps per-channel scales meaningful.
  (BASELINE.json config 4: "fused conv+bn+relu".)
- fuse_conv_activation: Conv2d followed by ReLU/SiLU/Hardswish/... tags
  the conv with a `si_fused_act` param and deletes the activation op, so
  the lowering can run the activation inside the conv epilogue (the CUDA
  matmul kernel applies it in registers before the store; the plain conv
  path applies it right after the conv).

Both passes only fire when the intermediate operand has exactly one
consumer and is not a graph output.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph, Operator, Parameter

# pnnx activation type -> epilogue name understood by
# kernels/matmul.resolve_activation
FUSABLE_ACTIVATIONS = {
    "nn.ReLU": "relu",
    "F.relu": "relu",
    "nn.SiLU": "silu",
    "F.silu": "silu",
    "nn.Sigmoid": "sigmoid",
    "F.sigmoid": "sigmoid",
    "nn.Hardsigmoid": "hardsigmoid",
    "F.hardsigmoid": "hardsigmoid",
    "nn.Hardswish": "hardswish",
    "F.hardswish": "hardswish",
    "nn.ReLU6": "relu6",       # mobilenet-v2 family: without this the
    "F.relu6": "relu6",        # int8 chain breaks at EVERY block
    "nn.Tanh": "tanh",
    "F.tanh": "tanh",
    "nn.Mish": "mish",
    "F.mish": "mish",
}


def _parametrized_fusable(act_op) -> str | None:
    """Epilogue name for activations that carry a parameter (encoded as
    `name@value`) or a mode (GELU's approximate)."""
    t = act_op.type
    if t in ("nn.LeakyReLU", "F.leaky_relu"):
        p = act_op.params.get("negative_slope")
        slope = p.f if p is not None and p.type == 3 else 0.01
        return f"leaky_relu@{slope!r}"
    if t in ("nn.ELU", "F.elu"):
        p = act_op.params.get("alpha")
        alpha = p.f if p is not None and p.type == 3 else 1.0
        return f"elu@{alpha!r}"
    if t in ("nn.GELU", "F.gelu"):
        p = act_op.params.get("approximate")
        tanh = p is not None and p.type == 4 and p.s == "tanh"
        return "gelu_tanh" if tanh else "gelu"
    return None

FUSED_ACT_PARAM = "si_fused_act"


def _single_consumer(graph: Graph, op: Operator):
    """The unique consumer of op's single output, or None (also None when
    the output is a graph output via pnnx.Output)."""
    if len(op.outputs) != 1:
        return None
    operand = op.outputs[0]
    if len(operand.consumers) != 1:
        return None
    nxt = operand.consumers[0]
    if nxt.type == "pnnx.Output":
        return None
    return nxt


def _splice_out(graph: Graph, producer: Operator, dead: Operator) -> None:
    """Rewire producer to take over dead's output operand and delete dead
    and the intermediate operand."""
    mid = producer.outputs[0]
    out = dead.outputs[0]
    out.producer = producer
    producer.outputs[0] = out
    graph.remove_operand(mid)
    graph.remove_operator(dead)


def fuse_conv_bn(graph: Graph) -> int:
    """Fold BatchNorm2d into the preceding Conv2d. Returns #fusions."""
    n = 0
    for op in list(graph.ops):
        if op.type != "nn.Conv2d":
            continue
        nxt = _single_consumer(graph, op)
        if nxt is None or nxt.type != "nn.BatchNorm2d":
            continue
        eps = nxt.params["eps"].f
        mean = nxt.attrs["running_mean"].array().astype(np.float64)
        var = nxt.attrs["running_var"].array().astype(np.float64)
        gamma = nxt.attrs["weight"].array().astype(np.float64)
        beta = nxt.attrs["bias"].array().astype(np.float64)
        scale = gamma / np.sqrt(var + eps)  # per out-channel
        shift = beta - mean * scale

        w = op.attrs["weight"].array().astype(np.float64)  # OIHW
        w = w * scale[:, None, None, None]
        from .graph import Attribute

        op.attrs["weight"] = Attribute.from_array(w.astype(np.float32))
        if op.params["bias"].b:
            b = op.attrs["bias"].array().astype(np.float64)
        else:
            b = np.zeros(w.shape[0], np.float64)
            op.params["bias"] = Parameter.from_value(True)
        op.attrs["bias"] = Attribute.from_array(
            (b * scale + shift).astype(np.float32))
        _splice_out(graph, op, nxt)
        n += 1
    return n


def fuse_conv_activation(graph: Graph) -> int:
    """Tag convs (and linears) whose sole consumer is a fusable
    activation; delete the activation op. Returns #fusions."""
    n = 0
    for op in list(graph.ops):
        if op.type not in ("nn.Conv2d", "nn.Linear"):
            continue
        if FUSED_ACT_PARAM in op.params:
            continue
        nxt = _single_consumer(graph, op)
        if nxt is None:
            continue
        act = FUSABLE_ACTIVATIONS.get(nxt.type)
        if act is None:
            act = _parametrized_fusable(nxt)
        if act is None:
            continue
        op.params[FUSED_ACT_PARAM] = Parameter.from_value(act)
        _splice_out(graph, op, nxt)
        n += 1
    return n


def _conv_param(op, key):
    p = op.params.get(key)
    return p.value if p is not None else None


def _plain_conv(op) -> bool:
    return (op.type == "nn.Conv2d"
            and _conv_param(op, "groups") == 1
            and _conv_param(op, "dilation") == [1, 1]
            and _conv_param(op, "padding_mode") == "zeros")


def _pointwise_conv(op) -> bool:
    return (_plain_conv(op)
            and _conv_param(op, "kernel_size") == [1, 1]
            and _conv_param(op, "stride") == [1, 1]
            and _conv_param(op, "padding") == [0, 0])


FUSED_CAT_INPUTS = "si_cat_inputs"


def fuse_cat_conv1x1(graph: Graph) -> int:
    """Eliminate channel concats feeding pointwise convs:
    conv1x1(cat(a, b, ...)) == conv(a, W_a) + conv(b, W_b) + ... with W
    split along input channels — so the concatenated tensor is never
    materialized (C3 blocks and SPPF in YOLOv5 concat 2-4 feature maps
    before a 1x1 conv). Fires
    when EVERY consumer of a channel-dim cat is a pointwise conv; each
    consumer takes the cat's inputs directly and slices its own weight
    at trace time (ops/conv.py FUSED_CAT_INPUTS handling).
    Returns #cats removed."""
    n = 0
    for op in list(graph.ops):
        if op.type != "torch.cat":
            continue
        dim = _conv_param(op, "dim")
        if dim != 1 or len(op.outputs) != 1:
            continue  # channel concat only (logical NCHW dim 1)
        operand = op.outputs[0]
        consumers = list(operand.consumers)
        if not consumers or not all(_pointwise_conv(c) for c in consumers):
            continue
        for conv in consumers:
            # replace the cat operand with the cat's inputs, in order
            new_inputs = []
            for r in conv.inputs:
                if r is operand:
                    for src in op.inputs:
                        src.consumers.append(conv)
                        new_inputs.append(src)
                else:
                    new_inputs.append(r)
            conv.inputs = new_inputs
            conv.params[FUSED_CAT_INPUTS] = Parameter.from_value(True)
        for src in op.inputs:
            src.remove_consumer(op)
        graph.remove_operand(operand)
        graph.remove_operator(op)
        n += 1
    return n


def run_inference_fusions(graph: Graph, cfg=None) -> dict:
    """conv+bn first (so conv+bn+act chains end as one fused conv), then
    activation folding, then the cat-split of pointwise convs."""
    return {"conv_bn": fuse_conv_bn(graph),
            "conv_act": fuse_conv_activation(graph),
            "cat_conv": fuse_cat_conv1x1(graph)}
