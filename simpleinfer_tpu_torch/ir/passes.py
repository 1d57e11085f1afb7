"""Load-time graph rewrite passes (inference fusions), ported subset.

A copy of the passes of simpleinfer_tpu/ir/passes.py that the port's
path runs: fuse_conv_bn, fuse_conv_activation, fuse_c3_blocks,
fuse_cat_conv1x1 and mark_int8_chains, in the JAX order. The W-packed
chain marking (a TPU layout means) is left out, and with it the checks
for its markers in mark_int8_chains.

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


def _binary_add(op) -> bool:
    return (op.type == "BinaryOp" and len(op.inputs) == 2
            and len(op.outputs) == 1 and _conv_param(op, "0") == 0)


def _conv3x3_s1(op) -> bool:
    return (_plain_conv(op)
            and _conv_param(op, "kernel_size") == [3, 3]
            and _conv_param(op, "stride") == [1, 1]
            and _conv_param(op, "padding") == [1, 1])


def _internal(rand, consumer) -> bool:
    """Operand produced and consumed entirely inside the block."""
    return (len(rand.consumers) == 1 and rand.consumers[0] is consumer
            and not any(c.type == "pnnx.Output" for c in rand.consumers))


def fuse_c3_blocks(graph: Graph, cfg=None) -> int:
    """Collapse eligible YOLOv5 C3 blocks into one `si.FusedC3` op
    (ops/c3.py, run by kernels/c3block.c3_block where its gates pass).

    Pattern (zoo/builders.py c3(), after conv+bn/act folding):
        cv1 1x1 ── T x [a 1x1 ── b 3x3 ── (+residual)] ──┐
        x ──┤                                             cat ── cv3 1x1
        cv2 1x1 ─────────────────────────────────────────┘
    Must run BEFORE fuse_cat_conv1x1 (which would erase the cat).
    Eligibility: every conv plain + biased + the SAME activation,
    every intermediate operand internal to the block, and the shape
    passes kernels.c3block.c3_supported (hid >= 64, VMEM fit) —
    ineligible blocks are left for the normal conv path. Weights are
    re-laid out kernel-ready at pass time (matmul [in, out] forms,
    3x3 taps flattened kh*3+kw).
    """
    from ..kernels.c3block import c3_supported

    n = 0
    for cat in list(graph.ops):
        if cat.type != "torch.cat" or _conv_param(cat, "dim") != 1:
            continue
        if len(cat.inputs) != 2 or len(cat.outputs) != 1:
            continue
        if len(cat.outputs[0].consumers) != 1:
            continue
        cv3 = cat.outputs[0].consumers[0]
        if not (_pointwise_conv(cv3) and len(cv3.inputs) == 1
                and len(cv3.outputs) == 1):
            continue
        y1_rand, y2_rand = cat.inputs
        cv2 = y2_rand.producer
        if (cv2 is None or not _pointwise_conv(cv2)
                or not _internal(y2_rand, cat) or len(cv2.inputs) != 1):
            continue

        # walk the bottleneck chain backwards from y1 to cv1
        btl_rev = []        # [(a_conv, b_conv, add_or_None), ...]
        dead_rev = []       # ops to delete, reverse order
        cur = y1_rand
        cv1 = None
        ok = True
        while ok:
            prod = cur.producer
            if prod is None:
                ok = False
            elif prod is not cv2 and _pointwise_conv(prod) \
                    and len(prod.inputs) == 1:
                cv1 = prod
                break
            elif _binary_add(prod):
                b_out, prev = prod.inputs
                b_conv = b_out.producer
                if (b_conv is None or not _conv3x3_s1(b_conv)
                        or not _internal(b_out, prod)
                        or len(b_conv.inputs) != 1):
                    ok = False
                    break
                a_out = b_conv.inputs[0]
                a_conv = a_out.producer
                if (a_conv is None or not _pointwise_conv(a_conv)
                        or not _internal(a_out, b_conv)
                        or len(a_conv.inputs) != 1
                        or a_conv.inputs[0] is not prev):
                    ok = False
                    break
                # prev feeds both a_conv and the add — nothing else
                # unless it is the block input (checked when the loop
                # terminates at cv1)
                btl_rev.append((a_conv, b_conv, prod))
                dead_rev += [prod, b_conv, a_conv]
                cur = prev
            elif _conv3x3_s1(prod) and len(prod.inputs) == 1:
                # shortcut=False bottleneck: a 1x1 then b 3x3, no add
                b_conv = prod
                a_out = b_conv.inputs[0]
                a_conv = a_out.producer
                if (a_conv is None or not _pointwise_conv(a_conv)
                        or not _internal(a_out, b_conv)
                        or len(a_conv.inputs) != 1):
                    ok = False
                    break
                btl_rev.append((a_conv, b_conv, None))
                dead_rev += [b_conv, a_conv]
                cur = a_conv.inputs[0]
            else:
                ok = False
        if not ok or cv1 is None or not btl_rev:
            continue
        if cv1.inputs[0] is not cv2.inputs[0]:
            continue    # cv1/cv2 must share the block input
        x_rand = cv1.inputs[0]
        btl = btl_rev[::-1]
        shortcuts = {add is not None for _a, _b, add in btl}
        if len(shortcuts) != 1:
            continue    # mixed shortcut forms: not a c3() block
        shortcut = shortcuts.pop()

        # internal-edge checks along the forward chain: cv1 out feeds
        # only the first bottleneck (a conv + its add when shortcut)
        chain_in = cv1.outputs[0]
        for a_conv, _b, add in btl:
            want = {id(a_conv)} | ({id(add)} if add is not None else set())
            if {id(c) for c in chain_in.consumers} != want:
                ok = False
                break
            chain_in = (add or _b).outputs[0]
        if not ok or chain_in is not y1_rand:
            continue
        if not _internal(y1_rand, cat):
            continue

        # uniform activation + bias across every conv
        convs = [cv1, cv2, cv3] + [c for a, b, _ in btl for c in (a, b)]
        acts = {(_conv_param(c, FUSED_ACT_PARAM)) for c in convs}
        if len(acts) != 1 or not all(
                c.has_attr("bias") for c in convs):
            continue
        act = acts.pop()

        # geometry + eligibility: the JAX package's channel gates
        # (hid >= 64, multiples of 8), kept so both packages fuse the
        # same blocks and their graphs compare one to one
        c_in = _conv_param(cv1, "in_channels")
        hid = _conv_param(cv1, "out_channels")
        oc = _conv_param(cv3, "out_channels")
        if not c_in or not hid or not oc:
            continue
        if hid < 64 or hid % 8 or c_in % 8 or oc % 8:
            continue
        if _conv_param(cv2, "out_channels") != hid \
                or _conv_param(cv3, "in_channels") != 2 * hid:
            continue
        if any(_conv_param(a, "in_channels") != hid
               or _conv_param(a, "out_channels") != hid
               or _conv_param(b, "in_channels") != hid
               or _conv_param(b, "out_channels") != hid
               for a, b, _ in btl):
            continue
        # declared shapes (when present) skip blocks that can never pass
        # c3_supported; pnnx intermediates often carry no shape — then
        # the apply-time dispatch (ops/c3.py) makes the same decision
        # per actual input and runs the reference chain when unfit.
        oshape = cv3.outputs[0].shape
        if (len(oshape) == 4 and oshape[2] > 0 and oshape[3] > 0
                and not c3_supported(oshape[2], oshape[3], c_in, hid,
                                     oc)):
            continue

        # ---- rewrite ----------------------------------------------------
        def w1x1(c):
            w = c.attrs["weight"].array()          # OIHW [O, I, 1, 1]
            return np.ascontiguousarray(
                w.reshape(w.shape[0], w.shape[1]).T)  # [I, O]

        def w3x3(c):
            w = c.attrs["weight"].array()          # OIHW [O, I, 3, 3]
            return np.ascontiguousarray(
                w.transpose(2, 3, 1, 0).reshape(9, w.shape[1],
                                                w.shape[0]))

        fused = graph.new_operator_before("si.FusedC3",
                                          f"c3_{cv3.name}", cv1)
        fused.params["in_channels"] = Parameter.from_value(c_in)
        fused.params["hidden_channels"] = Parameter.from_value(hid)
        fused.params["out_channels"] = Parameter.from_value(oc)
        fused.params["n_bottlenecks"] = Parameter.from_value(len(btl))
        fused.params["shortcut"] = Parameter.from_value(shortcut)
        if act is not None:
            fused.params[FUSED_ACT_PARAM] = Parameter.from_value(act)
        from .graph import Attribute

        A = Attribute.from_array
        fused.attrs["cv1_w"] = A(w1x1(cv1))
        fused.attrs["cv1_b"] = A(cv1.attrs["bias"].array())
        fused.attrs["cv2_w"] = A(w1x1(cv2))
        fused.attrs["cv2_b"] = A(cv2.attrs["bias"].array())
        fused.attrs["cv3_w"] = A(w1x1(cv3))       # [2*hid, OC]
        fused.attrs["cv3_b"] = A(cv3.attrs["bias"].array())
        fused.attrs["btl_a_w"] = A(np.stack(
            [w1x1(a) for a, _b, _ in btl]))
        fused.attrs["btl_a_b"] = A(np.stack(
            [a.attrs["bias"].array() for a, _b, _ in btl]))
        fused.attrs["btl_b_w"] = A(np.stack(
            [w3x3(b) for _a, b, _ in btl]))
        fused.attrs["btl_b_b"] = A(np.stack(
            [b.attrs["bias"].array() for _a, b, _ in btl]))

        out_rand = cv3.outputs[0]
        fused.inputs = [x_rand]
        fused.outputs = [out_rand]
        out_rand.producer = fused
        x_rand.remove_consumer(cv1)
        x_rand.remove_consumer(cv2)
        x_rand.consumers.append(fused)

        dead_ops = [cv1, cv2, cat, cv3] + dead_rev
        dead_rands = {id(r): r for r in
                      [y1_rand, y2_rand, cat.outputs[0],
                       cv1.outputs[0], cv2.outputs[0]]
                      + [o.outputs[0] for o in dead_rev]}
        dead_rands.pop(id(out_rand), None)
        for r in dead_rands.values():
            graph.remove_operand(r)
        for o in dead_ops:
            graph.remove_operator(o)
        n += 1
    return n


FUSED_Q_OUT = "si_q_out"  # value: the consumer op name whose calibrated
#                            act_scale the producer requantizes to


def mark_int8_chains(graph: Graph, min_channels: int | None = None,
                     pointwise: bool | None = None) -> int:
    """Mark conv->conv edges where the producer should requantize its
    output to int8 itself (static-int8 mode only): the intermediate is
    handed on as 1-byte data and the consumer's quantize pass
    disappears (the JAX package measured the standalone quantize at up
    to 40% of the s8 chain's win on a TPU v5e).

    Edge eligibility: producer is a plain single-output conv outside the
    cat domain (and, in the JAX package, its packed domain) and not a
    graph output; EVERY consumer is a single-input plain conv that will
    take the s8 path (ops/conv.int8_conv_eligible). All consumers read
    the same operand, so they share one calibrated scale by
    construction. `min_channels` / `pointwise` default to the gate's
    constants (ops/conv.INT8_MIN_CHANNELS / INT8_POINTWISE). Returns
    #edges marked."""
    from ..ops import conv as _conv

    if min_channels is None:
        min_channels = _conv.INT8_MIN_CHANNELS
    if pointwise is None:
        pointwise = _conv.INT8_POINTWISE
    n = 0
    for op in list(graph.ops):
        if op.type != "nn.Conv2d" or len(op.outputs) != 1:
            continue
        if FUSED_CAT_INPUTS in op.params:
            continue
        operand = op.outputs[0]
        consumers = operand.consumers
        if not consumers:
            continue

        def takes_s8(c) -> bool:
            # must mirror the runtime dispatch gate (shared predicate),
            # conservatively restricted to plain single-input convs
            if c.type != "nn.Conv2d" or len(c.inputs) != 1:
                return False
            if FUSED_CAT_INPUTS in c.params:
                return False
            ks = _conv_param(c, "kernel_size") or [1, 1]
            ic = _conv_param(c, "in_channels") or 0
            return (_plain_conv(c) and _conv.int8_conv_eligible(
                ks[0] * ks[1], ic, min_channels, pointwise))

        if all(takes_s8(c) for c in consumers):
            op.params[FUSED_Q_OUT] = Parameter.from_value(
                consumers[0].name)
            n += 1
    return n


def run_inference_fusions(graph: Graph, cfg=None) -> dict:
    """conv+bn first (so conv+bn+act chains end as one fused conv), then
    activation folding, then the C3 collapse (it must see the cat, so
    before fuse_cat_conv1x1; only with EngineConfig.c3_fusion), then the
    cat-split of pointwise convs; int8-chain marking last, in static-int8
    mode only."""
    stats = {"conv_bn": fuse_conv_bn(graph),
             "conv_act": fuse_conv_activation(graph)}
    if cfg is not None and getattr(cfg, "c3_fusion", False):
        stats["c3"] = fuse_c3_blocks(graph, cfg)
    stats["cat_conv"] = fuse_cat_conv1x1(graph)
    if cfg is not None and getattr(cfg, "quant", None) == "int8":
        stats["int8_chain"] = mark_int8_chains(graph)
    return stats
