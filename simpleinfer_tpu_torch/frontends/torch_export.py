"""In-process PyTorch -> Graph exporter (torch.fx).

A copy of simpleinfer_tpu/frontends/torch_export.py for the port:
`export_torch(module, example)` traces an eager `torch.nn.Module` with
torch.fx, propagates shapes, and builds the pnnx-convention Graph the
file parser would produce — params/attrs named exactly as the op
lowerings expect (ops/*.py), shapes declared NCHW. The resulting Graph
feeds Engine.load_model(graph=...) directly, or Graph.save() writes it
to .pnnx.param/.bin files; it is the JAX package's graph, byte for byte
through Graph.save.

Two differences, both about where the module lives: torch is this
package's runtime, so the dispatch tables are built at import; and the
shapes propagate on the module's own device (a module on the card runs
its example there), its weights carried to numpy by
`.detach().float().cpu()`.
"""
from __future__ import annotations

import operator

import numpy as np
import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from ..ir.graph import Attribute, Graph, Parameter


class TorchExportError(ValueError):
    """A traced node has no mapping to a supported op."""


def _param(op, key, value):
    op.params[key] = Parameter.from_value(value)


def numpy_f32(tensor) -> np.ndarray:
    """A float32 numpy copy of a tensor on any device at any dtype (bf16
    included: numpy has no bfloat16, so the cast happens in torch)."""
    return tensor.detach().to("cpu", torch.float32, copy=True).numpy()


def _attr(op, key, tensor):
    op.attrs[key] = Attribute.from_array(numpy_f32(tensor))


def _pair(v):
    if isinstance(v, (tuple, list)):
        return [int(v[0]), int(v[1])]
    return [int(v), int(v)]


def _node_shape(node):
    tm = node.meta.get("tensor_meta")
    return list(tm.shape) if tm is not None else []


class _Builder:
    def __init__(self):
        self.g = Graph()
        self.operand_of = {}  # fx node name -> Operand
        # fx node name -> static python value (shape tuples / ints from
        # x.shape[i] / x.size(i) — resolved via ShapeProp metadata so
        # "dynamic" size uses trace to compile-time constants)
        self.const_of = {}

    def add_op(self, type_, name, in_nodes, out_node=None, n_out=1):
        op = self.g.new_operator(type_, name)
        for nd in in_nodes:
            r = self.operand_of[nd.name]
            r.consumers.append(op)
            op.inputs.append(r)
        outs = []
        for j in range(n_out):
            r = self.g.new_operand(name if n_out == 1 else f"{name}_{j}")
            r.producer = op
            r.type = 1  # f32
            op.outputs.append(r)
            outs.append(r)
        if out_node is not None:
            outs[0].shape = _node_shape(out_node)
            self.operand_of[out_node.name] = outs[0]
        return op


def _static_int(b, v, ctx):
    """Resolve an int-valued arg that may be a traced x.shape[i] node."""
    if isinstance(v, int):
        return v
    if isinstance(v, torch.fx.Node) and v.name in b.const_of:
        c = b.const_of[v.name]
        if isinstance(c, int):
            return c
    raise TorchExportError(
        f"{ctx}: only static int sizes are supported, got {v!r}")


def _scalar_binary(b, node, code, tensor_node, scalar, name):
    """tensor (code) scalar — BinaryOp with the scalar in params, like
    the expression expander emits (ir/expression.py)."""
    op = b.add_op("BinaryOp", name, [tensor_node], node)
    _param(op, "0", code)
    _param(op, "1", 1)
    _param(op, "2", float(scalar))


def _export_binary(b, node, code, a0, a1, name):
    """Shared add/sub/mul/div emitter for the function AND method
    paths. torch.add/sub's `alpha` scaling is NOT representable as one
    BinaryOp — refuse rather than silently dropping it."""
    alpha = node.kwargs.get("alpha", 1)
    if alpha != 1:
        raise TorchExportError(
            f"add/sub with alpha={alpha} at node {node.name!r} is not "
            f"supported; scale the operand explicitly instead")
    is_node = [isinstance(a, torch.fx.Node) for a in (a0, a1)]
    if all(is_node):
        op = b.add_op("BinaryOp", name, [a0, a1], node)
        _param(op, "0", code)
    elif is_node[0]:
        _scalar_binary(b, node, code, a0, a1, name)
    else:  # scalar op tensor -> reversed code (7=rsub, 8=rdiv)
        rcode = {0: 0, 2: 2, 1: 7, 3: 8}[code]
        _scalar_binary(b, node, rcode, a1, a0, name)


def _export_flatten(b, node, name):
    op = b.add_op("torch.flatten", name, [node.args[0]], node)
    _param(op, "start_dim",
           int(node.args[1]) if len(node.args) > 1 else 0)
    _param(op, "end_dim",
           int(node.args[2]) if len(node.args) > 2 else -1)


# operator/torch-function -> ncnn BinaryOp code (ops/binary.py table);
# the *_r codes handle scalar-first usage
_BINARY_CODES = {
    operator.add: 0, torch.add: 0,
    operator.sub: 1, torch.sub: 1,
    operator.mul: 2, torch.mul: 2,
    operator.truediv: 3, torch.div: 3,
}

_ACT_MODULES = {
    nn.ReLU: "nn.ReLU", nn.SiLU: "nn.SiLU", nn.Sigmoid: "nn.Sigmoid",
    nn.Hardsigmoid: "nn.Hardsigmoid", nn.Hardswish: "nn.Hardswish",
    nn.Tanh: "nn.Tanh", nn.GELU: "nn.GELU",
    nn.ReLU6: "nn.ReLU6", nn.Mish: "nn.Mish",
}
_ACT_FUNCTIONS = {
    F.relu: "nn.ReLU", torch.relu: "nn.ReLU",
    F.silu: "nn.SiLU",
    torch.sigmoid: "nn.Sigmoid", F.sigmoid: "nn.Sigmoid",
    F.hardsigmoid: "nn.Hardsigmoid", F.hardswish: "nn.Hardswish",
    torch.tanh: "nn.Tanh", F.gelu: "nn.GELU",
    F.relu6: "nn.ReLU6", F.mish: "nn.Mish",
}


def _export_module(b, node, mod, name):
    t = type(mod)
    if t in _ACT_MODULES:
        op = b.add_op(_ACT_MODULES[t], name, [node.args[0]], node)
        if t is nn.GELU:
            # exact vs tanh approximation differ by ~3e-3 — export it
            _param(op, "approximate", mod.approximate)
        return
    if t is nn.LeakyReLU:
        op = b.add_op("nn.LeakyReLU", name, [node.args[0]], node)
        _param(op, "negative_slope", float(mod.negative_slope))
        return
    if t is nn.ELU:
        op = b.add_op("nn.ELU", name, [node.args[0]], node)
        _param(op, "alpha", float(mod.alpha))
        return
    if t is nn.Conv2d:
        op = b.add_op("nn.Conv2d", name, [node.args[0]], node)
        if isinstance(mod.padding, str):
            if mod.padding == "valid":
                pad = [0, 0]
            else:  # "same" with symmetric support only
                pad = [int(mod.dilation[0]) * (mod.kernel_size[0] - 1) // 2,
                       int(mod.dilation[1]) * (mod.kernel_size[1] - 1) // 2]
        else:
            pad = _pair(mod.padding)
        _param(op, "bias", mod.bias is not None)
        _param(op, "dilation", _pair(mod.dilation))
        _param(op, "groups", int(mod.groups))
        _param(op, "in_channels", int(mod.in_channels))
        _param(op, "kernel_size", _pair(mod.kernel_size))
        _param(op, "out_channels", int(mod.out_channels))
        _param(op, "padding", pad)
        _param(op, "padding_mode", mod.padding_mode)
        _param(op, "stride", _pair(mod.stride))
        _attr(op, "weight", mod.weight)
        if mod.bias is not None:
            _attr(op, "bias", mod.bias)
        return
    if t is nn.BatchNorm2d:
        if mod.running_mean is None:
            raise TorchExportError(
                f"BatchNorm2d at {node.name!r} has "
                f"track_running_stats=False — inference export needs "
                f"running statistics")
        op = b.add_op("nn.BatchNorm2d", name, [node.args[0]], node)
        _param(op, "affine", bool(mod.affine))
        _param(op, "eps", float(mod.eps))
        _param(op, "num_features", int(mod.num_features))
        _attr(op, "running_mean", mod.running_mean)
        _attr(op, "running_var", mod.running_var)
        c = mod.num_features
        _attr(op, "weight", mod.weight if mod.affine else torch.ones(c))
        _attr(op, "bias", mod.bias if mod.affine else torch.zeros(c))
        return
    if t is nn.LayerNorm:
        op = b.add_op("nn.LayerNorm", name, [node.args[0]], node)
        _param(op, "elementwise_affine", bool(mod.elementwise_affine))
        _param(op, "eps", float(mod.eps))
        _param(op, "normalized_shape", [int(d) for d in
                                        mod.normalized_shape])
        if mod.elementwise_affine:
            _attr(op, "weight", mod.weight)
            _attr(op, "bias", mod.bias)
        return
    if t is nn.GroupNorm:
        op = b.add_op("nn.GroupNorm", name, [node.args[0]], node)
        _param(op, "affine", bool(mod.affine))
        _param(op, "eps", float(mod.eps))
        _param(op, "num_channels", int(mod.num_channels))
        _param(op, "num_groups", int(mod.num_groups))
        if mod.affine:
            _attr(op, "weight", mod.weight)
            _attr(op, "bias", mod.bias)
        return
    if t is nn.InstanceNorm2d:
        op = b.add_op("nn.InstanceNorm2d", name, [node.args[0]], node)
        _param(op, "affine", bool(mod.affine))
        _param(op, "eps", float(mod.eps))
        _param(op, "num_features", int(mod.num_features))
        if mod.affine:
            _attr(op, "weight", mod.weight)
            _attr(op, "bias", mod.bias)
        if mod.track_running_stats and mod.running_mean is not None:
            # eval-mode normalizes with the RUNNING stats (BN semantics)
            _attr(op, "running_mean", mod.running_mean)
            _attr(op, "running_var", mod.running_var)
        return
    if t is nn.Linear:
        op = b.add_op("nn.Linear", name, [node.args[0]], node)
        _param(op, "bias", mod.bias is not None)
        _param(op, "in_features", int(mod.in_features))
        _param(op, "out_features", int(mod.out_features))
        _attr(op, "weight", mod.weight)
        if mod.bias is not None:
            _attr(op, "bias", mod.bias)
        return
    if t is nn.MaxPool2d:
        op = b.add_op("nn.MaxPool2d", name, [node.args[0]], node)
        _param(op, "ceil_mode", bool(mod.ceil_mode))
        _param(op, "dilation", _pair(mod.dilation))
        _param(op, "kernel_size", _pair(mod.kernel_size))
        _param(op, "padding", _pair(mod.padding))
        _param(op, "return_indices", bool(mod.return_indices))
        _param(op, "stride", _pair(mod.stride or mod.kernel_size))
        return
    if t is nn.AvgPool2d:
        op = b.add_op("nn.AvgPool2d", name, [node.args[0]], node)
        _param(op, "ceil_mode", bool(mod.ceil_mode))
        _param(op, "count_include_pad", bool(mod.count_include_pad))
        _param(op, "kernel_size", _pair(mod.kernel_size))
        _param(op, "padding", _pair(mod.padding))
        _param(op, "stride", _pair(mod.stride or mod.kernel_size))
        return
    if t is nn.AdaptiveAvgPool2d:
        op = b.add_op("nn.AdaptiveAvgPool2d", name, [node.args[0]], node)
        _param(op, "output_size", _pair(mod.output_size))
        return
    if t is nn.Upsample:
        op = b.add_op("nn.Upsample", name, [node.args[0]], node)
        _param(op, "mode", mod.mode)
        if mod.scale_factor is not None:
            sf = mod.scale_factor
            sf = [float(sf[0]), float(sf[1])] if isinstance(
                sf, (tuple, list)) else [float(sf), float(sf)]
            _param(op, "scale_factor", sf)
        if mod.size is not None:
            _param(op, "size", _pair(mod.size))
        if mod.mode in ("bilinear", "linear"):
            _param(op, "align_corners", bool(mod.align_corners))
        return
    if t is nn.Flatten:
        op = b.add_op("torch.flatten", name, [node.args[0]], node)
        _param(op, "start_dim", int(mod.start_dim))
        _param(op, "end_dim", int(mod.end_dim))
        return
    if t is nn.ConvTranspose2d:
        op = b.add_op("nn.ConvTranspose2d", name, [node.args[0]], node)
        _param(op, "bias", mod.bias is not None)
        _param(op, "dilation", _pair(mod.dilation))
        _param(op, "groups", int(mod.groups))
        _param(op, "in_channels", int(mod.in_channels))
        _param(op, "kernel_size", _pair(mod.kernel_size))
        _param(op, "out_channels", int(mod.out_channels))
        _param(op, "output_padding", _pair(mod.output_padding))
        _param(op, "padding", _pair(mod.padding))
        _param(op, "stride", _pair(mod.stride))
        _attr(op, "weight", mod.weight)
        if mod.bias is not None:
            _attr(op, "bias", mod.bias)
        return
    if t is nn.Softmax:
        op = b.add_op("nn.Softmax", name, [node.args[0]], node)
        _param(op, "dim", int(mod.dim if mod.dim is not None else -1))
        return
    if t is nn.ZeroPad2d:
        op = b.add_op("nn.ZeroPad2d", name, [node.args[0]], node)
        p = mod.padding
        pad = ([int(v) for v in p] if isinstance(p, (tuple, list))
               else [int(p)] * 4)
        _param(op, "padding", pad)
        return
    if t in (nn.Identity, nn.Dropout, nn.Dropout2d, nn.Dropout3d,
             nn.AlphaDropout):
        # inference no-ops: alias the input operand
        b.operand_of[node.name] = b.operand_of[node.args[0].name]
        return
    if getattr(nn, "RMSNorm", None) is not None and t is nn.RMSNorm:
        op = b.add_op("nn.RMSNorm", name, [node.args[0]], node)
        _param(op, "elementwise_affine", bool(mod.elementwise_affine))
        eps = mod.eps if mod.eps is not None else torch.finfo(
            torch.float32).eps
        _param(op, "eps", float(eps))
        _param(op, "normalized_shape", [int(d) for d in
                                        mod.normalized_shape])
        if mod.elementwise_affine:
            _attr(op, "weight", mod.weight)
        return
    if t is nn.Embedding:
        op = b.add_op("nn.Embedding", name, [node.args[0]], node)
        _param(op, "num_embeddings", int(mod.num_embeddings))
        _param(op, "embedding_dim", int(mod.embedding_dim))
        _param(op, "sparse", bool(mod.sparse))
        _attr(op, "weight", mod.weight)
        return
    if t is nn.MultiheadAttention:
        if node.kwargs.get("key_padding_mask") is not None:
            raise TorchExportError(
                f"MultiheadAttention at {node.name!r}: key_padding_mask "
                f"is not supported (merge it into attn_mask)")
        if mod.bias_k is not None or mod.bias_v is not None \
                or mod.add_zero_attn:
            raise TorchExportError(
                f"MultiheadAttention at {node.name!r}: add_bias_kv/"
                f"add_zero_attn are not supported")
        in_nodes = [a for a in node.args[:3]
                    if isinstance(a, torch.fx.Node)]
        mask = node.kwargs.get("attn_mask")
        if isinstance(mask, torch.fx.Node):
            in_nodes.append(mask)
        # module returns a (output, weights) tuple -> 2 declared outputs;
        # downstream getitem nodes alias them (tuple-output handler)
        op = b.add_op("nn.MultiheadAttention", name, in_nodes, n_out=2)
        b.operand_of[node.name] = op.outputs[0]
        _fill_mha(op, mod)
        return
    if t is nn.TransformerEncoderLayer:
        if node.kwargs.get("src_mask") is not None or \
                node.kwargs.get("src_key_padding_mask") is not None:
            raise TorchExportError(
                f"TransformerEncoderLayer at {node.name!r}: masks are "
                f"not supported in export")
        r = _emit_encoder_layer(b, b.operand_of[node.args[0].name],
                                mod, name)
        r.shape = _node_shape(node)
        b.operand_of[node.name] = r
        return
    if t is nn.TransformerEncoder:
        if node.kwargs.get("mask") is not None or \
                node.kwargs.get("src_key_padding_mask") is not None:
            raise TorchExportError(
                f"TransformerEncoder at {node.name!r}: masks are not "
                f"supported in export")
        r = b.operand_of[node.args[0].name]
        for i, layer in enumerate(mod.layers):
            r = _emit_encoder_layer(b, r, layer, f"{name}_l{i}")
        if mod.norm is not None:
            r = _emit_ln(b, r, mod.norm, f"{name}_norm")
        r.shape = _node_shape(node)
        b.operand_of[node.name] = r
        return
    raise TorchExportError(f"unsupported module type {t.__name__} "
                           f"at node {node.name!r}")


def _fill_mha(op, mod):
    """Shared nn.MultiheadAttention param/attr emission (used by the
    direct module handler and the TransformerEncoderLayer decomposer)."""
    _param(op, "embed_dim", int(mod.embed_dim))
    _param(op, "num_heads", int(mod.num_heads))
    _param(op, "batch_first", bool(mod.batch_first))
    _param(op, "add_zero_attn", False)
    _param(op, "add_bias_kv", False)
    _param(op, "bias", mod.in_proj_bias is not None)
    if mod._qkv_same_embed_dim:
        _attr(op, "in_proj_weight", mod.in_proj_weight)
    else:
        _param(op, "kdim", int(mod.kdim))
        _param(op, "vdim", int(mod.vdim))
        _attr(op, "q_proj_weight", mod.q_proj_weight)
        _attr(op, "k_proj_weight", mod.k_proj_weight)
        _attr(op, "v_proj_weight", mod.v_proj_weight)
    if mod.in_proj_bias is not None:
        _attr(op, "in_proj_bias", mod.in_proj_bias)
    _attr(op, "out_proj.weight", mod.out_proj.weight)
    if mod.out_proj.bias is not None:
        _attr(op, "out_proj.bias", mod.out_proj.bias)


# ---- raw-operand emitters (decomposing container modules like
#      TransformerEncoderLayer into primitive ops; no fx nodes involved)
def _raw_op(b, type_, name, in_rs, n_out=1):
    op = b.g.new_operator(type_, name)
    for r in in_rs:
        r.consumers.append(op)
        op.inputs.append(r)
    for j in range(n_out):
        r = b.g.new_operand(name if n_out == 1 else f"{name}_{j}")
        r.producer = op
        r.type = 1
        op.outputs.append(r)
    return op


def _emit_ln(b, r, mod, name):
    op = _raw_op(b, "nn.LayerNorm", name, [r])
    _param(op, "elementwise_affine", bool(mod.elementwise_affine))
    _param(op, "eps", float(mod.eps))
    _param(op, "normalized_shape", [int(d) for d in mod.normalized_shape])
    if mod.elementwise_affine:
        _attr(op, "weight", mod.weight)
        _attr(op, "bias", mod.bias)
    return op.outputs[0]


def _emit_linear(b, r, mod, name):
    op = _raw_op(b, "nn.Linear", name, [r])
    _param(op, "bias", mod.bias is not None)
    _param(op, "in_features", int(mod.in_features))
    _param(op, "out_features", int(mod.out_features))
    _attr(op, "weight", mod.weight)
    if mod.bias is not None:
        _attr(op, "bias", mod.bias)
    return op.outputs[0]


def _emit_add(b, a, c, name):
    op = _raw_op(b, "BinaryOp", name, [a, c])
    _param(op, "0", 0)  # add
    return op.outputs[0]


def _emit_activation(b, r, act, name):
    """Map a TransformerEncoderLayer activation (F.relu/F.gelu function
    or an activation module instance) onto a registered op."""
    if isinstance(act, nn.Module):
        type_ = {"ReLU": "nn.ReLU", "GELU": "nn.GELU",
                 "SiLU": "nn.SiLU"}.get(type(act).__name__)
    else:
        type_ = {F.relu: "nn.ReLU", F.gelu: "nn.GELU",
                 F.silu: "nn.SiLU"}.get(act)
    if type_ is None:
        raise TorchExportError(
            f"unsupported encoder-layer activation {act!r} at {name!r}")
    op = _raw_op(b, type_, name, [r])
    if type_ == "nn.GELU":
        approx = getattr(act, "approximate", "none")
        _param(op, "approximate", approx)
    return op.outputs[0]


def _emit_encoder_layer(b, r, mod, prefix):
    """Decompose nn.TransformerEncoderLayer (inference: dropout =
    identity) into MHA + Linear/act/Linear with pre- or post-LN
    residual wiring, matching torch's norm_first semantics."""
    def sa(x, tag):
        op = _raw_op(b, "nn.MultiheadAttention", f"{prefix}_{tag}",
                     [x], n_out=2)
        _fill_mha(op, mod.self_attn)
        return op.outputs[0]

    def ff(x, tag):
        y = _emit_linear(b, x, mod.linear1, f"{prefix}_{tag}_fc1")
        y = _emit_activation(b, y, mod.activation, f"{prefix}_{tag}_act")
        return _emit_linear(b, y, mod.linear2, f"{prefix}_{tag}_fc2")

    if mod.norm_first:
        r = _emit_add(b, r, sa(_emit_ln(b, r, mod.norm1,
                                        f"{prefix}_ln1"), "sa"),
                      f"{prefix}_add1")
        r = _emit_add(b, r, ff(_emit_ln(b, r, mod.norm2,
                                        f"{prefix}_ln2"), "ff"),
                      f"{prefix}_add2")
    else:
        r = _emit_ln(b, _emit_add(b, r, sa(r, "sa"), f"{prefix}_add1"),
                     mod.norm1, f"{prefix}_ln1")
        r = _emit_ln(b, _emit_add(b, r, ff(r, "ff"), f"{prefix}_add2"),
                     mod.norm2, f"{prefix}_ln2")
    return r


def _export_function(b, node, name):
    fn = node.target
    if fn in _ACT_FUNCTIONS:
        op = b.add_op(_ACT_FUNCTIONS[fn], name, [node.args[0]], node)
        if _ACT_FUNCTIONS[fn] == "nn.GELU":
            _param(op, "approximate",
                   node.kwargs.get("approximate", "none"))
        return
    if fn in _BINARY_CODES:
        _export_binary(b, node, _BINARY_CODES[fn], node.args[0],
                       node.args[1], name)
        return
    if fn is torch.cat:
        tensors = node.args[0]
        op = b.add_op("torch.cat", name, list(tensors), node)
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get(
            "dim", 0)
        _param(op, "dim", int(dim))
        return
    if fn is torch.flatten:
        _export_flatten(b, node, name)
        return
    if fn is torch.permute:
        op = b.add_op("torch.permute", name, [node.args[0]], node)
        _param(op, "dims", [int(d) for d in node.args[1]])
        return
    if fn is torch.chunk:
        _export_chunk(b, node, name)
        return
    if fn.__name__ == "split" and getattr(fn, "__module__", "") in (
            "torch.functional", "torch"):
        _export_split(b, node, name)
        return
    if fn.__name__ == "softmax" and getattr(fn, "__module__", ""
                                            ).endswith("functional"):
        op = b.add_op("nn.Softmax", name, [node.args[0]], node)
        dim = (node.args[1] if len(node.args) > 1
               else node.kwargs.get("dim", -1))
        _param(op, "dim", int(dim if dim is not None else -1))
        return
    if fn is torch.clamp:
        op = b.add_op("torch.clamp", name, [node.args[0]], node)
        lo = (node.args[1] if len(node.args) > 1
              else node.kwargs.get("min"))
        hi = (node.args[2] if len(node.args) > 2
              else node.kwargs.get("max"))
        if lo is not None:
            _param(op, "min", float(lo))
        if hi is not None:
            _param(op, "max", float(hi))
        return
    if fn.__name__ == "pad" and getattr(fn, "__module__", ""
                                        ).endswith("functional"):
        op = b.add_op("F.pad", name, [node.args[0]], node)
        pad = (node.args[1] if len(node.args) > 1
               else node.kwargs["pad"])
        _param(op, "pad", [int(v) for v in pad])
        mode = (node.args[2] if len(node.args) > 2
                else node.kwargs.get("mode", "constant"))
        _param(op, "mode", str(mode))
        value = (node.args[3] if len(node.args) > 3
                 else node.kwargs.get("value"))
        if value is not None:
            _param(op, "value", float(value))
        return
    if fn.__name__ == "interpolate" and getattr(fn, "__module__", ""
                                                ).endswith("functional"):
        # signature: interpolate(input, size=None, scale_factor=None, ...)
        op = b.add_op("nn.Upsample", name, [node.args[0]], node)
        # signature: (input, size, scale_factor, mode, align_corners, ...)
        mode = (node.args[3] if len(node.args) > 3
                else node.kwargs.get("mode", "nearest"))
        _param(op, "mode", mode)
        sf = node.kwargs.get(
            "scale_factor",
            node.args[2] if len(node.args) > 2 else None)
        if sf is not None:
            sf = ([float(sf[0]), float(sf[1])]
                  if isinstance(sf, (tuple, list))
                  else [float(sf), float(sf)])
            _param(op, "scale_factor", sf)
        size = node.kwargs.get(
            "size", node.args[1] if len(node.args) > 1 else None)
        if size is not None:
            _param(op, "size", _pair(size))
        if sf is None and size is None:
            raise TorchExportError(
                f"interpolate at {node.name!r} needs size or "
                f"scale_factor")
        if mode in ("bilinear", "linear"):
            align = (node.args[4] if len(node.args) > 4
                     else node.kwargs.get("align_corners"))
            _param(op, "align_corners", bool(align or False))
        return
    if fn.__name__ == "max_pool2d" and getattr(fn, "__module__", ""
                                               ).endswith("functional"):
        # F.max_pool2d(input, kernel_size, stride=None, padding=0,
        #              dilation=1, ceil_mode=False)
        op = b.add_op("F.max_pool2d", name, [node.args[0]], node)
        args = list(node.args[1:])

        def arg(i, key, default):
            if i < len(args):
                return args[i]
            return node.kwargs.get(key, default)

        _param(op, "kernel_size", _pair(arg(0, "kernel_size", None)))
        stride = arg(1, "stride", None)
        _param(op, "stride",
               _pair(stride) if stride else _pair(arg(0, "kernel_size",
                                                      None)))
        _param(op, "padding", _pair(arg(2, "padding", 0)))
        _param(op, "dilation", _pair(arg(3, "dilation", 1)))
        _param(op, "ceil_mode", bool(arg(4, "ceil_mode", False)))
        return
    # F.avg_pool2d is a C builtin (__module__ == "torch._C._nn")
    if fn.__name__ == "avg_pool2d" and getattr(
            fn, "__module__", "") in ("torch._C._nn",
                                      "torch.nn.functional"):
        op = b.add_op("F.avg_pool2d", name, [node.args[0]], node)
        args = list(node.args[1:])

        def arg(i, key, default):
            if i < len(args):
                return args[i]
            return node.kwargs.get(key, default)

        _param(op, "kernel_size", _pair(arg(0, "kernel_size", None)))
        stride = arg(1, "stride", None)
        _param(op, "stride",
               _pair(stride) if stride else _pair(arg(0, "kernel_size",
                                                      None)))
        _param(op, "padding", _pair(arg(2, "padding", 0)))
        _param(op, "ceil_mode", bool(arg(3, "ceil_mode", False)))
        _param(op, "count_include_pad",
               bool(arg(4, "count_include_pad", True)))
        return
    if fn.__name__ == "adaptive_avg_pool2d" and getattr(
            fn, "__module__", "").endswith("functional"):
        op = b.add_op("F.adaptive_avg_pool2d", name, [node.args[0]], node)
        out_size = (node.args[1] if len(node.args) > 1
                    else node.kwargs.get("output_size"))
        if out_size is None:
            raise TorchExportError(
                f"adaptive_avg_pool2d at {node.name!r} needs output_size")
        _param(op, "output_size", _pair(out_size))
        return
    if fn.__name__ == "leaky_relu" and getattr(fn, "__module__", ""
                                               ).endswith("functional"):
        op = b.add_op("nn.LeakyReLU", name, [node.args[0]], node)
        slope = (node.args[1] if len(node.args) > 1
                 else node.kwargs.get("negative_slope", 0.01))
        _param(op, "negative_slope", float(slope))
        return
    if fn.__name__ == "elu" and getattr(fn, "__module__", ""
                                        ).endswith("functional"):
        op = b.add_op("nn.ELU", name, [node.args[0]], node)
        alpha = (node.args[1] if len(node.args) > 1
                 else node.kwargs.get("alpha", 1.0))
        _param(op, "alpha", float(alpha))
        return
    if fn.__name__ in ("dropout", "dropout2d") and getattr(
            fn, "__module__", "").endswith("functional"):
        # inference no-op: alias the input operand
        b.operand_of[node.name] = b.operand_of[node.args[0].name]
        return
    if fn in (torch.sum, torch.amax):
        _export_reduce(b, node, "torch.sum" if fn is torch.sum
                       else "torch.amax", name)
        return
    if fn is torch.stack:
        tensors = node.args[0]
        op = b.add_op("torch.stack", name, list(tensors), node)
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get(
            "dim", 0)
        _param(op, "dim", int(dim))
        return
    if fn is torch.mean:
        dims = (node.args[1] if len(node.args) > 1
                else node.kwargs.get("dim"))
        if dims is None:
            raise TorchExportError(
                f"torch.mean without dim at {node.name!r} is not "
                f"supported (global mean over all axes)")
        dims = [int(dims)] if isinstance(dims, int) else [int(d)
                                                          for d in dims]
        op = b.add_op("torch.mean", name, [node.args[0]], node)
        _param(op, "dim", dims)
        _param(op, "keepdim", bool(node.kwargs.get(
            "keepdim", node.args[2] if len(node.args) > 2 else False)))
        return
    if fn is torch.matmul or fn is operator.matmul:
        b.add_op("torch.matmul", name, [node.args[0], node.args[1]], node)
        return
    if fn is torch.bmm:
        b.add_op("torch.bmm", name, [node.args[0], node.args[1]], node)
        return
    if fn is torch.select:
        op = b.add_op("torch.select", name, [node.args[0]], node)
        _param(op, "dim", int(node.args[1]))
        _param(op, "index", int(node.args[2]))
        return
    # note: F.scaled_dot_product_attention is a torch._C._nn builtin, so
    # its __module__ is not *.functional — match by name alone
    if fn.__name__ == "scaled_dot_product_attention":
        if node.kwargs.get("dropout_p", 0.0) not in (0.0, None):
            pass  # inference: dropout is identity
        in_nodes = list(node.args[:3])
        mask = (node.args[3] if len(node.args) > 3
                else node.kwargs.get("attn_mask"))
        if mask is not None and not isinstance(mask, (int, float)):
            in_nodes.append(mask)
        op = b.add_op("F.scaled_dot_product_attention", name, in_nodes,
                      node)
        _param(op, "dropout_p", 0.0)
        is_causal = (node.args[5] if len(node.args) > 5
                     else node.kwargs.get("is_causal", False))
        _param(op, "is_causal", bool(is_causal))
        scale = node.kwargs.get("scale")
        if scale is not None:
            _param(op, "scale", float(scale))
        return
    raise TorchExportError(f"unsupported function {fn} at node "
                           f"{node.name!r}")


def _export_split(b, node, name):
    """torch.split / Tensor.split -> multi-output torch.split op
    (split_size int or explicit section list; n_out needs the input's
    propagated dim size for the int form)."""
    sections = (node.args[1] if len(node.args) > 1
                else node.kwargs["split_size_or_sections"])
    dim = int(node.args[2] if len(node.args) > 2
              else node.kwargs.get("dim", 0))
    src = node.args[0]
    if isinstance(sections, (tuple, list)):
        sections = [int(s) for s in sections]
        n_out = len(sections)
    else:
        sections = int(sections)
        shape = _node_shape(src)
        if not shape:
            raise TorchExportError(
                f"split at {node.name!r}: int split_size needs a "
                f"propagated input shape")
        n_out = -(-shape[dim] // sections)
    op = b.add_op("torch.split", name, [src], out_node=None, n_out=n_out)
    _param(op, "split_size_or_sections", sections)
    _param(op, "dim", dim)
    tms = node.meta.get("tensor_meta")
    if tms is not None:
        for r, tm in zip(op.outputs, tms):
            r.shape = list(tm.shape)
    b.operand_of[node.name] = op.outputs[0]


def _export_chunk(b, node, name):
    """torch.chunk / Tensor.chunk -> multi-output torch.chunk op; the
    following getitem nodes alias the individual outputs."""
    chunks = int(node.args[1] if len(node.args) > 1
                 else node.kwargs["chunks"])
    dim = int(node.args[2] if len(node.args) > 2
              else node.kwargs.get("dim", 0))
    # torch returns FEWER than `chunks` when ceil-splitting exhausts the
    # dim early (chunk(5-wide, 4) -> 3 chunks of (2,2,1)); the actual
    # count comes from the propagated shape
    shape = _node_shape(node.args[0])
    n_out = chunks
    if shape:
        size = shape[dim + len(shape) if dim < 0 else dim]
        per = -(-size // chunks)
        n_out = -(-size // per)
    op = b.add_op("torch.chunk", name, [node.args[0]], out_node=None,
                  n_out=n_out)
    _param(op, "chunks", chunks)
    _param(op, "dim", dim)
    tms = node.meta.get("tensor_meta")
    if tms is not None:
        for r, tm in zip(op.outputs, tms):
            r.shape = list(tm.shape)
    # getitem resolves via .producer on any of the outputs
    b.operand_of[node.name] = op.outputs[0]


_INT_MAX = 2**63 - 1


def _export_slice(b, node, src, index, name):
    """x[slices] -> Tensor.slice (folded dims/starts/ends/steps form,
    the newer-pnnx encoding ops/functional.py also parses)."""
    rank = len(_node_shape(src)) or None
    items = list(index) if isinstance(index, tuple) else [index]
    if Ellipsis in items:
        if rank is None:
            raise TorchExportError(
                f"slice at {node.name!r}: Ellipsis needs a known input "
                f"rank (shape propagation missed this node)")
        k = items.index(Ellipsis)
        fill = rank - (len(items) - 1)
        items = items[:k] + [slice(None)] * fill + items[k + 1:]
    dims, starts, ends, steps = [], [], [], []
    for d, it in enumerate(items):
        if not isinstance(it, slice):
            raise TorchExportError(
                f"slice at {node.name!r}: only slice components are "
                f"supported, got {it!r} (rank-reducing int indexing is "
                f"not)")
        if it == slice(None):
            continue
        step = 1 if it.step is None else int(it.step)
        if step <= 0:
            raise TorchExportError(
                f"slice at {node.name!r}: non-positive step {step}")
        dims.append(d)
        starts.append(0 if it.start is None else int(it.start))
        ends.append(_INT_MAX if it.stop is None else int(it.stop))
        steps.append(step)
    if not dims:  # x[:] / x[...] — pure alias
        b.operand_of[node.name] = b.operand_of[src.name]
        return
    op = b.add_op("Tensor.slice", name, [src], node)
    _param(op, "dims", dims)
    _param(op, "starts", starts)
    _param(op, "ends", ends)
    _param(op, "steps", steps)


def _export_reduce(b, node, typ, name):
    dims = (node.args[1] if len(node.args) > 1
            else node.kwargs.get("dim"))
    if dims is None:
        raise TorchExportError(
            f"{typ} without dim at {node.name!r} is not supported "
            f"(full reduction loses the layout contract)")
    dims = [int(dims)] if isinstance(dims, int) else [int(d)
                                                      for d in dims]
    op = b.add_op(typ, name, [node.args[0]], node)
    _param(op, "dim", dims)
    _param(op, "keepdim", bool(node.kwargs.get(
        "keepdim", node.args[2] if len(node.args) > 2 else False)))


def _export_method(b, node, name):
    mname = node.target
    act = {"relu": "nn.ReLU", "sigmoid": "nn.Sigmoid",
           "tanh": "nn.Tanh"}.get(mname)
    if act:
        b.add_op(act, name, [node.args[0]], node)
        return
    if mname in ("add", "mul", "sub", "div"):
        code = {"add": 0, "sub": 1, "mul": 2, "div": 3}[mname]
        _export_binary(b, node, code, node.args[0], node.args[1], name)
        return
    if mname == "flatten":
        _export_flatten(b, node, name)
        return
    if mname in ("view", "reshape"):
        raw = (node.args[1] if isinstance(node.args[1], (tuple, list))
               else node.args[1:])
        shape = [s if isinstance(s, int)
                 else _static_int(b, s, f".{mname}() at {node.name!r}")
                 for s in raw]
        op = b.add_op("Tensor.reshape", name, [node.args[0]], node)
        _param(op, "shape", [int(s) for s in shape])
        return
    if mname == "permute":
        dims = node.args[1:] if not isinstance(
            node.args[1], (tuple, list)) else node.args[1]
        op = b.add_op("torch.permute", name, [node.args[0]], node)
        _param(op, "dims", [int(d) for d in dims])
        return
    if mname == "chunk":
        _export_chunk(b, node, name)
        return
    if mname == "split":
        _export_split(b, node, name)
        return
    if mname in ("sum", "amax", "mean"):
        _export_reduce(b, node, {"sum": "torch.sum", "amax": "torch.amax",
                                 "mean": "torch.mean"}[mname], name)
        return
    if mname in ("contiguous", "clone", "detach"):
        b.operand_of[node.name] = b.operand_of[node.args[0].name]
        return
    if mname == "expand":
        shape = (node.args[1] if isinstance(node.args[1], (tuple, list))
                 else node.args[1:])
        shape = [s if isinstance(s, int)
                 else _static_int(b, s, f".expand() at {node.name!r}")
                 for s in shape]
        op = b.add_op("Tensor.expand", name, [node.args[0]], node)
        _param(op, "shape", [int(s) for s in shape])
        return
    if mname == "size":
        src_shape = list(_node_shape(node.args[0]))
        b.const_of[node.name] = (src_shape[int(node.args[1])]
                                 if len(node.args) > 1 else src_shape)
        return
    if mname == "transpose":
        op = b.add_op("torch.transpose", name, [node.args[0]], node)
        _param(op, "dim0", int(node.args[1]))
        _param(op, "dim1", int(node.args[2]))
        return
    if mname == "select":
        op = b.add_op("torch.select", name, [node.args[0]], node)
        _param(op, "dim", int(node.args[1]))
        _param(op, "index", int(node.args[2]))
        return
    if mname in ("matmul", "bmm"):
        b.add_op(f"torch.{mname}", name, [node.args[0], node.args[1]],
                 node)
        return
    raise TorchExportError(f"unsupported method .{mname}() at node "
                           f"{node.name!r}")


def _module_place(module) -> tuple:
    """(device, floating dtype) of the module's first floating parameter
    or buffer; the CPU and float32 for a module that holds none."""
    for t in (*module.parameters(), *module.buffers()):
        if t.is_floating_point():
            return t.device, t.dtype
    return torch.device("cpu"), torch.float32


def export_torch(module, example_input) -> tuple:
    """Trace `module` (eval-mode torch.nn.Module) and return
    (Graph, input_name, output_name). Multi-input modules pass a
    tuple/list of example arrays (numpy or torch) and get a list of
    input names back; multi-output modules return a list as the third
    element (the reference engine's N-ary Input/Extract surface).

    The examples run through the module on the module's own device (a
    module on the card propagates its shapes there), floats at the
    module's floating dtype and integers (Embedding indices) as they
    are. A shape that does not propagate raises TorchExportError."""
    from torch.fx.passes.shape_prop import ShapeProp

    module = module.eval()
    gm = torch.fx.symbolic_trace(module)
    multi_in = isinstance(example_input, (tuple, list))
    device, fdtype = _module_place(module)

    def _ex(e):
        x = e if isinstance(e, torch.Tensor) else torch.as_tensor(
            np.asarray(e))
        # keep integer feeds integral (Embedding indices)
        if x.is_floating_point() or x.dtype == torch.bool:
            x = x.to(fdtype)
        return x.to(device)

    examples = [_ex(e)
                for e in (example_input if multi_in else [example_input])]
    try:
        with torch.no_grad():
            ShapeProp(gm).propagate(*examples)
    except RuntimeError as e:
        raise TorchExportError(
            f"example input mismatch on {device}: {e} (multi-input "
            f"modules take a tuple/list of example arrays)") from e

    b = _Builder()
    modules = dict(gm.named_modules())
    input_names, output_names = [], []
    for node in gm.graph.nodes:
        name = node.name
        if node.op == "placeholder":
            op = b.g.new_operator("pnnx.Input", name)
            r = b.g.new_operand(name)
            r.producer = op
            r.type = 1
            r.shape = _node_shape(node)
            op.outputs.append(r)
            b.operand_of[name] = r
            input_names.append(name)
        elif node.op == "get_attr":
            t = gm
            for part in node.target.split("."):
                t = getattr(t, part)
            op = b.add_op("pnnx.Attribute", name, [], node)
            _attr(op, "data", t)
            op.outputs[0].shape = list(t.shape)
        elif node.op == "call_module":
            _export_module(b, node, modules[node.target], name)
        elif node.op == "call_function":
            if node.target is getattr:
                # x.shape traces as getattr(x, "shape"); resolve it to
                # the static shape ShapeProp recorded
                if node.args[1] == "shape":
                    b.const_of[name] = list(_node_shape(node.args[0]))
                    continue
                raise TorchExportError(
                    f"unsupported getattr {node.args[1]!r} at {name!r}")
            if node.target is operator.getitem:
                src, j = node.args
                if src.name in b.const_of:
                    # static shape-tuple indexing: x.shape[0]
                    b.const_of[name] = b.const_of[src.name][j]
                    continue
                # Two supported forms: select-one-output-of-a-multi-
                # output-op (chunk/split/attention), and basic slicing
                # (x[:, 1:, ::2] -> Tensor.slice). Rank-reducing int
                # indexing (x[0]) must raise, not silently alias.
                if isinstance(j, (slice, tuple)) and not isinstance(
                        j, int):
                    _export_slice(b, node, src, j, name)
                    continue
                producer = b.operand_of[src.name].producer
                if (producer is None
                        or len(producer.outputs) < 2
                        or not isinstance(j, int)
                        or j >= len(producer.outputs)):
                    raise TorchExportError(
                        f"getitem at {name!r}: only selecting an output "
                        f"of a multi-output op (chunk/split/attention) "
                        f"or basic slicing is supported (rank-reducing "
                        f"int indexing is not)")
                b.operand_of[name] = producer.outputs[j]
            else:
                _export_function(b, node, name)
        elif node.op == "call_method":
            _export_method(b, node, name)
        elif node.op == "output":
            args = node.args[0]
            outs = list(args) if isinstance(args, (tuple, list)) else [args]
            op = b.g.new_operator("pnnx.Output", "out0")
            for nd in outs:
                r = b.operand_of[nd.name]
                r.consumers.append(op)
                op.inputs.append(r)
                output_names.append(r.name)
        else:  # pragma: no cover
            raise TorchExportError(f"unknown fx op {node.op}")

    if len(input_names) != len(examples):
        raise TorchExportError(
            f"expected {len(examples)} example input(s) for placeholders "
            f"{input_names}")
    inp = input_names if multi_in else input_names[0]
    out = output_names if len(output_names) > 1 else output_names[0]
    return b.g, inp, out
