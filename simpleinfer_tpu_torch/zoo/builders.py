"""Programmatic pnnx graph builders: the YOLOv5, YOLOv8, CNN
classification / segmentation, transformer (ViT, BERT) and causal-LM
(GPT, NeoX, BLOOM, llama) families, ported subset.

A copy of `GraphBuilder` (the layers those families use), `build_yolov5`,
`build_yolov8`, `build_resnet18`, `build_resnet50`, `build_mobilenet_like`,
`build_densenet`, `build_unet`, `VIT_PRESETS` / `build_vit`,
`BERT_PRESETS` / `build_bert`, `GPT_PRESETS` / `build_gpt`,
`NEOX_PRESETS` / `build_neox`, `BLOOM_PRESETS` / `build_bloom` and
`LLAMA_PRESETS` / `build_llama` from simpleinfer_tpu/zoo/builders.py
(numpy only), so the port builds the same graphs with the same seeded
weights (the same RNG calls in the same order) without importing the JAX
package. The YOLOv5 Detect attrs follow the pnnx numbering (strides in
``pnnx_5``, anchor grids in ``pnnx_{4,2,0}``, grids in ``pnnx_{6,3,1}``,
head convs in ``m.{0,1,2}.weight/bias``).

Residual adds are emitted as fused ``pnnx.Expression add(@0,@1)`` ops so
every loaded model also exercises the expression-expansion pass, like a
real pnnx export of torch `a + b` would.
"""
from __future__ import annotations

import math

import numpy as np

from ..ir.graph import Attribute, Graph, Parameter

# standard YOLOv5 anchors (wh pairs) per level P3/8, P4/16, P5/32
YOLO_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
YOLO_STRIDES = (8, 16, 32)


class GraphBuilder:
    """Tiny functional-style builder over ir.Graph with shape inference.

    Methods take/return operand names; shapes are tracked in NCHW (the
    pnnx on-disk convention — the engine converts to NHWC at load, like
    engine_impl.cpp:182-189).
    """

    def __init__(self, seed: int = 0):
        self.g = Graph()
        self.rng = np.random.default_rng(seed)
        self.shape: dict[str, list] = {}
        self._n = 0

    # ---- plumbing ------------------------------------------------------
    def _name(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    def _op(self, type_: str, name: str, inputs: list, n_out: int = 1,
            params: dict | None = None, attrs: dict | None = None) -> list:
        op = self.g.new_operator(type_, name)
        for i in inputs:
            r = self.g.get_or_create_operand(i)
            r.consumers.append(op)
            op.inputs.append(r)
        outs = []
        for j in range(n_out):
            r = self.g.new_operand(f"{name}_out{j}" if n_out > 1
                                   else f"{name}_out")
            r.producer = op
            op.outputs.append(r)
            outs.append(r.name)
        for k, v in (params or {}).items():
            op.params[k] = Parameter.from_value(v)
        for k, v in (attrs or {}).items():
            op.attrs[k] = Attribute.from_array(np.ascontiguousarray(v))
        return outs

    def _rand(self, shape, fan_in: float | None = None) -> np.ndarray:
        """He-style init so deep nets keep unit-scale activations (keeps
        fp32-vs-oracle tolerances meaningful through 100+ layer nets)."""
        w = self.rng.standard_normal(shape).astype(np.float32)
        if fan_in:
            w *= math.sqrt(2.0 / fan_in)
        return w

    # ---- graph I/O -------------------------------------------------------
    def input(self, shape_nchw, name: str | None = None) -> str:
        opname = name or self._name("in")
        op = self.g.new_operator("pnnx.Input", opname)
        r = self.g.new_operand(opname if name else f"{opname}_out")
        r.producer = op
        r.shape = list(shape_nchw)
        r.type = 1  # f32
        op.outputs.append(r)
        self.shape[r.name] = list(shape_nchw)
        return r.name

    def output(self, *xs: str) -> None:
        op = self.g.new_operator("pnnx.Output", self._name("out"))
        for x in xs:
            r = self.g.get_or_create_operand(x)
            r.consumers.append(op)
            op.inputs.append(r)

    def build(self) -> Graph:
        return self.g

    # ---- layers ---------------------------------------------------------
    def conv(self, x: str, out_c: int, k: int = 1, s: int = 1,
             p: int | None = None, d: int = 1, groups: int = 1,
             bias: bool = True) -> str:
        n, c, h, w = self.shape[x]
        if p is None:
            p = (d * (k - 1)) // 2  # "same"-ish autopad, like yolov5
        name = self._name("conv")
        attrs = {"weight": self._rand((out_c, c // groups, k, k),
                                      fan_in=(c // groups) * k * k)}
        if bias:
            attrs["bias"] = (self.rng.standard_normal(out_c)
                             .astype(np.float32) * 0.05)
        (out,) = self._op("nn.Conv2d", name, [x], params=dict(
            bias=bias, dilation=[d, d], groups=groups, in_channels=c,
            kernel_size=[k, k], out_channels=out_c, padding=[p, p],
            padding_mode="zeros", stride=[s, s]), attrs=attrs)
        oh = (h + 2 * p - d * (k - 1) - 1) // s + 1
        ow = (w + 2 * p - d * (k - 1) - 1) // s + 1
        self.shape[out] = [n, out_c, oh, ow]
        return out

    def bn(self, x: str) -> str:
        n, c, h, w = self.shape[x]
        name = self._name("bn")
        (out,) = self._op("nn.BatchNorm2d", name, [x], params=dict(
            affine=True, eps=1e-5, num_features=c), attrs={
            "running_mean": self.rng.standard_normal(c).astype(np.float32) * 0.1,
            "running_var": (self.rng.uniform(0.5, 1.5, c)).astype(np.float32),
            "weight": (1.0 + 0.1 * self.rng.standard_normal(c)).astype(np.float32),
            "bias": self.rng.standard_normal(c).astype(np.float32) * 0.1,
        })
        self.shape[out] = [n, c, h, w]
        return out

    def _act(self, type_: str, x: str) -> str:
        (out,) = self._op(type_, self._name(type_.split(".")[-1].lower()), [x])
        self.shape[out] = list(self.shape[x])
        return out

    def relu(self, x: str) -> str:
        return self._act("nn.ReLU", x)

    def silu(self, x: str) -> str:
        return self._act("nn.SiLU", x)

    def sigmoid(self, x: str) -> str:
        return self._act("nn.Sigmoid", x)

    def hardswish(self, x: str) -> str:
        return self._act("nn.Hardswish", x)

    def hardsigmoid(self, x: str) -> str:
        return self._act("nn.Hardsigmoid", x)

    def maxpool(self, x: str, k: int, s: int | None = None,
                p: int = 0) -> str:
        s = s or k
        n, c, h, w = self.shape[x]
        (out,) = self._op("nn.MaxPool2d", self._name("maxpool"), [x],
                          params=dict(ceil_mode=False, dilation=[1, 1],
                                      kernel_size=[k, k], padding=[p, p],
                                      return_indices=False, stride=[s, s]))
        oh = (h + 2 * p - k) // s + 1
        ow = (w + 2 * p - k) // s + 1
        self.shape[out] = [n, c, oh, ow]
        return out

    def upsample(self, x: str, scale: float = 2.0) -> str:
        n, c, h, w = self.shape[x]
        (out,) = self._op("nn.Upsample", self._name("up"), [x], params=dict(
            mode="nearest", scale_factor=[float(scale), float(scale)]))
        self.shape[out] = [n, c, int(h * scale), int(w * scale)]
        return out

    def cat(self, xs: list, dim: int = 1) -> str:
        (out,) = self._op("torch.cat", self._name("cat"), list(xs),
                          params=dict(dim=dim))
        s = list(self.shape[xs[0]])
        s[dim] = sum(self.shape[x][dim] for x in xs)
        self.shape[out] = s
        return out

    def add(self, a: str, b: str) -> str:
        """Residual add as a fused pnnx.Expression (like a pnnx export)."""
        (out,) = self._op("pnnx.Expression", self._name("expr"), [a, b],
                          params=dict(expr="add(@0,@1)"))
        self.shape[out] = list(self.shape[a])
        return out

    def mul(self, a: str, b: str) -> str:
        (out,) = self._op("pnnx.Expression", self._name("expr"), [a, b],
                          params=dict(expr="mul(@0,@1)"))
        sa, sb = self.shape[a], self.shape[b]
        self.shape[out] = list(np.broadcast_shapes(tuple(sa), tuple(sb)))
        return out

    def linear(self, x: str, out_f: int, bias: bool = True) -> str:
        in_f = self.shape[x][-1]
        attrs = {"weight": self._rand((out_f, in_f), fan_in=in_f)}
        if bias:
            attrs["bias"] = (self.rng.standard_normal(out_f)
                             .astype(np.float32) * 0.05)
        (out,) = self._op("nn.Linear", self._name("fc"), [x], params=dict(
            bias=bias, in_features=in_f, out_features=out_f), attrs=attrs)
        self.shape[out] = self.shape[x][:-1] + [out_f]
        return out

    def rms_norm(self, x: str, affine: bool = True) -> str:
        e = self.shape[x][-1]
        name = self._name("rms")
        attrs = {}
        if affine:
            attrs["weight"] = np.ones(e, np.float32) + (
                self.rng.standard_normal(e).astype(np.float32) * 0.02)
        (out,) = self._op("nn.RMSNorm", name, [x], params=dict(
            normalized_shape=[e], eps=1e-6, elementwise_affine=affine),
            attrs=attrs)
        self.shape[out] = list(self.shape[x])
        return out

    def silu_act(self, x: str) -> str:
        return self._act("nn.SiLU", x)

    def rotary_attention(self, x: str, num_heads: int,
                         num_kv_heads: int | None = None,
                         rope_theta: float = 10000.0,
                         bias: bool = False,
                         sliding_window: int | None = None,
                         head_dim: int | None = None,
                         qk_norm: bool = False,
                         qk_norm_eps: float = 1e-6,
                         attn_scale: float | None = None,
                         logit_softcap: float | None = None,
                         rotary_dim: int | None = None,
                         rope_interleaved: bool = False,
                         alibi: bool = False,
                         alibi_scale: float | None = None,
                         alibi_slopes=None,
                         o_bias: bool = False) -> str:
        """Llama-style causal self-attention (si.RotaryAttention
        composite, ops/attention.py): RoPE + GQA, intrinsic causal mask,
        llama checkpoint weight layout; head_dim decouples the per-head
        width and qk_norm adds per-head q/k RMSNorm (qwen3-family);
        sliding_window bands the mask (mistral), logit_softcap caps the
        logits (gemma2) and alibi replaces RoPE by linear key-position
        slopes (BLOOM / MPT)."""
        e = self.shape[x][-1]
        kv = num_kv_heads or num_heads
        d = head_dim or e // num_heads
        name = self._name("rattn")
        attrs = {
            "q_proj.weight": self._rand((num_heads * d, e), fan_in=e),
            "k_proj.weight": self._rand((kv * d, e), fan_in=e),
            "v_proj.weight": self._rand((kv * d, e), fan_in=e),
            "o_proj.weight": self._rand((e, num_heads * d),
                                        fan_in=num_heads * d),
        }
        if bias:
            for k in ("q", "k", "v"):
                heads = num_heads if k == "q" else kv
                attrs[f"{k}_proj.bias"] = (
                    self.rng.standard_normal(heads * d)
                    .astype(np.float32) * 0.02)
        if o_bias:
            attrs["o_proj.bias"] = (self.rng.standard_normal(e)
                                    .astype(np.float32) * 0.02)
        if qk_norm:
            attrs["q_norm.weight"] = 1.0 + (
                self.rng.standard_normal(d).astype(np.float32) * 0.1)
            attrs["k_norm.weight"] = 1.0 + (
                self.rng.standard_normal(d).astype(np.float32) * 0.1)
        params = dict(embed_dim=e, num_heads=num_heads, num_kv_heads=kv,
                      rope_theta=rope_theta, bias=bias)
        if head_dim is not None:
            params["head_dim"] = int(head_dim)
        if qk_norm:
            params["qk_norm_eps"] = float(qk_norm_eps)
        if attn_scale is not None:
            params["attn_scale"] = float(attn_scale)
        if logit_softcap is not None:
            params["logit_softcap"] = float(logit_softcap)
        if sliding_window is not None:
            params["sliding_window"] = int(sliding_window)
        if rotary_dim is not None:
            params["rotary_dim"] = int(rotary_dim)
        if rope_interleaved:
            params["rope_interleaved"] = 1
        if alibi:
            params["alibi"] = 1
            if alibi_scale is not None:
                params["alibi_scale"] = float(alibi_scale)
            if alibi_slopes is not None:
                attrs["alibi_slopes"] = np.asarray(alibi_slopes,
                                                   np.float32)
        (out,) = self._op("si.RotaryAttention", name, [x], params=params,
                          attrs=attrs)
        self.shape[out] = list(self.shape[x])
        return out

    def embedding(self, idx: str, num_embeddings: int,
                  embedding_dim: int) -> str:
        name = self._name("emb")
        (out,) = self._op("nn.Embedding", name, [idx], params=dict(
            num_embeddings=num_embeddings, embedding_dim=embedding_dim,
            sparse=False), attrs={
            "weight": self._rand((num_embeddings, embedding_dim)) * 0.05})
        self.shape[out] = list(self.shape[idx]) + [embedding_dim]
        return out

    def gelu(self, x: str, approximate: str | None = None) -> str:
        out = self._act("nn.GELU", x)
        if approximate is not None:     # pnnx/torch "tanh" variant
            self.g.get_operand(out).producer.params["approximate"] = \
                Parameter.from_value(approximate)
        return out

    def permute(self, x: str, dims: list) -> str:
        (out,) = self._op("torch.permute", self._name("perm"), [x],
                          params=dict(dims=list(dims)))
        s = self.shape[x]
        self.shape[out] = [s[d] for d in dims]
        return out

    def layer_norm(self, x: str, nd: int = 1, affine: bool = True) -> str:
        """LayerNorm over the trailing `nd` logical dims."""
        shape = self.shape[x][-nd:]
        name = self._name("ln")
        attrs = {}
        if affine:
            attrs["weight"] = (1.0 + 0.1 * self.rng.standard_normal(shape)
                               ).astype(np.float32)
            attrs["bias"] = (self.rng.standard_normal(shape)
                             .astype(np.float32) * 0.1)
        (out,) = self._op("nn.LayerNorm", name, [x], params=dict(
            elementwise_affine=affine, eps=1e-6,
            normalized_shape=[int(d) for d in shape]), attrs=attrs)
        self.shape[out] = list(self.shape[x])
        return out

    def conv_transpose(self, x: str, out_c: int, k: int = 2,
                       s: int = 2, p: int = 0) -> str:
        n, c, h, w = self.shape[x]
        name = self._name("convt")
        attrs = {"weight": self._rand((c, out_c, k, k), fan_in=c * k * k),
                 "bias": (self.rng.standard_normal(out_c)
                          .astype(np.float32) * 0.05)}
        (out,) = self._op("nn.ConvTranspose2d", name, [x], params=dict(
            bias=True, dilation=[1, 1], groups=1, in_channels=c,
            kernel_size=[k, k], out_channels=out_c,
            output_padding=[0, 0], padding=[p, p], stride=[s, s]),
            attrs=attrs)
        oh = (h - 1) * s - 2 * p + k
        ow = (w - 1) * s - 2 * p + k
        self.shape[out] = [n, out_c, oh, ow]
        return out

    def avgpool(self, x: str, k: int, s: int | None = None,
                p: int = 0) -> str:
        s = s or k
        n, c, h, w = self.shape[x]
        (out,) = self._op("nn.AvgPool2d", self._name("avgpool"), [x],
                          params=dict(ceil_mode=False,
                                      count_include_pad=True,
                                      kernel_size=[k, k], padding=[p, p],
                                      stride=[s, s]))
        oh = (h + 2 * p - k) // s + 1
        ow = (w + 2 * p - k) // s + 1
        self.shape[out] = [n, c, oh, ow]
        return out

    def adaptive_avg_pool(self, x: str, size: int = 1) -> str:
        n, c, h, w = self.shape[x]
        (out,) = self._op("nn.AdaptiveAvgPool2d", self._name("gap"), [x],
                          params=dict(output_size=[size, size]))
        self.shape[out] = [n, c, size, size]
        return out

    def flatten(self, x: str) -> str:
        (out,) = self._op("torch.flatten", self._name("flat"), [x],
                          params=dict(start_dim=1, end_dim=-1))
        s = self.shape[x]
        self.shape[out] = [s[0], int(np.prod(s[1:]))]
        return out

    def chunk(self, x: str, chunks: int, dim: int = 1) -> list:
        n_out = chunks
        outs = self._op("torch.chunk", self._name("chunk"), [x],
                        n_out=n_out, params=dict(chunks=chunks, dim=dim))
        s = list(self.shape[x])
        per = -(-s[dim] // chunks)
        for j, o in enumerate(outs):
            so = list(s)
            so[dim] = min(per, s[dim] - j * per)
            self.shape[o] = so
        return outs

    def attr_const(self, value: np.ndarray) -> str:
        """Constant tensor as a pnnx.Attribute op (what real pnnx exports
        emit for cls tokens / position embeddings)."""
        name = self._name("const")
        (out,) = self._op("pnnx.Attribute", name, [],
                          attrs={"data": np.asarray(value, np.float32)})
        self.shape[out] = list(np.asarray(value).shape)
        return out

    def transpose(self, x: str, d0: int, d1: int) -> str:
        (out,) = self._op("torch.transpose", self._name("tr"), [x],
                          params=dict(dim0=d0, dim1=d1))
        s = list(self.shape[x])
        s[d0], s[d1] = s[d1], s[d0]
        self.shape[out] = s
        return out

    def reshape(self, x: str, shape: list) -> str:
        (out,) = self._op("torch.reshape", self._name("rs"), [x],
                          params=dict(shape=[int(d) for d in shape]))
        self.shape[out] = [int(d) for d in shape]
        return out

    def select(self, x: str, dim: int, index: int) -> str:
        (out,) = self._op("torch.select", self._name("sel"), [x],
                          params=dict(dim=dim, index=index))
        s = list(self.shape[x])
        del s[dim]
        self.shape[out] = s
        return out

    def expand(self, x: str, shape: list) -> str:
        (out,) = self._op("Tensor.expand", self._name("exp"), [x],
                          params=dict(shape=[int(d) for d in shape]))
        self.shape[out] = [int(d) for d in shape]
        return out

    def mha(self, x: str, num_heads: int, mask: str | None = None) -> str:
        """Self-attention nn.MultiheadAttention (batch_first, packed
        in_proj) on [N, L, E]; optional additive attn_mask operand (a
        causal upper triangle from attr_const)."""
        e = self.shape[x][-1]
        name = self._name("mha")
        attrs = {
            "in_proj_weight": self._rand((3 * e, e), fan_in=e),
            "in_proj_bias": (self.rng.standard_normal(3 * e)
                             .astype(np.float32) * 0.02),
            "out_proj.weight": self._rand((e, e), fan_in=e),
            "out_proj.bias": (self.rng.standard_normal(e)
                              .astype(np.float32) * 0.02),
        }
        inputs = [x] if mask is None else [x, mask]
        (out,) = self._op("nn.MultiheadAttention", name, inputs,
                          params=dict(
            embed_dim=e, num_heads=num_heads, batch_first=True,
            add_zero_attn=False, add_bias_kv=False, bias=True),
            attrs=attrs)
        self.shape[out] = list(self.shape[x])
        return out

    def tanh(self, x: str) -> str:
        return self._act("nn.Tanh", x)

    def yolo_detect_v8(self, features: list, nc: int = 80,
                       reg_max: int = 16,
                       strides=(8.0, 16.0, 32.0)) -> str:
        """Anchor-free YOLOv8 decode head (models.yolo.DetectV8): each
        input is a per-level [N, 4*reg_max+nc, H, W] prediction map."""
        (out,) = self._op(
            "models.yolo.DetectV8", self._name("detectv8"),
            list(features),
            params=dict(nc=nc, reg_max=reg_max),
            attrs={"strides": np.asarray(strides, np.float32)})
        n = self.shape[features[0]][0]
        total = sum(self.shape[f][2] * self.shape[f][3] for f in features)
        self.shape[out] = [n, total, 4 + nc]
        return out

    def yolo_detect(self, features: list, nc: int = 80,
                    anchors=YOLO_ANCHORS, strides=YOLO_STRIDES) -> str:
        na = len(anchors[0])
        no = nc + 5
        attrs: dict = {"pnnx_5": np.asarray(strides, dtype=np.float32)}
        anchor_idx, grid_idx = (4, 2, 0), (6, 3, 1)
        for i, f in enumerate(features):
            n, c, h, w = self.shape[f]
            attrs[f"m.{i}.weight"] = self._rand((na * no, c, 1, 1), fan_in=c)
            attrs[f"m.{i}.bias"] = (self.rng.standard_normal(na * no)
                                    .astype(np.float32) * 0.05)
            # grid [1,A,H,W,2] = (x,y) cell coords - 0.5 (yolov5 v6 offset)
            xv, yv = np.meshgrid(np.arange(w), np.arange(h))
            grid = np.stack([xv, yv], axis=-1).astype(np.float32) - 0.5
            grid = np.broadcast_to(grid[None, None], (1, na, h, w, 2))
            attrs[f"pnnx_{grid_idx[i]}"] = np.ascontiguousarray(grid)
            # anchor grid [1,A,H,W,2] = anchor wh broadcast over the cells
            ag = np.asarray(anchors[i], dtype=np.float32).reshape(1, na, 1, 1, 2)
            ag = np.broadcast_to(ag, (1, na, h, w, 2))
            attrs[f"pnnx_{anchor_idx[i]}"] = np.ascontiguousarray(ag)
        (out,) = self._op("models.yolo.Detect", self._name("detect"),
                          list(features), attrs=attrs)
        n = self.shape[features[0]][0]
        total = sum(na * self.shape[f][2] * self.shape[f][3]
                    for f in features)
        self.shape[out] = [n, total, no]
        return out


def _yolo_channels(width_mult: float):
    def cw(ch):
        return max(int(round(ch * width_mult / 8)) * 8, 8)
    return cw


def build_yolov5(variant: str = "n", batch: int = 1, image_size: int = 640,
                 num_classes: int = 80, seed: int = 0) -> tuple:
    """YOLOv5 (v6.0 topology: 6x6 stem, C3 blocks, SPPF, PAN head,
    fused Detect). variant: n / s / m / l / x or (depth_mult, width_mult).

    Structure per ultralytics yolov5 v6 yaml; all convs carry bias (a
    pnnx export folds BN into the conv, which is also what the
    reference's yolov5 fixtures contain — their graphs have no separate
    BN ops, see the conv+silu pairs in test-yolo2's operand dump).
    """
    presets = {"n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
               "l": (1.0, 1.0), "x": (1.33, 1.25)}
    depth_mult, width_mult = presets[variant] if isinstance(variant, str) \
        else variant
    cw = _yolo_channels(width_mult)

    def dn(n):
        return max(round(n * depth_mult), 1)

    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def conv_silu(x, out_c, k=1, s=1, p=None, groups=1):
        return b.silu(b.conv(x, out_c, k, s, p, groups=groups))

    def bottleneck(x, out_c, shortcut=True):
        in_c = b.shape[x][1]
        y = conv_silu(x, out_c // 1, 1)
        y = conv_silu(y, out_c, 3)
        if shortcut and in_c == out_c:
            return b.add(y, x)
        return y

    def c3(x, out_c, n=1, shortcut=True):
        hid = out_c // 2
        y1 = conv_silu(x, hid, 1)
        for _ in range(n):
            y1 = bottleneck(y1, hid, shortcut)
        y2 = conv_silu(x, hid, 1)
        return conv_silu(b.cat([y1, y2], 1), out_c, 1)

    def sppf(x, out_c, k=5):
        hid = b.shape[x][1] // 2
        y = conv_silu(x, hid, 1)
        p1 = b.maxpool(y, k, 1, k // 2)
        p2 = b.maxpool(p1, k, 1, k // 2)
        p3 = b.maxpool(p2, k, 1, k // 2)
        return conv_silu(b.cat([y, p1, p2, p3], 1), out_c, 1)

    # backbone
    x = conv_silu(x, cw(64), 6, 2, 2)          # P1/2
    x = conv_silu(x, cw(128), 3, 2)            # P2/4
    x = c3(x, cw(128), dn(3))
    x = conv_silu(x, cw(256), 3, 2)            # P3/8
    p3 = c3(x, cw(256), dn(6))
    x = conv_silu(p3, cw(512), 3, 2)           # P4/16
    p4 = c3(x, cw(512), dn(9))
    x = conv_silu(p4, cw(1024), 3, 2)          # P5/32
    x = c3(x, cw(1024), dn(3))
    p5 = sppf(x, cw(1024))

    # PAN head
    h1 = conv_silu(p5, cw(512), 1)
    x = b.cat([b.upsample(h1, 2), p4], 1)
    x = c3(x, cw(512), dn(3), shortcut=False)
    h2 = conv_silu(x, cw(256), 1)
    x = b.cat([b.upsample(h2, 2), p3], 1)
    d3 = c3(x, cw(256), dn(3), shortcut=False)          # P3 out
    x = conv_silu(d3, cw(256), 3, 2)
    x = b.cat([x, h2], 1)
    d4 = c3(x, cw(512), dn(3), shortcut=False)          # P4 out
    x = conv_silu(d4, cw(512), 3, 2)
    x = b.cat([x, h1], 1)
    d5 = c3(x, cw(1024), dn(3), shortcut=False)         # P5 out

    out = b.yolo_detect([d3, d4, d5], nc=num_classes)
    b.output(out)
    return b.build(), "0", out


# ---- the CNN classification and segmentation family ----
def build_yolov8(variant: str = "n", batch: int = 1, image_size: int = 640,
                 num_classes: int = 80, reg_max: int = 16,
                 seed: int = 0) -> tuple:
    """YOLOv8-style detector: C2f blocks (chunk + growing concat), SPPF,
    PAN neck, anchor-free decoupled head with DFL decode
    (models.yolo.DetectV8). A model FAMILY the CPU reference cannot run
    (its registry has no chunk/DFL ops) — superset capability.
    variant: n / s / m / l or (depth_mult, width_mult)."""
    presets = {"n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
               "l": (1.0, 1.0)}
    depth_mult, width_mult = presets[variant] if isinstance(variant, str) \
        else variant
    cw = _yolo_channels(width_mult)

    def dn(n):
        return max(round(n * depth_mult), 1)

    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def conv_silu(x, out_c, k=1, s=1, p=None):
        return b.silu(b.conv(x, out_c, k, s, p))

    def bottleneck(x, out_c, shortcut=True):
        in_c = b.shape[x][1]
        y = conv_silu(x, out_c, 3)
        y = conv_silu(y, out_c, 3)
        if shortcut and in_c == out_c:
            return b.add(y, x)
        return y

    def c2f(x, out_c, n=1, shortcut=True):
        hid = out_c // 2
        y = conv_silu(x, out_c, 1)
        a, c = b.chunk(y, 2, dim=1)
        parts = [a, c]
        for _ in range(n):
            c = bottleneck(c, hid, shortcut)
            parts.append(c)
        return conv_silu(b.cat(parts, 1), out_c, 1)

    def sppf(x, out_c, k=5):
        hid = b.shape[x][1] // 2
        y = conv_silu(x, hid, 1)
        p1 = b.maxpool(y, k, 1, k // 2)
        p2 = b.maxpool(p1, k, 1, k // 2)
        p3 = b.maxpool(p2, k, 1, k // 2)
        return conv_silu(b.cat([y, p1, p2, p3], 1), out_c, 1)

    # backbone (v8 yaml: 3x3 s2 stem, C2f stages)
    x = conv_silu(x, cw(64), 3, 2)              # P1/2
    x = conv_silu(x, cw(128), 3, 2)             # P2/4
    x = c2f(x, cw(128), dn(3))
    x = conv_silu(x, cw(256), 3, 2)             # P3/8
    p3 = c2f(x, cw(256), dn(6))
    x = conv_silu(p3, cw(512), 3, 2)            # P4/16
    p4 = c2f(x, cw(512), dn(6))
    x = conv_silu(p4, cw(1024), 3, 2)           # P5/32
    x = c2f(x, cw(1024), dn(3))
    p5 = sppf(x, cw(1024))

    # PAN neck (v8: no pre-upsample 1x1s; C2f without shortcut)
    x = b.cat([b.upsample(p5, 2), p4], 1)
    n4 = c2f(x, cw(512), dn(3), shortcut=False)
    x = b.cat([b.upsample(n4, 2), p3], 1)
    d3 = c2f(x, cw(256), dn(3), shortcut=False)         # P3 out
    x = conv_silu(d3, cw(256), 3, 2)
    x = b.cat([x, n4], 1)
    d4 = c2f(x, cw(512), dn(3), shortcut=False)         # P4 out
    x = conv_silu(d4, cw(512), 3, 2)
    x = b.cat([x, p5], 1)
    d5 = c2f(x, cw(1024), dn(3), shortcut=False)        # P5 out

    # decoupled head: box (4*reg_max) and cls (nc) branches per level
    no = 4 * reg_max + num_classes
    heads = []
    for d in (d3, d4, d5):
        c = b.shape[d][1]
        hid = max(c // 2, 16)
        box = b.conv(conv_silu(d, hid, 3), 4 * reg_max, 1)
        cls = b.conv(conv_silu(d, hid, 3), num_classes, 1)
        heads.append(b.cat([box, cls], 1))
    out = b.yolo_detect_v8(heads, nc=num_classes, reg_max=reg_max)
    b.output(out)
    return b.build(), "0", out


def build_resnet18(batch: int = 1, image_size: int = 224,
                   num_classes: int = 1000, width: int = 64,
                   seed: int = 0) -> tuple:
    """ResNet-18 (conv-bn-relu basic blocks, Expression residual adds).

    Returns (graph, input_name, output_name). The reference's analog
    fixture is resnet_batchnorm_sigmoid (test_engine.cpp:5-31).
    """
    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def block(x, out_c, stride):
        in_c = b.shape[x][1]
        y = b.relu(b.bn(b.conv(x, out_c, 3, stride, 1, bias=False)))
        y = b.bn(b.conv(y, out_c, 3, 1, 1, bias=False))
        if stride != 1 or in_c != out_c:
            x = b.bn(b.conv(x, out_c, 1, stride, 0, bias=False))
        return b.relu(b.add(y, x))

    x = b.relu(b.bn(b.conv(x, width, 7, 2, 3, bias=False)))
    x = b.maxpool(x, 3, 2, 1)
    for i, (c, blocks) in enumerate(
            [(width, 2), (width * 2, 2), (width * 4, 2), (width * 8, 2)]):
        for j in range(blocks):
            x = block(x, c, 2 if (i > 0 and j == 0) else 1)
    x = b.adaptive_avg_pool(x, 1)
    x = b.flatten(x)
    x = b.linear(x, num_classes)
    b.output(x)
    return b.build(), "0", x


def build_resnet50(batch: int = 1, image_size: int = 224,
                   num_classes: int = 1000, width: int = 64,
                   seed: int = 0) -> tuple:
    """ResNet-50 (1x1-3x3-1x1 bottleneck blocks, expansion 4) — the
    larger classification model of BASELINE.json config 4."""
    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def bottleneck(x, planes, stride):
        in_c = b.shape[x][1]
        out_c = planes * 4
        y = b.relu(b.bn(b.conv(x, planes, 1, bias=False)))
        y = b.relu(b.bn(b.conv(y, planes, 3, stride, 1, bias=False)))
        y = b.bn(b.conv(y, out_c, 1, bias=False))
        if stride != 1 or in_c != out_c:
            x = b.bn(b.conv(x, out_c, 1, stride, 0, bias=False))
        return b.relu(b.add(y, x))

    x = b.relu(b.bn(b.conv(x, width, 7, 2, 3, bias=False)))
    x = b.maxpool(x, 3, 2, 1)
    for i, (planes, blocks) in enumerate(
            [(width, 3), (width * 2, 4), (width * 4, 6), (width * 8, 3)]):
        for j in range(blocks):
            x = bottleneck(x, planes, 2 if (i > 0 and j == 0) else 1)
    x = b.adaptive_avg_pool(x, 1)
    x = b.flatten(x)
    x = b.linear(x, num_classes)
    b.output(x)
    return b.build(), "0", x


def build_mobilenet_like(batch: int = 1, image_size: int = 224,
                         num_classes: int = 1000, width_mult: float = 1.0,
                         seed: int = 0) -> tuple:
    """MobileNetV2-style inverted residuals with depthwise (grouped)
    convs and Hardswish/Hardsigmoid activations — covers the grouped-conv
    and hard-activation surface of the reference's mobile_batch8 fixture.
    """
    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def c(ch):
        return max(8, int(ch * width_mult))

    def inverted_residual(x, out_c, stride, expand):
        in_c = b.shape[x][1]
        hidden = in_c * expand
        y = x
        if expand != 1:
            y = b.hardswish(b.bn(b.conv(y, hidden, 1, bias=False)))
        y = b.hardswish(b.bn(b.conv(y, hidden, 3, stride, 1, groups=hidden,
                                    bias=False)))
        y = b.bn(b.conv(y, out_c, 1, bias=False))
        if stride == 1 and in_c == out_c:
            y = b.add(y, x)
        return y

    x = b.hardswish(b.bn(b.conv(x, c(32), 3, 2, 1, bias=False)))
    cfgs = [(c(16), 1, 1), (c(24), 2, 6), (c(24), 1, 6), (c(32), 2, 6),
            (c(32), 1, 6), (c(64), 2, 6), (c(64), 1, 6), (c(96), 1, 6),
            (c(160), 2, 6), (c(160), 1, 6), (c(320), 1, 6)]
    for out_c, stride, expand in cfgs:
        x = inverted_residual(x, out_c, stride, expand)
    x = b.hardswish(b.bn(b.conv(x, c(1280), 1, bias=False)))
    x = b.adaptive_avg_pool(x, 1)
    x = b.flatten(x)
    x = b.linear(x, num_classes)
    b.output(x)
    return b.build(), "0", x


def build_unet(batch: int = 1, image_size: int = 128, in_ch: int = 3,
               num_classes: int = 21, width: int = 32,
               depth: int = 3, seed: int = 0) -> tuple:
    """UNet-style encoder/decoder segmenter (superset family — the
    reference has no segmentation workload).

    conv-bn-relu double blocks, maxpool downs, ConvTranspose2d k2 s2
    ups with encoder skip cats, 1x1 class head producing
    [N, num_classes, H, W] logits. Exercises the transpose-conv lowering
    and cat junctions in a real topology.
    """
    b = GraphBuilder(seed)
    x = b.input([batch, in_ch, image_size, image_size], name="0")

    def double(x, c):
        x = b.relu(b.bn(b.conv(x, c, 3, 1, 1, bias=False)))
        return b.relu(b.bn(b.conv(x, c, 3, 1, 1, bias=False)))

    skips = []
    c = width
    x = double(x, c)
    for _ in range(depth):
        skips.append(x)
        x = b.maxpool(x, 2)
        c *= 2
        x = double(x, c)
    for skip in reversed(skips):
        c //= 2
        x = b.conv_transpose(x, c, 2, 2)
        x = double(b.cat([x, skip], 1), c)
    out = b.conv(x, num_classes, 1)
    b.output(out)
    return b.build(), "0", out


_DENSENET_BLOCKS = {"121": (6, 12, 24, 16), "169": (6, 12, 32, 32),
                    "201": (6, 12, 48, 32)}


def build_densenet(variant: str | tuple = "121", batch: int = 1,
                   image_size: int = 224, num_classes: int = 1000,
                   growth_rate: int = 32, init_width: int = 64,
                   seed: int = 0) -> tuple:
    """DenseNet (dense concat-growth blocks, BN-ReLU-conv pre-activation
    ordering, avgpool transitions) — a concat-heavy topology class the
    zoo otherwise lacks; superset family (the reference's classify
    fixtures are MobileNet/ResNet-style).

    variant: "121"/"169"/"201" or a tuple of per-block layer counts.
    Dense layer: BN-ReLU-1x1(4g)-BN-ReLU-3x3(g), concatenated onto the
    running feature map; transition: BN-ReLU-1x1(c/2) + 2x2 avgpool s2.
    """
    blocks = (_DENSENET_BLOCKS[variant] if isinstance(variant, str)
              else tuple(variant))
    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")

    def dense_layer(x):
        y = b.conv(b.relu(b.bn(x)), 4 * growth_rate, 1, bias=False)
        y = b.conv(b.relu(b.bn(y)), growth_rate, 3, 1, 1, bias=False)
        return b.cat([x, y], 1)

    x = b.relu(b.bn(b.conv(x, init_width, 7, 2, 3, bias=False)))
    x = b.maxpool(x, 3, 2, 1)
    for i, layers in enumerate(blocks):
        for _ in range(layers):
            x = dense_layer(x)
        if i < len(blocks) - 1:  # transition
            c = b.shape[x][1]
            x = b.conv(b.relu(b.bn(x)), c // 2, 1, bias=False)
            x = b.avgpool(x, 2)
    x = b.relu(b.bn(x))
    x = b.adaptive_avg_pool(x, 1)
    x = b.flatten(x)
    x = b.linear(x, num_classes)
    b.output(x)
    return b.build(), "0", x



NEOX_PRESETS = {
    # (depth, width, heads)
    "nano": (2, 64, 4),
    "micro": (4, 128, 4),
    "small": (6, 256, 8),
}


def build_neox(variant: str = "nano", batch: int = 1, seq_len: int = 64,
               vocab_size: int = 128, depth: int | None = None,
               width: int | None = None, num_heads: int | None = None,
               rotary_pct: float = 0.25, rope_theta: float = 10000.0,
               shared_ln: bool = False, head_bias: bool = False,
               seed: int = 0) -> tuple:
    """GPT-NeoX/Pythia-style causal LM; with shared_ln=True,
    head_bias=True, rotary_pct=0.5 it is the phi-2 block. The lineage
    the llama builder cannot express: LayerNorm (not RMSNorm), PARALLEL
    attention+MLP residual (x + attn(ln1(x)) + mlp(ln2(x)); phi shares
    one ln), PARTIAL rotary (HF rotary_pct / partial_rotary_factor —
    only the first rotary_dim of each head rotates), biased q/k/v/o,
    GELU MLP. Superset family: the CPU reference has no autoregressive
    workload at all; drivable by greedy_generate and CachedDecoder
    unchanged (the decode step is plan-driven, and rotary_dim flows
    through decode_info)."""
    if variant not in NEOX_PRESETS:
        raise ValueError(f"variant must be one of {list(NEOX_PRESETS)}")
    d0, w0, h0 = NEOX_PRESETS[variant]
    depth = d0 if depth is None else depth
    w = w0 if width is None else width
    heads = h0 if num_heads is None else num_heads
    d = w // heads
    rot = max(2, int(d * rotary_pct) // 2 * 2)

    b = GraphBuilder(seed)
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, vocab_size, w)
    for _ in range(depth):
        ln1 = b.layer_norm(x)
        attn = b.rotary_attention(ln1, heads, rope_theta=rope_theta,
                                  bias=True, rotary_dim=rot)
        ln2 = ln1 if shared_ln else b.layer_norm(x)
        h = b.gelu(b.linear(ln2, 4 * w))
        mlp = b.linear(h, w)
        x = b.add(b.add(x, attn), mlp)
    x = b.layer_norm(x)
    logits = b.linear(x, vocab_size, bias=head_bias)
    b.output(logits)
    return b.build(), "0", logits


BLOOM_PRESETS = {
    # (depth, width, heads)
    "nano": (2, 64, 4),
    "micro": (4, 128, 8),
    "small": (6, 256, 8),
}


def build_bloom(variant: str = "nano", batch: int = 1, seq_len: int = 64,
                vocab_size: int = 128, depth: int | None = None,
                width: int | None = None, num_heads: int | None = None,
                seed: int = 0) -> tuple:
    """BLOOM-style causal LM — the ALiBi lineage: NO position
    embeddings of any kind; attention logits carry a per-head linear
    key-position bias instead (si.RotaryAttention alibi=1,
    ops/attention.alibi_slopes). Block wiring per HF BloomModel:
    embedding -> embedding LayerNorm -> sequential pre-LN blocks
    (biased fused-qkv attention with dense bias, tanh-GELU 4x MLP) ->
    final LayerNorm -> tied-style vocab head. Superset family: the CPU
    reference has no autoregressive workload at all; drivable by
    greedy_generate / CachedDecoder / GenerationService unchanged
    (alibi flows through decode_info to the non-rotary decode paths).
    """
    if variant not in BLOOM_PRESETS:
        raise ValueError(f"variant must be one of {list(BLOOM_PRESETS)}")
    d0, w0, h0 = BLOOM_PRESETS[variant]
    depth = d0 if depth is None else depth
    w = w0 if width is None else width
    heads = h0 if num_heads is None else num_heads

    b = GraphBuilder(seed)
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, vocab_size, w)
    x = b.layer_norm(x)          # word_embeddings_layernorm
    for _ in range(depth):
        y = b.layer_norm(x)
        attn = b.rotary_attention(y, heads, bias=True, o_bias=True,
                                  alibi=True)
        x = b.add(x, attn)
        y = b.layer_norm(x)
        h = b.gelu(b.linear(y, 4 * w), approximate="tanh")
        x = b.add(x, b.linear(h, w))
    x = b.layer_norm(x)
    logits = b.linear(x, vocab_size, bias=False)
    b.output(logits)
    return b.build(), "0", logits


VIT_PRESETS = {
    # depth, embed_dim, heads (vit paper table 1 / timm vit_*_patch16)
    "tiny": (12, 192, 3),
    "small": (12, 384, 6),
    "base": (12, 768, 12),
}


def build_vit(variant: str = "tiny", batch: int = 1, image_size: int = 224,
              patch_size: int = 16, num_classes: int = 1000,
              depth: int | None = None, embed_dim: int | None = None,
              num_heads: int | None = None, seed: int = 0) -> tuple:
    """Vision Transformer classifier (superset family — the reference is
    CNN-only, SURVEY.md §2.3 / layer_registry.cpp:34-48).

    Emits the op sequence a pnnx export of timm/torchvision ViT produces:
    patch-embed Conv2d(p, p, s=p) -> reshape [N, E, L] -> transpose(1,2)
    -> cat(expanded cls-token pnnx.Attribute, x) -> + pos-embed
    pnnx.Attribute (broadcast Expression add) -> depth x [pre-LN
    nn.MultiheadAttention block + pre-LN Linear/GELU/Linear MLP, residual
    adds] -> final LayerNorm -> torch.select cls token -> Linear head.
    """
    if variant not in VIT_PRESETS:
        raise ValueError(f"variant must be one of {list(VIT_PRESETS)}")
    d0, e0, h0 = VIT_PRESETS[variant]
    depth = d0 if depth is None else depth
    e = e0 if embed_dim is None else embed_dim
    heads = h0 if num_heads is None else num_heads
    if image_size % patch_size:
        raise ValueError("image_size must be a multiple of patch_size")
    n_patch = (image_size // patch_size) ** 2

    b = GraphBuilder(seed)
    x = b.input([batch, 3, image_size, image_size], name="0")
    x = b.conv(x, e, patch_size, patch_size, 0)          # [N, E, H/p, W/p]
    x = b.reshape(x, [batch, e, n_patch])                # [N, E, L]
    x = b.transpose(x, 1, 2)                             # [N, L, E]
    cls = b.attr_const(b._rand((1, 1, e)) * 0.02)
    cls = b.expand(cls, [batch, 1, e])
    x = b.cat([cls, x], dim=1)                           # [N, L+1, E]
    pos = b.attr_const(b._rand((1, n_patch + 1, e)) * 0.02)
    x = b.add(x, pos)

    for _ in range(depth):
        y = b.layer_norm(x)
        y = b.mha(y, heads)
        x = b.add(x, y)
        y = b.layer_norm(x)
        y = b.linear(y, 4 * e)
        y = b.gelu(y)
        y = b.linear(y, e)
        x = b.add(x, y)

    x = b.layer_norm(x)
    x = b.select(x, dim=1, index=0)                      # cls token [N, E]
    x = b.linear(x, num_classes)
    b.output(x)
    return b.build(), "0", x


BERT_PRESETS = {
    # depth, hidden, heads (BERT paper table 1 / tiny-BERT distillations)
    "tiny": (2, 128, 2),
    "mini": (4, 256, 4),
    "small": (4, 512, 8),
    "base": (12, 768, 12),
}


def build_bert(variant: str = "tiny", batch: int = 1, seq_len: int = 128,
               vocab_size: int = 30522, num_classes: int = 2,
               depth: int | None = None, hidden: int | None = None,
               num_heads: int | None = None, seed: int = 0) -> tuple:
    """BERT-style text classifier (superset family — the reference is a
    vision-only CNN engine, SURVEY.md §2.3).

    The zoo's NLP workload: token-id input [N, L] -> nn.Embedding +
    learned position embedding (pnnx.Attribute, broadcast add) ->
    post-LN encoder stack (nn.MultiheadAttention + GELU MLP, residuals
    NORMALIZED AFTER the add like the original BERT, vs the ViT
    builder's pre-LN) -> [CLS] pooler (select + Linear + Tanh) ->
    classifier head. Exercises integer gather inputs and rank-3
    attention at NLP sequence lengths.
    """
    if variant not in BERT_PRESETS:
        raise ValueError(f"variant must be one of {list(BERT_PRESETS)}")
    d0, h0, a0 = BERT_PRESETS[variant]
    depth = d0 if depth is None else depth
    h = h0 if hidden is None else hidden
    heads = a0 if num_heads is None else num_heads

    b = GraphBuilder(seed)
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, vocab_size, h)                  # [N, L, H]
    pos = b.attr_const(b._rand((1, seq_len, h)) * 0.02)
    x = b.add(x, pos)
    x = b.layer_norm(x)

    for _ in range(depth):
        y = b.mha(x, heads)
        x = b.layer_norm(b.add(x, y))                    # post-LN
        y = b.linear(x, 4 * h)
        y = b.gelu(y)
        y = b.linear(y, h)
        x = b.layer_norm(b.add(x, y))

    cls = b.select(x, dim=1, index=0)                    # [CLS] [N, H]
    pooled = b.tanh(b.linear(cls, h))
    logits = b.linear(pooled, num_classes)
    b.output(logits)
    return b.build(), "0", logits


GPT_PRESETS = {
    # depth, width, heads (GPT-2 family ladder, scaled-down entries first)
    "nano": (3, 48, 3),
    "micro": (4, 128, 4),
    "mini": (6, 192, 6),
    "small": (12, 768, 12),
}


def build_gpt(variant: str = "nano", batch: int = 1, seq_len: int = 64,
              vocab_size: int = 50257, depth: int | None = None,
              width: int | None = None, num_heads: int | None = None,
              seed: int = 0) -> tuple:
    """GPT-style causal decoder LM (superset family — the reference has
    no autoregressive workload).

    Token ids [N, L] -> nn.Embedding + learned position embedding ->
    pre-LN blocks whose nn.MultiheadAttention takes an additive causal
    mask (pnnx.Attribute [L, L], -inf above the diagonal — the mask-
    operand form real pnnx exports of masked attention produce) ->
    final LayerNorm -> vocab head. Output: next-token logits [N, L, V].
    `zoo.generate.greedy_generate` drives it autoregressively.
    """
    if variant not in GPT_PRESETS:
        raise ValueError(f"variant must be one of {list(GPT_PRESETS)}")
    d0, w0, h0 = GPT_PRESETS[variant]
    depth = d0 if depth is None else depth
    w = w0 if width is None else width
    heads = h0 if num_heads is None else num_heads

    b = GraphBuilder(seed)
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, vocab_size, w)
    pos = b.attr_const(b._rand((1, seq_len, w)) * 0.02)
    x = b.add(x, pos)

    causal = np.triu(np.full((seq_len, seq_len), -1e9, np.float32), k=1)
    mask = b.attr_const(causal)

    for _ in range(depth):
        y = b.layer_norm(x)
        y = b.mha(y, heads, mask=mask)
        x = b.add(x, y)
        y = b.layer_norm(x)
        y = b.linear(y, 4 * w)
        y = b.gelu(y)
        y = b.linear(y, w)
        x = b.add(x, y)

    x = b.layer_norm(x)
    logits = b.linear(x, vocab_size, bias=False)
    b.output(logits)
    return b.build(), "0", logits


LLAMA_PRESETS = {
    # depth, width, heads, kv_heads (nano/micro are test-scale; the
    # ratios mirror llama-2/3 blocks: GQA, SwiGLU at 8/3 expansion)
    "nano": (2, 64, 4, 2),
    "micro": (4, 128, 8, 4),
    "small": (8, 512, 16, 8),
    # llama-1B-class: ~0.84B parameters at vocab 32000
    "base": (16, 2048, 32, 8),
}


def build_llama(variant: str = "nano", batch: int = 1, seq_len: int = 64,
                vocab_size: int = 128, depth: int | None = None,
                width: int | None = None, num_heads: int | None = None,
                num_kv_heads: int | None = None,
                rope_theta: float = 10000.0, seed: int = 0,
                sliding_window: int | None = None,
                sliding_pattern: str = "all",
                qk_norm: bool = False,
                head_dim: int | None = None,
                attn_scale: float | None = None,
                logit_softcap: float | None = None,
                rotary_dim: int | None = None) -> tuple:
    """Llama-family causal decoder LM: token ids [N, L] -> nn.Embedding
    -> pre-RMSNorm blocks of si.RotaryAttention (RoPE + GQA, intrinsic
    causal mask) and a SwiGLU MLP (gate/up nn.Linear, silu * up as an
    Expression mul, down nn.Linear; no biases) -> final RMSNorm -> vocab
    head. Output: next-token logits [N, L, V]. The same graph, op names
    and seeded weights as the JAX package's build_llama."""
    if variant not in LLAMA_PRESETS:
        raise ValueError(f"variant must be one of {list(LLAMA_PRESETS)}")
    if sliding_pattern not in ("all", "alternate"):
        raise ValueError("sliding_pattern must be 'all' or 'alternate'")
    d0, w0, h0, kv0 = LLAMA_PRESETS[variant]
    depth = d0 if depth is None else depth
    w = w0 if width is None else width
    heads = h0 if num_heads is None else num_heads
    kv = kv0 if num_kv_heads is None else num_kv_heads
    inter = max(1, int(w * 8 / 3) // 16 * 16)  # llama 8/3, 16-aligned

    b = GraphBuilder(seed)
    ids = b.input([batch, seq_len], name="0")
    x = b.embedding(ids, vocab_size, w)

    for li in range(depth):
        sw_i = sliding_window if (sliding_pattern == "all"
                                  or li % 2 == 1) else None
        y = b.rms_norm(x)
        y = b.rotary_attention(y, heads, num_kv_heads=kv,
                               rope_theta=rope_theta,
                               sliding_window=sw_i,
                               head_dim=head_dim, qk_norm=qk_norm,
                               attn_scale=attn_scale,
                               logit_softcap=logit_softcap,
                               rotary_dim=rotary_dim)
        x = b.add(x, y)
        y = b.rms_norm(x)
        gate = b.silu_act(b.linear(y, inter, bias=False))
        up = b.linear(y, inter, bias=False)
        y = b.mul(gate, up)
        y = b.linear(y, w, bias=False)
        x = b.add(x, y)

    x = b.rms_norm(x)
    logits = b.linear(x, vocab_size, bias=False)
    b.output(logits)
    return b.build(), "0", logits
