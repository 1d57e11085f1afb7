"""The benchmark's frozen arithmetic: the card's published peaks, the
table that sorts CUDA kernels into categories, and the operations and
bytes of the work a cell does, computed from shapes alone.

The program carries its own versions of some of these (a chip spec, a
kernel category table, FLOP counts per op). They may change with the
program; these do not, so that a later change to the program is
measured against the same yardstick.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import models

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# The port's kernels by the symbols of their CUDA sources (the longer
# names first), then the library's by the words their names carry
CATEGORIES = (
    (("Memcpy", "Memset"), "copy"),
    (("si_int4w", "si_matmul_int4w"), "si:matmul_int4w"),
    (("si_matmul",), "si:matmul"),
    (("si_s8s8",), "si:matmul_s8s8"),
    (("si_flash",), "si:flash_attention"),
    (("si_decode",), "si:decode_attention"),
    (("c3_tc_kernel", "c3_s8_tap", "c3_quantize", "c3_fp_kernel"),
     "si:c3_block"),
    (("si_conv3x3",), "si:conv3x3"),
    (("si_stem",), "si:stem"),
    (("fprop", "dgrad", "wgrad", "conv", "Conv"), "conv"),
    (("gemm", "Gemm", "xmma", "cutlass", "cublas", "Kernel2"), "gemm"),
    (("elementwise", "Elementwise", "vectorized", "reduce", "Reduce",
      "softmax", "Softmax", "CatArray", "index", "Index", "copy",
      "fill", "Fill"), "elementwise"),
)


def kernel_category(name: str) -> str:
    for words, cat in CATEGORIES:
        if any(w in name for w in words):
            return cat
    return "other"


@dataclass(frozen=True)
class Call:
    """One kernel call's work: operations and the bytes it must move
    (each input read once, each output written once)."""
    flops: float
    bytes: float

    def min_s(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / HBM_BYTES_PER_S)


def min_seconds(calls) -> float:
    return sum(c.min_s() for c in calls)


# ------------------------------------------------------------------ YOLOv5


@dataclass(frozen=True)
class Conv:
    cin: int
    cout: int
    k: int
    s: int
    h_out: int
    w_out: int
    single_input: bool     # its input is not a channel concat
    head: bool             # a Detect head conv (kept in float)

    @property
    def flops_per_image(self) -> float:
        return 2.0 * self.cout * self.cin * self.k * self.k \
            * self.h_out * self.w_out


class _Shape:
    def __init__(self, c, h, w, cat=False):
        self.c, self.h, self.w, self.cat = c, h, w, cat


class ShapeExec:
    """Walks models.yolov5 on shapes, recording every conv."""

    def __init__(self):
        self.convs: list = []

    def channels(self, x):
        return x.c

    def conv(self, x, c, k, s, p, head=False):
        h = (x.h + 2 * p - k) // s + 1
        w = (x.w + 2 * p - k) // s + 1
        self.convs.append(Conv(x.c, c, k, s, h, w, not x.cat, head))
        return _Shape(c, h, w)

    def silu(self, x):
        return x

    def add(self, a, b):
        return a

    def cat(self, xs):
        return _Shape(sum(x.c for x in xs), xs[0].h, xs[0].w, cat=True)

    def maxpool(self, x, k):
        return x

    def upsample(self, x):
        return _Shape(x.c, 2 * x.h, 2 * x.w)

    def detect(self, feats, nc):
        for x in feats:
            self.conv(x, len(models.ANCHORS[0]) * (nc + 5), 1, 1, 0,
                      head=True)
        return None


def yolo_convs(cfg: dict, image_size: int) -> list:
    ex = ShapeExec()
    models.yolov5(ex, _Shape(3, image_size, image_size), cfg)
    return ex.convs


def yolo_flops_per_image(cfg: dict, image_size: int) -> float:
    """Multiply-adds of every conv, Detect head included, times two."""
    return sum(c.flops_per_image for c in yolo_convs(cfg, image_size))


def int8w_calls(cfg: dict, image_size: int, batch: int) -> list:
    """The calls of one forward that the int8-weight GEMM serves: each
    pointwise stride-1 conv whose input is one tensor (a conv fed by a
    concat takes its inputs apart), outside the Detect head. x and the
    output in bf16, int8 weights with f32 channel scales, bf16 bias."""
    out = []
    for c in yolo_convs(cfg, image_size):
        if c.k != 1 or c.s != 1 or not c.single_input or c.head:
            continue
        m = batch * c.h_out * c.w_out
        out.append(Call(2.0 * m * c.cin * c.cout,
                        2.0 * m * c.cin + c.cin * c.cout + 4.0 * c.cout
                        + 2.0 * c.cout + 2.0 * m * c.cout))
    return out


# ------------------------------------------------------------------- GPT-2


def gpt2_flops(cfg: dict, prompt_len: int) -> float:
    """Model FLOPs of scoring one prompt of `prompt_len` real tokens:
    the four attention projections and the MLP at every position, the
    causal attention products over the pairs a position sees, and the
    vocabulary head at the last position (the one that is served)."""
    e, layers, v = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    inner = cfg.get("n_inner") or 4 * e
    l = prompt_len
    per_layer = 2.0 * l * (4 * e * e + 2 * e * inner) \
        + 4.0 * e * l * (l + 1) / 2
    return layers * per_layer + 2.0 * e * v


def _int4w(m, k, n, group, x_bytes=2, out_bytes=2, bias=False):
    return Call(2.0 * m * k * n,
                x_bytes * m * k + k * n / 2 + 4.0 * (k // group) * n
                + (2.0 * n if bias else 0.0) + out_bytes * m * n)


def int4w_calls_wave(cfg: dict, rows: int, width: int, group: int) -> list:
    """The int4-weight GEMM calls of one admission wave of `rows` prompts
    at bucket `width`: q, k, v and the output projection of every layer
    over all rows x width positions (f32 out, the biases added after);
    the MLP over them in every layer but the last, whose MLP, like the
    vocabulary head, runs on the last positions alone."""
    e, layers, v = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    inner = cfg.get("n_inner") or 4 * e
    full = rows * width
    calls = []
    for i in range(layers):
        calls += [_int4w(full, e, e, group, out_bytes=4) for _ in range(4)]
        m = full if i < layers - 1 else rows
        calls += [_int4w(m, e, inner, group, bias=True),
                  _int4w(m, inner, e, group, bias=True)]
    calls.append(_int4w(rows, e, v, group))
    return calls


def int4w_calls_decode(cfg: dict, rows: int, group: int) -> list:
    """One decode step of a pool of `rows`: q, k, v and the output
    projection (f32 out), the MLP, the vocabulary head."""
    e, layers, v = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    inner = cfg.get("n_inner") or 4 * e
    calls = []
    for _ in range(layers):
        calls += [_int4w(rows, e, e, group, out_bytes=4) for _ in range(4)]
        calls += [_int4w(rows, e, inner, group, bias=True),
                  _int4w(rows, inner, e, group, bias=True)]
    calls.append(_int4w(rows, e, v, group))
    return calls


def flash_calls_wave(cfg: dict, rows: int, width: int) -> list:
    """Causal attention of one wave, a call a layer: q, k, v read and the
    context written once in bf16; QK^T and PV over the pairs causality
    keeps (width * (width + 1) / 2 a head)."""
    e, h, layers = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    d = e // h
    pairs = width * (width + 1) / 2
    flops = 4.0 * d * pairs * rows * h
    nbytes = 4 * 2.0 * rows * h * width * d
    return [Call(flops, nbytes) for _ in range(layers)]
