"""The plain references of the benchmark's two model families, in
PyTorch alone: YOLOv5 (ultralytics v6.0 topology) and GPT-2.

Nothing here imports the program under test. The references take the
float32 weights the benchmark made from the seed and work out again
what the program derives from them: the int8 per-channel and the int4
group-wise weights, each dequantized to float32. They compute in
float32 with TF32 off. `lowp`, where given, rounds every matmul and conv
input through a lower precision: that is the control of a cell.

The YOLOv5 topology is written once, against an executor: `TorchExec`
runs it on tensors (the reference), `yardstick.ShapeExec` walks it for
shapes and FLOPs.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------ quantization


def int8_per_channel(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Symmetric int8 per-channel weight (abs-max / 127 along `axis`),
    returned dequantized in float32."""
    w = w.float()
    red = [i for i in range(w.ndim) if i != axis]
    absmax = w.abs().amax(dim=red, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q * scale


def int4_grouped(w_in_out: torch.Tensor, group: int) -> torch.Tensor:
    """Symmetric group-wise int4 of a [K, N] weight (abs-max / 7 over
    `group` rows of K, K zero-padded to a multiple of it), returned
    dequantized in float32 at [K, N]."""
    w = w_in_out.float()
    k, n = w.shape
    kp = -(-k // group) * group
    if kp != k:
        w = torch.cat([w, w.new_zeros(kp - k, n)])
    wg = w.reshape(kp // group, group, n)
    absmax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wg / scale), -8, 7)
    return (q * scale).reshape(kp, n)[:k]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one per-tensor scale (amax / 448): the
    lower precision a later change would reach for below bfloat16."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = amax / 448.0
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s)


def _ident(x):
    return x


# ------------------------------------------------------------------ YOLOv5

# ultralytics yolov5 v6.0 anchors (w, h) per level P3/8, P4/16, P5/32
ANCHORS = (((10, 13), (16, 30), (33, 23)),
           ((30, 61), (62, 45), (59, 119)),
           ((116, 90), (156, 198), (373, 326)))
STRIDES = (8, 16, 32)


def yolo_width(ch: int, width_multiple: float) -> int:
    return max(int(round(ch * width_multiple / 8)) * 8, 8)


def yolo_depth(n: int, depth_multiple: float) -> int:
    return max(round(n * depth_multiple), 1)


def yolov5(ex, x, cfg: dict):
    """The v6.0 yolov5 yaml, layer by layer, on executor `ex`. Convs are
    issued in the order their weights are stored (cv1, the bottlenecks,
    cv2, cv3 in a C3; the Detect head's three 1x1 convs last)."""
    gw, gd = cfg["width_multiple"], cfg["depth_multiple"]

    def cw(c):
        return yolo_width(c, gw)

    def conv(x, c, k=1, s=1, p=None):
        return ex.silu(ex.conv(x, c, k, s, k // 2 if p is None else p))

    def bottleneck(x, c, shortcut):
        y = conv(conv(x, c, 1), c, 3)
        return ex.add(y, x) if shortcut and ex.channels(x) == c else y

    def c3(x, c, n, shortcut=True):
        h = c // 2
        y1 = conv(x, h, 1)
        for _ in range(yolo_depth(n, gd)):
            y1 = bottleneck(y1, h, shortcut)
        y2 = conv(x, h, 1)
        return conv(ex.cat([y1, y2]), c, 1)

    def sppf(x, c, k=5):
        y = conv(x, ex.channels(x) // 2, 1)
        p1 = ex.maxpool(y, k)
        p2 = ex.maxpool(p1, k)
        p3 = ex.maxpool(p2, k)
        return conv(ex.cat([y, p1, p2, p3]), c, 1)

    x = conv(x, cw(64), 6, 2, 2)
    x = conv(x, cw(128), 3, 2)
    x = c3(x, cw(128), 3)
    x = conv(x, cw(256), 3, 2)
    p3 = c3(x, cw(256), 6)
    x = conv(p3, cw(512), 3, 2)
    p4 = c3(x, cw(512), 9)
    x = conv(p4, cw(1024), 3, 2)
    x = c3(x, cw(1024), 3)
    p5 = sppf(x, cw(1024))
    h1 = conv(p5, cw(512), 1)
    x = c3(ex.cat([ex.upsample(h1), p4]), cw(512), 3, False)
    h2 = conv(x, cw(256), 1)
    d3 = c3(ex.cat([ex.upsample(h2), p3]), cw(256), 3, False)
    d4 = c3(ex.cat([conv(d3, cw(256), 3, 2), h2]), cw(512), 3, False)
    d5 = c3(ex.cat([conv(d4, cw(512), 3, 2), h1]), cw(1024), 3, False)
    return ex.detect([d3, d4, d5], cfg["nc"])


class TorchExec:
    """Runs `yolov5` in float32 NCHW. `convs` is the list of (weight
    [O, I, k, k], bias [O]) of every backbone and neck conv in issue
    order, already as the program holds them (int8 dequantized);
    `head` the Detect head's three (weight, bias)."""

    def __init__(self, convs, head, lowp=None):
        self.convs, self.head = list(convs), list(head)
        self.i = 0
        self.lowp = lowp or _ident

    def channels(self, x):
        return x.shape[1]

    def conv(self, x, c, k, s, p):
        w, b = self.convs[self.i]
        self.i += 1
        if tuple(w.shape) != (c, x.shape[1], k, k):
            raise ValueError(f"conv {self.i - 1}: weight {tuple(w.shape)} "
                             f"where the topology needs {(c, x.shape[1], k, k)}")
        return F.conv2d(self.lowp(x), w, b, s, p)

    def silu(self, x):
        return F.silu(x)

    def add(self, a, b):
        return a + b

    def cat(self, xs):
        return torch.cat(xs, 1)

    def maxpool(self, x, k):
        return F.max_pool2d(x, k, 1, k // 2)

    def upsample(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")

    def detect(self, feats, nc):
        if self.i != len(self.convs):
            raise ValueError(f"{len(self.convs) - self.i} convs left over")
        na, no = len(ANCHORS[0]), nc + 5
        outs = []
        for lvl, x in enumerate(feats):
            w, b = self.head[lvl]
            y = torch.sigmoid(F.conv2d(self.lowp(x), w, b))   # [N, A*no, H, W]
            n, _, h, wd = y.shape
            y = y.permute(0, 2, 3, 1).reshape(n, h, wd, na, no)
            gy, gx = torch.meshgrid(torch.arange(h, device=y.device),
                                    torch.arange(wd, device=y.device),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1).float()[:, :, None] - 0.5
            anchor = torch.tensor(ANCHORS[lvl], dtype=torch.float32,
                                  device=y.device)
            xy = (y[..., :2] * 2 + grid) * STRIDES[lvl]
            wh = (y[..., 2:4] * 2) ** 2 * anchor
            y = torch.cat([xy, wh, y[..., 4:]], -1)
            outs.append(y.reshape(n, h * wd * na, no))
        return torch.cat(outs, 1)


def yolo_weights(made, device, quantize: bool = True) -> tuple:
    """(convs, head) for TorchExec from the benchmark's weights `made`
    ([(op name, op type, key, float32 array)] in graph order): every
    conv's (weight, bias), int8 per channel where `quantize`, and the
    Detect head's three (weight, bias), kept in float as the program
    keeps them."""
    convs, head = [], []
    for _, op_type, key, arr in made:
        t = torch.from_numpy(arr).to(device)
        if op_type == "nn.Conv2d":
            if key == "weight":
                convs.append([int8_per_channel(t, 0) if quantize else t])
            else:
                convs[-1].append(t)
        elif op_type == "models.yolo.Detect":
            if key.endswith("weight"):
                head.append([t])
            else:
                head[-1].append(t)
    return convs, head


def yolo_reference(convs, head, images_u8, cfg, lowp=None,
                   block: int = 16) -> torch.Tensor:
    """Head output [N, rows, 5+nc] in float32 for uint8 NHWC images,
    `block` images at a time (the reference's memory stays small)."""
    outs = []
    with torch.no_grad(), _no_tf32():
        for i in range(0, images_u8.shape[0], block):
            x = images_u8[i:i + block].permute(0, 3, 1, 2).float() / 255.0
            outs.append(yolov5(TorchExec(convs, head, lowp), x, cfg))
    return torch.cat(outs)


def yolo_decode(pred, conf_thresh=0.25, iou_thresh=0.45, max_det=300,
                pre_topk=1024, class_offset=4096.0):
    """Plain YOLOv5 postprocess of a head output [N, M, 5+nc] (float32):
    confidence obj*cls, per-class argmax (the first of tied maxima),
    the pre_topk most confident rows above the threshold (a stable
    sort), class-wise greedy NMS one candidate at a time, rows (x1, y1,
    x2, y2, score, class) in score order padded with (0, 0, 0, 0, -1,
    -1). Returns [N, max_det, 6] float32 on the host."""
    p = pred.float()
    cls = p[..., 5:] * p[..., 4:5]
    score = cls.amax(-1)
    class_id = cls.argmax(-1)
    score = torch.where(score >= conf_thresh, score,
                        torch.full_like(score, -1.0))
    k = min(pre_topk, p.shape[1])
    score, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    score, idx = score[:, :k], idx[:, :k]
    xywh = torch.gather(p[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    class_id = torch.gather(class_id, 1, idx).float()
    half = xywh[..., 2:4] / 2
    boxes = torch.cat([xywh[..., :2] - half, xywh[..., :2] + half], -1)
    off = boxes + class_id[..., None] * class_offset
    x1 = torch.maximum(off[:, :, None, 0], off[:, None, :, 0])
    y1 = torch.maximum(off[:, :, None, 1], off[:, None, :, 1])
    x2 = torch.minimum(off[:, :, None, 2], off[:, None, :, 2])
    y2 = torch.minimum(off[:, :, None, 3], off[:, None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area = (off[..., 2] - off[..., 0]) * (off[..., 3] - off[..., 1])
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-9)
    over = (iou > iou_thresh).cpu().numpy()
    score_h = score.cpu().numpy()
    boxes_h, cls_h = boxes.cpu(), class_id.cpu()
    out = torch.zeros(p.shape[0], max_det, 6)
    out[:, :, 4:] = -1
    for n in range(p.shape[0]):
        kept, gone = [], np.zeros(k, bool)
        for i in range(k):
            if score_h[n, i] < 0:
                break
            if gone[i]:
                continue
            kept.append(i)
            gone |= over[n, i]          # what candidate i suppresses
            if len(kept) == max_det:
                break
        if kept:
            out[n, :len(kept), :4] = boxes_h[n, kept]
            out[n, :len(kept), 4] = torch.from_numpy(score_h[n, kept])
            out[n, :len(kept), 5] = cls_h[n, kept]
    return out


# ------------------------------------------------------------------- GPT-2


def gpt2_layer_keys(n_layer: int) -> list:
    """The order in which `gpt2_weights` expects the float32 weights."""
    keys = ["wte", "wpe"]
    for i in range(n_layer):
        keys += [f"h{i}.{k}" for k in (
            "ln_1.w", "ln_1.b", "attn.in_w", "attn.in_b", "attn.out_w",
            "attn.out_b", "ln_2.w", "ln_2.b", "mlp.fc_w", "mlp.fc_b",
            "mlp.proj_w", "mlp.proj_b")]
    return keys + ["ln_f.w", "ln_f.b", "head_w"]


def gpt2_raw(made, cfg: dict, device) -> dict:
    """The benchmark's weights `made` ([(op name, op type, key, float32
    array)] in graph order) by the names `gpt2_weights` takes."""
    keys = gpt2_layer_keys(cfg["n_layer"])
    if len(keys) != len(made):
        raise ValueError(f"{len(made)} weights made, the reference takes "
                         f"{len(keys)}")
    return {k: torch.from_numpy(m[3]).to(device) for k, m in zip(keys, made)}


def gpt2_weights(raw: dict, cfg: dict, group: int) -> dict:
    """The program's view of GPT-2's weights, worked out again from the
    float32 ones: every projection int4 group-wise over its input dim
    (q, k and v each their own [E, E]), as [in, out] float32; embeddings,
    norms and biases as they are. `raw` holds the pnnx layouts ([out, in]
    linears, [3E, E] packed in_proj); a tied head's weight is the token
    embedding's values."""
    e = cfg["n_embd"]
    out = {"wte": raw["wte"], "wpe": raw["wpe"].reshape(-1, e),
           "ln_f.w": raw["ln_f.w"], "ln_f.b": raw["ln_f.b"],
           "head_w": int4_grouped(raw["head_w"].t(), group)}
    for i in range(cfg["n_layer"]):
        p = f"h{i}."
        for k in ("ln_1.w", "ln_1.b", "ln_2.w", "ln_2.b", "attn.in_b",
                  "attn.out_b", "mlp.fc_b", "mlp.proj_b"):
            out[p + k] = raw[p + k]
        q, k_, v = raw[p + "attn.in_w"].split(e, 0)
        out[p + "attn.q_w"] = int4_grouped(q.t(), group)
        out[p + "attn.k_w"] = int4_grouped(k_.t(), group)
        out[p + "attn.v_w"] = int4_grouped(v.t(), group)
        out[p + "attn.out_w"] = int4_grouped(raw[p + "attn.out_w"].t(), group)
        out[p + "mlp.fc_w"] = int4_grouped(raw[p + "mlp.fc_w"].t(), group)
        out[p + "mlp.proj_w"] = int4_grouped(raw[p + "mlp.proj_w"].t(), group)
    return out


def gpt2_last_logits(w: dict, cfg: dict, ids: torch.Tensor,
                     lengths: torch.Tensor, lowp=None) -> torch.Tensor:
    """Next-token logits [N, V] at each row's last prompt position, for
    right-padded ids [N, L]: pre-LN blocks, causal attention, the GELU of
    `activation_function` ("gelu_new" is its tanh form), the vocabulary
    head `head_w`. Rows attend only to earlier positions, so padding
    beyond a row's length changes nothing before it."""
    lowp = lowp or _ident
    e, h, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    approx = {"gelu_new": "tanh", "gelu": "none"}[cfg["activation_function"]]
    d = e // h
    n, l = ids.shape
    x = w["wte"][ids] + w["wpe"][:l]
    causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()

    def lin(t, wk, bk=None):
        y = lowp(t) @ w[wk]
        return y if bk is None else y + w[bk]

    for i in range(cfg["n_layer"]):
        p = f"h{i}."
        y = F.layer_norm(x, (e,), w[p + "ln_1.w"], w[p + "ln_1.b"], eps)
        bq, bk, bv = w[p + "attn.in_b"].split(e)
        q = (lowp(y) @ w[p + "attn.q_w"] + bq).reshape(n, l, h, d)
        k = (lowp(y) @ w[p + "attn.k_w"] + bk).reshape(n, l, h, d)
        v = (lowp(y) @ w[p + "attn.v_w"] + bv).reshape(n, l, h, d)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        s = (lowp(q) @ lowp(k).transpose(-1, -2)) / math.sqrt(d)
        s = s.masked_fill(~causal, float("-inf"))
        ctx = lowp(torch.softmax(s, -1)) @ lowp(v)
        ctx = ctx.transpose(1, 2).reshape(n, l, e)
        x = x + lin(ctx, p + "attn.out_w", p + "attn.out_b")
        y = F.layer_norm(x, (e,), w[p + "ln_2.w"], w[p + "ln_2.b"], eps)
        y = F.gelu(lin(y, p + "mlp.fc_w", p + "mlp.fc_b"), approximate=approx)
        x = x + lin(y, p + "mlp.proj_w", p + "mlp.proj_b")
    last = x[torch.arange(n, device=ids.device), lengths - 1]
    last = F.layer_norm(last, (e,), w["ln_f.w"], w["ln_f.b"], eps)
    return lowp(last) @ w["head_w"]


class _no_tf32:
    """TF32 off for matmuls and cuDNN convs inside the block."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def gpt2_reference(w: dict, cfg: dict, prompts: list, lowp=None,
                   block: int = 8) -> torch.Tensor:
    """Last-position logits [len(prompts), V] in float32, `block` prompts
    at a time, each block padded to its longest prompt."""
    dev = w["wte"].device
    outs = []
    with torch.no_grad(), _no_tf32():
        for i in range(0, len(prompts), block):
            part = prompts[i:i + block]
            l = max(len(p) for p in part)
            ids = torch.zeros(len(part), l, dtype=torch.long)
            for j, p in enumerate(part):
                ids[j, :len(p)] = torch.as_tensor(p)
            lengths = torch.tensor([len(p) for p in part])
            outs.append(gpt2_last_logits(w, cfg, ids.to(dev),
                                         lengths.to(dev), lowp))
    return torch.cat(outs)
