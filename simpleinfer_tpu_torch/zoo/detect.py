"""Detection pipeline (counterpart of simpleinfer_tpu/zoo/detect.py):
letterbox preprocess, YOLO decode, NMS.

The host side is the JAX package's, in numpy, with the port's own native
host library (host.py) where it is built:

- `letterbox`: BGR->RGB, letterbox resize with gray(114) pad, /255
  normalize, NHWC;
- `decode_predictions`: score threshold 0.25, per-class argmax, sort by
  confidence, class-wise NMS with IoU 0.45, unletterbox + clip;
- COCO-80 class names.

The device side is plain torch on the head tensor's own device, in
place of the JAX package's jit-compiled `jnp` (no Pallas kernel there):
`topk_candidates`, `nms_device` (for `nms_jax`) and `decode_device`,
batched over the N images, fixed-size outputs. `nms_device` gives the
greedy result without a loop over the candidates: the keep set of greedy
NMS over the score-sorted order is the one solution of

    keep[i] = valid[i] and not any(keep[j] and iou[j, i] > t, j < i),

reached by iterating it from keep = valid (after r rounds the first r
entries are final), so the work is one batched product a round and the
rounds are the length of the longest suppression chain, not K. Ties keep
the input order, as jax.lax.top_k and a stable argsort do: every sort
here is a stable torch.sort.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .common import stage_for_engine

COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

# the class offset of class-wise NMS: boxes of different classes never
# overlap once shifted by class_id * CLASS_OFFSET px
CLASS_OFFSET = 4096.0


@dataclass
class Detection:
    box: tuple  # (x1, y1, x2, y2) in original-image pixels
    score: float
    class_id: int

    @property
    def class_name(self) -> str:
        return COCO_NAMES[self.class_id] if self.class_id < len(
            COCO_NAMES) else str(self.class_id)


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Vectorized bilinear resize, HWC uint8/float -> float32."""
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    if (h, w) == (oh, ow):
        return img
    # align_corners=False convention (matches cv::resize INTER_LINEAR)
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


@dataclass
class Letterbox:
    """Resize-with-aspect + pad to a square canvas."""

    scale: float
    pad_x: float
    pad_y: float

    def unmap(self, boxes: np.ndarray) -> np.ndarray:
        """Map xyxy boxes from canvas coords back to original image."""
        out = boxes.copy()
        out[:, [0, 2]] = (out[:, [0, 2]] - self.pad_x) / self.scale
        out[:, [1, 3]] = (out[:, [1, 3]] - self.pad_y) / self.scale
        return out


def letterbox(img: np.ndarray, size: int = 640, pad_value: float = 114.0,
              bgr_to_rgb: bool = True, normalize: bool = True,
              use_native: bool = True):
    """HWC image -> (NHWC-ready float32 [size,size,3], Letterbox info)."""
    nh, nw, lb = _fit(img.shape, size)
    if use_native:
        # the fused native pass (csrc/si_host.cpp); same sampling/pad math
        from .. import host

        native = host.letterbox_one(img, size, pad_value, bgr_to_rgb,
                                    normalize)
        if native is not None:
            return native, lb
    resized = _resize_bilinear(img, nh, nw)
    if bgr_to_rgb:
        resized = resized[..., ::-1]
    canvas = np.full((size, size, 3), pad_value, np.float32)
    top, left = lb.pad_y, lb.pad_x
    canvas[top:top + nh, left:left + nw] = resized
    if normalize:
        canvas /= 255.0
    return canvas, lb


def _fit(shape, size: int) -> tuple:
    """(resized height, width, Letterbox) of an image of `shape`."""
    h, w = shape[:2]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return nh, nw, Letterbox(scale=scale, pad_x=(size - nw) // 2,
                             pad_y=(size - nh) // 2)


def letterbox_images(images: list, size: int = 640,
                     stage_uint8: bool = False) -> tuple:
    """detect_images' host side: HWC images -> (NHWC batch, [Letterbox]).

    One native pass over the batch (host.letterbox_batch, the bytes of
    `letterbox` image by image) where the library is built, else
    `letterbox` per image. The batch is float32 /255, or with
    stage_uint8 the unnormalized canvas rounded to uint8 bytes."""
    from .. import host

    batch = host.letterbox_batch(images, size, normalize=not stage_uint8)
    if batch is None:
        canvases, lbs = zip(*(letterbox(im, size, normalize=not stage_uint8)
                              for im in images))
        batch = np.stack(canvases)
    else:
        lbs = [_fit(im.shape, size)[2] for im in images]
    if stage_uint8:
        batch = np.clip(np.rint(batch), 0, 255).astype(np.uint8)
    return batch, list(lbs)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between one box [4] and many boxes [N,4]."""
    x1 = np.maximum(a[0], b[:, 0])
    y1 = np.maximum(a[1], b[:, 1])
    x2 = np.minimum(a[2], b[:, 2])
    y2 = np.minimum(a[3], b[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.45,
        max_keep: int = 300) -> np.ndarray:
    """Greedy NMS over xyxy boxes; returns kept indices, score-ordered.

    The native host library's si_nms when it is built (the same result
    for f32 inputs); this loop otherwise."""
    from .. import host

    if (np.asarray(boxes).dtype == np.float32
            and np.asarray(scores).dtype == np.float32):
        native = host.nms(np.asarray(boxes), np.asarray(scores),
                          iou_thresh, max_keep)
        if native is not None:
            return native
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size and len(keep) < max_keep:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        ious = iou_xyxy(boxes[i], boxes[rest])
        order = rest[ious <= iou_thresh]
    return np.asarray(keep, dtype=np.int64)


def decode_predictions(pred: np.ndarray, lb: Letterbox | None = None,
                       conf_thresh: float = 0.25, iou_thresh: float = 0.45,
                       image_shape: tuple | None = None,
                       class_agnostic: bool = False,
                       head: str = "v5") -> list:
    """One image's YOLO head output -> list[Detection].

    head="v5": rows are [xywh, obj, nc] (obj*cls confidence); head="v8":
    anchor-free rows [xywh, nc] with no objectness (models.yolo.DetectV8
    output). Then: score threshold, per-class argmax, class-wise NMS (by
    per-class coordinate offsets), unletterbox + clip.
    """
    pred = np.asarray(pred)
    if head == "v8":
        cls_scores = pred[:, 4:]
    else:
        obj = pred[:, 4]
        cls_scores = pred[:, 5:] * obj[:, None]
    class_id = np.argmax(cls_scores, axis=1)
    score = cls_scores[np.arange(len(pred)), class_id]
    m = score >= conf_thresh
    if not m.any():
        return []
    xywh, score, class_id = pred[m, :4], score[m], class_id[m]
    boxes = np.empty((len(xywh), 4), np.float32)
    boxes[:, 0] = xywh[:, 0] - xywh[:, 2] / 2
    boxes[:, 1] = xywh[:, 1] - xywh[:, 3] / 2
    boxes[:, 2] = xywh[:, 0] + xywh[:, 2] / 2
    boxes[:, 3] = xywh[:, 1] + xywh[:, 3] / 2
    off = boxes if class_agnostic else \
        boxes + class_id[:, None].astype(np.float32) * CLASS_OFFSET
    keep = nms(off, score, iou_thresh)
    boxes, score, class_id = boxes[keep], score[keep], class_id[keep]
    if lb is not None:
        boxes = lb.unmap(boxes)
    if image_shape is not None:
        h, w = image_shape[:2]
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, w - 1)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, h - 1)
    return [Detection(box=tuple(float(v) for v in b), score=float(s),
                      class_id=int(c))
            for b, s, c in zip(boxes, score, class_id)]


# ---- device side (torch, on the tensor's own device) ---------------------
def _sort_desc(scores, k: int):
    """(values, indices) of the k largest along the last dim, ties in
    input order (jax.lax.top_k's order; torch.topk promises none)."""
    import torch

    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_candidates(pred, k: int = 300):
    """Device-side candidate pre-filter: the k highest-confidence rows of
    a YOLO head output [N, M, 5+nc], in the input's dtype and device."""
    import torch

    pred = torch.as_tensor(pred)
    k = min(k, pred.shape[1])
    score = pred[..., 4] * pred[..., 5:].amax(dim=-1)
    _, idx = _sort_desc(score, k)
    return torch.gather(pred, 1, idx[..., None].expand(-1, -1,
                                                       pred.shape[-1]))


def nms_rounds(boxes, scores, iou_thresh: float = 0.45):
    """Greedy NMS keep flags over a batch, without a per-candidate loop.

    boxes [N, K, 4] xyxy, scores [N, K] (rows with score < 0 are absent),
    f32. Returns (order [N, K] of the stable descending sort, keep [N, K]
    bool in that order, rounds taken)."""
    import torch

    order = torch.sort(-scores, dim=-1, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    x1 = torch.maximum(b[:, :, None, 0], b[:, None, :, 0])
    y1 = torch.maximum(b[:, :, None, 1], b[:, None, :, 1])
    x2 = torch.minimum(b[:, :, None, 2], b[:, None, :, 2])
    y2 = torch.minimum(b[:, :, None, 3], b[:, None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-9)
    k = scores.shape[-1]
    # sup[n, j, i]: j, ranked above i, would suppress i if kept
    above = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = ((iou > iou_thresh) & above).to(torch.float32)
    valid = torch.gather(scores, 1, order) >= 0
    keep, rounds = valid, 0
    while True:
        rounds += 1
        hit = torch.bmm(keep.to(torch.float32)[:, None, :], sup)[:, 0]
        new = valid & (hit == 0)
        if torch.equal(new, keep):   # the fixed point: greedy's keep set
            return order, keep, rounds
        keep = new


def _compact(order, keep, max_keep: int):
    """Kept entries of `order` into the first max_keep slots, in score
    order, padded with -1: [N, max_keep] int32."""
    import torch

    n = order.shape[0]
    slot = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    slot = torch.where(keep & (slot < max_keep), slot, max_keep).long()
    out = torch.full((n, max_keep + 1), -1, dtype=torch.int32,
                     device=order.device)
    out.scatter_(1, slot, order.to(torch.int32))
    return out[:, :max_keep]


def nms_device(boxes, scores, iou_thresh: float = 0.45,
               max_keep: int = 300):
    """Greedy NMS on the device with fixed-size output (nms_jax's
    counterpart).

    boxes [K,4] or [N,K,4] xyxy, scores [K] or [N,K]; rows with score < 0
    are absent. Returns int32 indices [max_keep] (or [N, max_keep]) into
    the INPUT order, score-ordered, padded with -1: the suppress rule of
    `nms` (IoU > thresh against an already-kept box). Computes in f32
    whatever the input dtype: bf16 cannot carry the class offset of
    class-wise NMS (its ulp at 4096 * 79 is 2048 px)."""
    import torch

    boxes = torch.as_tensor(boxes).to(torch.float32)
    scores = torch.as_tensor(scores, device=boxes.device).to(torch.float32)
    single = scores.ndim == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    order, keep, _ = nms_rounds(boxes, scores, iou_thresh)
    out = _compact(order, keep, max_keep)
    return out[0] if single else out


def decode_device(pred, conf_thresh: float = 0.25,
                  iou_thresh: float = 0.45, max_det: int = 300,
                  head: str = "v5", class_agnostic: bool = False,
                  pre_topk: int = 1024):
    """Whole-batch YOLO postprocess on the head tensor's device.

    pred [N, M, 4+...] (raw head output) -> [N, max_det, 6] f32 rows
    (x1, y1, x2, y2, score, class_id) in letterbox coordinates, padded
    with [0, 0, 0, 0, -1, -1]: confidence = obj*cls (v5) or cls (v8),
    per-class argmax, the class-wise NMS of `decode_predictions`. Only
    the pre_topk highest-confidence rows enter NMS (as in the JAX
    package; lossless unless more than pre_topk rows pass the
    threshold). Decodes in f32 whatever the engine's dtype."""
    import torch

    p = torch.as_tensor(pred).to(torch.float32)
    cls_scores = p[..., 4:] if head == "v8" else p[..., 5:] * p[..., 4:5]
    score = cls_scores.amax(dim=-1)
    class_id = cls_scores.argmax(dim=-1)    # the first of tied maxima
    score = torch.where(score >= conf_thresh, score,
                        torch.full_like(score, -1.0))
    kc = min(pre_topk, p.shape[1])
    score, idx = _sort_desc(score, kc)
    xywh = torch.gather(p[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    class_id = torch.gather(class_id, 1, idx)
    half = xywh[..., 2:4] / 2
    boxes = torch.cat([xywh[..., :2] - half, xywh[..., :2] + half], dim=-1)
    cls_f = class_id.to(torch.float32)
    off = boxes if class_agnostic else boxes + cls_f[..., None] * CLASS_OFFSET
    order, keep, _ = nms_rounds(off, score, iou_thresh)
    sel = _compact(order, keep, max_det).long()        # [N, max_det]
    ok = sel >= 0
    safe = sel.clamp(min=0)
    rows = torch.cat([
        torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)),
        torch.gather(score, 1, safe)[..., None],
        torch.gather(cls_f, 1, safe)[..., None]], dim=-1)
    pad = torch.tensor([0, 0, 0, 0, -1, -1], dtype=rows.dtype,
                       device=rows.device)
    return torch.where(ok[..., None], rows, pad)


def detections_from_decoded(rows: np.ndarray, lb: Letterbox | None = None,
                            image_shape: tuple | None = None) -> list:
    """[max_det, 6] device-decoded rows -> list[Detection] (host side:
    drop padding, unletterbox, clip)."""
    rows = np.asarray(rows)
    rows = rows[rows[:, 4] >= 0]
    boxes = rows[:, :4].astype(np.float32)
    if lb is not None:
        boxes = lb.unmap(boxes)
    if image_shape is not None:
        h, w = image_shape[:2]
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, w - 1)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, h - 1)
    return [Detection(box=tuple(float(v) for v in b), score=float(s),
                      class_id=int(c))
            for b, s, c in zip(boxes, rows[:, 4], rows[:, 5])]


def detect_images(engine, images: list, input_name: str | None = None,
                  size: int = 640, conf_thresh: float = 0.25,
                  iou_thresh: float = 0.45, head: str = "auto",
                  device_decode: bool = False,
                  max_det: int = 300,
                  stage_uint8: bool = False) -> list:
    """End to end: HWC images -> list of per-image detections.

    Letterbox all images into one NHWC batch, one Engine forward, decode
    each row. head: "v5" (obj+cls rows), "v8" (anchor-free, no obj), or
    "auto" (from the model's detect op type).

    device_decode=True runs score filter + class-wise NMS on the
    engine's device (decode_device) and fetches [N, max_det, 6] rows in
    place of the raw head output.

    stage_uint8=True ships the letterboxed canvas as uint8 bytes and
    normalizes on the device (the engine's u8 input path): 4x fewer
    host->device bytes. The canvas is rounded to integers first, a
    <=0.5/255 perturbation (below bf16 resolution)."""
    input_name = input_name or engine.input_names[0]
    if head == "auto":
        types = {i.type for i in engine.program.impls}
        head = "v8" if "models.yolo.DetectV8" in types else "v5"
    batch, lbs = letterbox_images(images, size, stage_uint8)
    engine.input(input_name, stage_for_engine(engine, batch))
    engine.forward()
    out_name = engine.output_names[0]
    if device_decode:
        raw = engine.extract(out_name, as_numpy=False)
        rows = decode_device(raw, conf_thresh, iou_thresh, max_det,
                             head).cpu().numpy()
        return [detections_from_decoded(rows[i], lbs[i],
                                        image_shape=images[i].shape)
                for i in range(len(images))]
    pred = engine.extract(out_name)
    return [decode_predictions(pred[i], lbs[i], conf_thresh, iou_thresh,
                               image_shape=images[i].shape, head=head)
            for i in range(len(images))]
