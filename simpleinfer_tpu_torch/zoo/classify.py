"""Classification pipeline (counterpart of simpleinfer_tpu/zoo/classify.py):
ImageNet-style preprocessing, softmax and top-k decode, and
`classify_images`, images in and per-image top-k out through an Engine.
"""
from __future__ import annotations

import numpy as np

from .common import _resize_bilinear, stage_for_engine

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def preprocess_classify(img: np.ndarray, size: int = 224,
                        crop_pct: float = 0.875,
                        normalize: bool = True) -> np.ndarray:
    """HWC uint8/float image -> [size, size, 3] float32 (resize the
    shorter side to size/crop_pct, center crop, mean/std normalize)."""
    h, w = img.shape[:2]
    resize_to = int(round(size / crop_pct))
    scale = resize_to / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = _resize_bilinear(img, nh, nw) / 255.0
    top = max((nh - size) // 2, 0)
    left = max((nw - size) // 2, 0)
    x = x[top:top + size, left:left + size]
    if normalize:
        x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return x.astype(np.float32)


def softmax(logits: np.ndarray, axis: int = -1) -> np.ndarray:
    z = logits - logits.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def top_k(logits: np.ndarray, k: int = 5) -> list:
    """[N, classes] logits -> per-row list of (class_id, prob), sorted."""
    probs = softmax(logits)
    out = []
    for row in probs:
        idx = np.argsort(-row)[:k]
        out.append([(int(i), float(row[i])) for i in idx])
    return out


def classify_images(engine, images: list, input_name: str | None = None,
                    size: int = 224, k: int = 5) -> list:
    """End to end: HWC images -> per-image top-k (class_id, prob)."""
    input_name = input_name or engine.input_names[0]
    batch = np.stack([preprocess_classify(im, size) for im in images])
    out = engine.run({input_name: stage_for_engine(engine, batch)})
    return top_k(out[engine.output_names[0]], k)
