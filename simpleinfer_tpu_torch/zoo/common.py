"""Shared zoo-pipeline helpers (counterpart of simpleinfer_tpu/zoo/common.py).

The pipelines build NHWC batches. An engine with ``io_layout="nchw"``
reads rank-4 arrays at its input() / extract() boundary as NCHW
(config.py), so a pipeline adapts at that boundary: `stage_for_engine`
and `fetch_nhwc`.

`_resize_bilinear` is the port's copy of simpleinfer_tpu/zoo/detect.py's
numpy resize, which the classification pipeline uses; the port of
zoo/detect.py takes it from here.
"""
from __future__ import annotations

import numpy as np


def _is_nchw(engine) -> bool:
    return getattr(engine.config, "io_layout", "nhwc") == "nchw"


def stage_for_engine(engine, batch_nhwc: np.ndarray) -> np.ndarray:
    """NHWC pipeline batch -> the engine's declared input layout."""
    if _is_nchw(engine) and batch_nhwc.ndim == 4:
        return np.ascontiguousarray(batch_nhwc.transpose(0, 3, 1, 2))
    return batch_nhwc


def fetch_nhwc(engine, name: str, as_numpy: bool = True):
    """extract() an output and return it in NHWC whatever the engine's
    io layout (a torch tensor stays on its device)."""
    out = engine.extract(name, as_numpy=as_numpy)
    if _is_nchw(engine) and out.ndim == 4:
        if as_numpy:
            return out.transpose(0, 2, 3, 1)
        return out.permute(0, 2, 3, 1)
    return out


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
