"""Semantic segmentation pipeline for UNet-style models (counterpart of
simpleinfer_tpu/zoo/segment.py).

Plain-resize preprocess, batched forward, per-pixel argmax mask resized
back to the source image, and a color overlay for visual inspection.
Mirrors the structure of zoo/detect.py / zoo/classify.py so all three
task families share one shape of API:

    masks = segment_images(engine, [img_bgr])   # HxW int32 class ids
    overlay = colorize_mask(img_bgr, masks[0])
"""
from __future__ import annotations

import numpy as np

from .classify import _resize_bilinear

# 21 visually-distinct colors (BGR), PASCAL-VOC-size palette
PALETTE = np.asarray([
    (0, 0, 0), (60, 20, 220), (32, 11, 119), (142, 0, 0), (230, 0, 0),
    (228, 0, 106), (100, 60, 0), (142, 0, 0), (70, 0, 0), (153, 153, 190),
    (153, 153, 153), (30, 170, 250), (0, 220, 220), (35, 142, 107),
    (152, 251, 152), (180, 130, 70), (60, 20, 220), (0, 0, 255),
    (100, 80, 0), (90, 0, 0), (230, 0, 119)], np.uint8)


def preprocess_segment(img: np.ndarray, size: int = 128,
                       bgr: bool = True) -> np.ndarray:
    """HWC uint8/float image -> [size, size, 3] float32 in [0, 1] RGB
    (plain bilinear resize — segmentation masks are mapped back through
    the same warp, so no letterbox bookkeeping is needed)."""
    x = np.asarray(img)
    if bgr:
        x = x[..., ::-1]
    x = _resize_bilinear(x, size, size) / 255.0
    return x.astype(np.float32)


def mask_from_logits(logits: np.ndarray) -> np.ndarray:
    """[H, W, C] class logits -> [H, W] int32 argmax mask."""
    return np.argmax(logits, axis=-1).astype(np.int32)


def segment_images(engine, images: list, input_name: str | None = None,
                   output_name: str | None = None,
                   size: int | None = None,
                   device_argmax: bool = True) -> list:
    """Full pipeline: preprocess -> batched forward -> per-image argmax
    mask resized (nearest) back to each source image's H x W.

    device_argmax=True (default) takes the per-pixel argmax on the
    engine's device (torch.argmax) and fetches [N, S, S] int32 class ids
    instead of [N, S, S, C] float logits: the same masks (the same
    first-index tie break), ~4*C fewer bytes fetched."""
    input_name = input_name or engine.input_names[0]
    output_name = output_name or engine.output_names[0]
    spec = next(s for s in engine.program.inputs if s.name == input_name)
    size = size or (spec.shape[1] if len(spec.shape) == 4 else 128)
    import torch

    from .common import fetch_nhwc, stage_for_engine

    batch = np.stack([preprocess_segment(im, size) for im in images])
    staged = stage_for_engine(engine, batch)
    if device_argmax:
        engine.input(input_name, staged)
        engine.forward()
        logits_dev = fetch_nhwc(engine, output_name, as_numpy=False)
        ids = logits_dev.argmax(dim=-1).to(torch.int32).cpu().numpy()
    else:
        ids = None
        engine.input(input_name, staged)
        engine.forward()
        logits = fetch_nhwc(engine, output_name)
    masks = []
    for i, im in enumerate(images):
        m = ids[i] if ids is not None else mask_from_logits(logits[i])
        h, w = np.asarray(im).shape[:2]
        # nearest-neighbor upscale of the CLASS IDS (bilinear would
        # blend class indices into meaningless values)
        yy = (np.arange(h) * m.shape[0] // h).clip(0, m.shape[0] - 1)
        xx = (np.arange(w) * m.shape[1] // w).clip(0, m.shape[1] - 1)
        masks.append(m[yy[:, None], xx[None, :]])
    return masks


def colorize_mask(img: np.ndarray, mask: np.ndarray,
                  alpha: float = 0.5) -> np.ndarray:
    """Blend a class-id mask over the source image (uint8 BGR)."""
    img = np.asarray(img, np.float32)
    colors = PALETTE[np.asarray(mask) % len(PALETTE)].astype(np.float32)
    out = img * (1.0 - alpha) + colors * alpha
    # class 0 (background) keeps the original pixels
    bg = (np.asarray(mask) == 0)[..., None]
    return np.where(bg, img, out).astype(np.uint8)
