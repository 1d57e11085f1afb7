"""Image I/O and annotation drawing (counterpart of
simpleinfer_tpu/zoo/imageio.py, the simpleocv analog).

The reference links the `simpleocv` stb-based library for imread /
imwrite / rectangle / putText in its YOLO demo (test_yolo.cpp). Here:
PIL when available (PNG / JPEG), plus an always-available pure-numpy
PPM path and numpy box/label drawing, so the pipeline works where PIL is
not installed.

Convention: images are HWC uint8. `imread` returns BGR by default to
match the reference's cv::imread (its preprocess then swaps to RGB);
pass bgr=False for RGB.
"""
from __future__ import annotations

import numpy as np

try:
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def imread(path: str, bgr: bool = True) -> np.ndarray:
    """Read an image file to HWC uint8 (BGR by default, like cv::imread)."""
    if path.endswith(".ppm"):
        img = _read_ppm(path)
    elif _HAS_PIL:
        img = np.asarray(Image.open(path).convert("RGB"))
    else:
        raise IOError(f"cannot read {path!r}: PIL unavailable and not PPM")
    return img[..., ::-1].copy() if bgr else img


def imwrite(path: str, img: np.ndarray, bgr: bool = True) -> None:
    """Write HWC uint8 (BGR by default) to PNG/JPEG (PIL) or PPM."""
    img = np.asarray(img, np.uint8)
    rgb = img[..., ::-1] if bgr else img
    if path.endswith(".ppm") or not _HAS_PIL:
        _write_ppm(path if path.endswith(".ppm") else path + ".ppm", rgb)
        return
    Image.fromarray(rgb).save(path)


def _read_ppm(path: str) -> np.ndarray:
    """Binary P6 parser. The header ends after EXACTLY ONE whitespace
    byte following maxval — a split() on whitespace runs would eat
    leading pixel bytes that happen to be 0x09/0x0A/0x0D/0x20."""
    with open(path, "rb") as f:
        data = f.read()

    pos = 0

    def token():
        nonlocal pos
        # skip whitespace and '#' comment lines (PPM allows them in the
        # header), then read one token
        while pos < len(data):
            c = data[pos:pos + 1]
            if c in b" \t\r\n":
                pos += 1
            elif c == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                break
        start = pos
        while pos < len(data) and data[pos:pos + 1] not in b" \t\r\n":
            pos += 1
        return data[start:pos]

    if token() != b"P6":
        raise IOError("only binary P6 PPM supported")
    w, h, maxval = int(token()), int(token()), int(token())
    if maxval != 255:
        raise IOError("only 8-bit PPM supported")
    pos += 1  # exactly one whitespace byte terminates the header
    pix = data[pos:pos + w * h * 3]
    if len(pix) < w * h * 3:
        raise IOError(f"PPM truncated: {len(pix)} < {w * h * 3} bytes")
    return np.frombuffer(pix, np.uint8).reshape(h, w, 3).copy()


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb).tobytes())


# 5x7 bitmap font for labels (digits, upper letters, a few symbols)
_FONT = {
    c: v for c, v in zip(
        "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ .:%-",
        [0x1F8C63E, 0x42108C4, 0x3E11106, 0x1E8A08E, 0x210F918,
         0x1E8BC3F, 0x1F8BC3E, 0x111110F, 0x1F8BE3E, 0x1E87C3E,
         0x118FE2E, 0x1F8FE3F, 0x1F0842F, 0x1F18C7F, 0x3F0BC3F,
         0x10BC3F, 0x1F8F43E, 0x118FE31, 0x1F2109F, 0x1E84210,
         0x1197251, 0x1F08421, 0x2318EB7, 0x2339AD7, 0x1F18C6E,
         0x10BE31F, 0x2E95465, 0x1197E31, 0x1E8383E, 0x4210847,
         0x1F18C63, 0x22A4631, 0x155AC63, 0x22A22A2, 0x4213962,
         0x3E2223E, 0x0, 0x400100, 0x1A4105A, 0x380000]
    )
}


def _draw_char(img, ch, x, y, color, scale=1):
    bits = _FONT.get(ch.upper())
    if bits is None:
        return
    for row in range(7):
        for col in range(5):
            if bits >> (row * 5 + col) & 1:
                y0, x0 = y + row * scale, x + col * scale
                img[y0:y0 + scale, x0:x0 + scale] = color


def draw_text(img: np.ndarray, text: str, org: tuple,
              color=(255, 255, 255), scale: int = 1) -> np.ndarray:
    """Tiny bitmap text (the putText analog); org = (x, y) top-left."""
    h, w = img.shape[:2]
    x, y = org
    for ch in text:
        if 0 <= x < w - 6 * scale and 0 <= y < h - 8 * scale:
            _draw_char(img, ch, x, y, np.asarray(color, np.uint8), scale)
        x += 6 * scale
    return img


def draw_rectangle(img: np.ndarray, pt1: tuple, pt2: tuple,
                   color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """Axis-aligned rectangle (the cv::rectangle analog)."""
    h, w = img.shape[:2]
    x1, y1 = (int(np.clip(v, 0, s - 1)) for v, s in zip(pt1, (w, h)))
    x2, y2 = (int(np.clip(v, 0, s - 1)) for v, s in zip(pt2, (w, h)))
    c = np.asarray(color, np.uint8)
    t = thickness
    img[y1:y1 + t, x1:x2 + 1] = c
    img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = c
    img[y1:y2 + 1, x1:x1 + t] = c
    img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = c
    return img


def draw_detections(img: np.ndarray, detections: list,
                    color=(0, 255, 0)) -> np.ndarray:
    """Annotate a copy of `img` with boxes + 'name score' labels — the
    output format of the reference demo (test_yolo.cpp:424-436)."""
    out = np.asarray(img, np.uint8).copy()
    for d in detections:
        x1, y1, x2, y2 = (int(v) for v in d.box)
        draw_rectangle(out, (x1, y1), (x2, y2), color)
        label = f"{d.class_name} {d.score * 100:.0f}%"
        draw_text(out, label, (x1 + 2, max(y1 - 10, 0)), color)
    return out
