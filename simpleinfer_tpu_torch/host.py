"""ctypes bindings for the port's native host library (csrc/si_host.cpp).

The counterpart of simpleinfer_tpu/host.py, on the port's own copy of
the source: store-zip index parsing, letterbox preprocessing and greedy
NMS on the host. g++ builds `csrc/si_host.cpp` at first use into
`_build/` beside the package (as kernels/build.py builds the .cu
sources), under a name that carries a hash of the source, the flags and
the CPU that `-march=native` resolves to, so a library built on another
host is never loaded. Every entry point returns None when the library
cannot be built or loaded, and the callers then take their numpy route,
which gives the same result.

    from simpleinfer_tpu_torch import host
    host.available()        -> bool (builds lazily)
    host.library()          -> path of the loaded library, or None
    host.storezip_index(buf)-> {name: (offset, size)}
    host.letterbox_batch(imgs, size) -> [N,size,size,3] f32
    host.nms(boxes, scores) -> kept indices, score-ordered
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .kernels.build import BUILD_DIR, CSRC

SOURCE = CSRC / "si_host.cpp"
# the JAX package's flags: -march=native lets g++ contract multiply-adds
# into FMAs, and the letterbox's bytes follow (the same bytes as the JAX
# package's library on the same host). The library is for the CPU that
# built it: library_path() puts that CPU into the name.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# builds of the library in this process (a load of an existing one is
# not a build)
builds = 0


@functools.lru_cache(maxsize=1)
def _target() -> Optional[bytes]:
    """The target options -march=native resolves to on this host (g++'s
    own account of the CPU: its -march and every ISA extension), or None
    without g++."""
    try:
        return subprocess.run(
            ["g++", *CXX_FLAGS[:2], "-Q", "--help=target"], check=True,
            capture_output=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None


def library_path() -> Optional[Path]:
    """Where the library of csrc/si_host.cpp lives for these flags on
    this CPU; None where g++ cannot say which CPU this is (then no
    library is built or loaded)."""
    target = _target()
    if target is None:
        return None
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + target).hexdigest()
    return BUILD_DIR / f"libsi_host_{tag[:16]}.so"


def _build(so: Path) -> bool:
    global builds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    builds += 1
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if so is None or not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.si_storezip_index.restype = ctypes.c_int64
        lib.si_storezip_index.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, u64p, u64p, u64p, u64p,
            ctypes.c_int64]
        lib.si_letterbox_u8.restype = None
        lib.si_letterbox_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int]
        lib.si_letterbox_batch_u8.restype = None
        lib.si_letterbox_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), i64p, i64p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int]
        lib.si_nms.restype = ctypes.c_int64
        lib.si_nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def library() -> Optional[str]:
    """Path of the loaded library (building it if need be), or None."""
    return str(library_path()) if available() else None


# -------------------------------------------------------------- storezip
def storezip_index(buf: bytes) -> Optional[dict]:
    """{name: (data_offset, size)} from an in-memory store-zip, or None
    if the native library is unavailable / archive unsupported."""
    lib = _load()
    if lib is None:
        return None
    cap = 4096
    name_off = (ctypes.c_uint64 * cap)()
    name_len = (ctypes.c_uint64 * cap)()
    data_off = (ctypes.c_uint64 * cap)()
    data_size = (ctypes.c_uint64 * cap)()
    n = lib.si_storezip_index(buf, len(buf), name_off, name_len, data_off,
                              data_size, cap)
    if n < 0 or n > cap:
        # more entries than the buffers hold: a partial index would
        # lose weights, so the caller walks the archive in Python
        return None
    out = {}
    for i in range(n):
        name = buf[name_off[i]:name_off[i] + name_len[i]].decode("utf-8")
        out[name] = (int(data_off[i]), int(data_size[i]))
    return out


# ------------------------------------------------------------- letterbox
def letterbox_one(img: np.ndarray, size: int = 640, pad_value: float = 114.0,
                  bgr_to_rgb: bool = True, normalize: bool = True
                  ) -> Optional[np.ndarray]:
    """Native letterbox of one HWC uint8 image; None -> the numpy route
    (zoo.detect.letterbox)."""
    lib = _load()
    if lib is None or img.dtype != np.uint8 or img.ndim != 3 \
            or img.shape[2] != 3:
        return None
    img = np.ascontiguousarray(img)
    out = np.empty((size, size, 3), np.float32)
    lib.si_letterbox_u8(
        img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data,
        size, pad_value, int(bgr_to_rgb), int(normalize))
    return out


def letterbox_batch(imgs: list, size: int = 640, pad_value: float = 114.0,
                    bgr_to_rgb: bool = True, normalize: bool = True
                    ) -> Optional[np.ndarray]:
    """Native letterbox of a list of HWC uint8 images -> [N,size,size,3]."""
    lib = _load()
    if lib is None:
        return None
    if not imgs or any(im.dtype != np.uint8 or im.ndim != 3
                       or im.shape[2] != 3 for im in imgs):
        return None
    imgs = [np.ascontiguousarray(im) for im in imgs]
    n = len(imgs)
    out = np.empty((n, size, size, 3), np.float32)
    i64 = ctypes.c_int64 * n
    lib.si_letterbox_batch_u8(
        (ctypes.c_void_p * n)(*[im.ctypes.data for im in imgs]),
        i64(*[im.shape[0] for im in imgs]), i64(*[im.shape[1] for im in imgs]),
        n, out.ctypes.data, size, pad_value, int(bgr_to_rgb), int(normalize))
    return out


# ------------------------------------------------------------------- nms
def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.45,
        max_keep: int = 300) -> Optional[np.ndarray]:
    """Native greedy NMS (csrc si_nms); None -> the numpy route
    (zoo.detect.nms). The same keep set and order: stable sort by
    descending score, suppress IoU > thresh."""
    lib = _load()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    if np.isnan(scores).any():
        # NaN breaks std::stable_sort's strict weak ordering and would
        # order otherwise than np.argsort: the numpy route takes it
        return None
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError(f"nms: bad shapes {boxes.shape} {scores.shape}")
    keep = np.empty(max(int(max_keep), 0), np.int64)
    kept = lib.si_nms(boxes.ctypes.data, scores.ctypes.data, n,
                      float(iou_thresh), int(max_keep), keep.ctypes.data)
    return keep[:kept].copy()
