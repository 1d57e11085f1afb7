"""Shared zoo-pipeline helpers (counterpart of simpleinfer_tpu/zoo/common.py).

The pipelines build NHWC batches. An engine with ``io_layout="nchw"``
reads rank-4 arrays at its input() / extract() boundary as NCHW
(config.py), so a pipeline adapts at that boundary: `stage_for_engine`
and `fetch_nhwc`.
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

