"""Tensor facade + layout helpers — API parity with the reference Tensor.

The port's copy of simpleinfer_tpu/tensor.py. The reference exposes
class Tensor (dtype + shape + buffer, zero-copy views) and layout
conversion helpers (NHWC <-> NCHW); in a Python-first framework the
payload is simply an array, here a numpy array or a torch tensor (on
any device), and this thin wrapper exists so code ported from the
reference API has a direct target.

Copy semantics note: reference Tensor copies are shallow, non-owning
aliases. Here `Tensor.data` is whatever array you put in — numpy views
and torch tensors alias their storage as they always do.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


class Status(enum.Enum):
    """Parity with the reference Status codes.

    The Python API raises exceptions instead of returning codes; this
    enum exists for users porting reference code and for structured
    logging."""

    SUCCESS = 0
    ERROR_INVALID_PARAM = 1
    ERROR_EMPTY_GRAPH = 2
    ERROR_EMPTY_PIPELINE = 3
    ERROR_NOT_IMPLEMENTED = 4
    ERROR_INTERNAL = 5


class DataType(enum.Enum):
    """pnnx dtype tags (ir/dtypes.py)."""

    UNKNOWN = 0
    FLOAT32 = 1
    FLOAT64 = 2
    FLOAT16 = 3
    INT32 = 4
    INT64 = 5
    INT16 = 6
    INT8 = 7
    UINT8 = 8
    BOOL = 9
    COMPLEX64 = 10
    COMPLEX128 = 11
    COMPLEX32 = 12
    BFLOAT16 = 13


def nchw_to_nhwc(x):
    """Transpose a rank-4 array (numpy or torch) NCHW -> NHWC (no-op
    otherwise)."""
    if isinstance(x, torch.Tensor):
        return x.permute(0, 2, 3, 1) if x.ndim == 4 else x
    return np.transpose(x, (0, 2, 3, 1)) if np.ndim(x) == 4 else x


def nhwc_to_nchw(x):
    """Transpose a rank-4 array (numpy or torch) NHWC -> NCHW (no-op
    otherwise)."""
    if isinstance(x, torch.Tensor):
        return x.permute(0, 3, 1, 2) if x.ndim == 4 else x
    return np.transpose(x, (0, 3, 1, 2)) if np.ndim(x) == 4 else x


@dataclass
class Tensor:
    """dtype/shape/array triple (the reference's Tensor)."""

    data: Any = None  # numpy array or torch tensor

    @staticmethod
    def from_numpy(arr) -> "Tensor":
        return Tensor(data=np.asarray(arr))

    @property
    def shape(self) -> tuple:
        if self.data is None:
            return ()
        return tuple(self.data.shape) if isinstance(
            self.data, torch.Tensor) else tuple(np.shape(self.data))

    @property
    def dtype(self):
        return getattr(self.data, "dtype", None)

    @property
    def empty(self) -> bool:
        return self.data is None

    def numpy(self) -> np.ndarray:
        """The payload as numpy: a torch tensor is fetched to the host,
        bf16 as float32 (numpy has no bfloat16)."""
        if self.data is None:
            raise ValueError("empty tensor")
        if isinstance(self.data, torch.Tensor):
            t = self.data.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
        return np.asarray(self.data)

    def nhwc(self) -> np.ndarray:
        return nchw_to_nhwc(self.numpy())

    def nchw(self) -> np.ndarray:
        return nhwc_to_nchw(self.numpy())
