"""pnnx dtype codes and conversions.

Mirrors the dtype convention of the pnnx IR (reference:
src/pnnx/ir.h:144-163 Attribute type codes, and
src/types.cpp:48-105 PnnxToDataType / ElementSize):

    0=null 1=f32 2=f64 3=f16 4=i32 5=i64 6=i16 7=i8 8=u8 9=bool
    10=cp64 11=cp128 12=cp32
"""
from __future__ import annotations

import numpy as np

# pnnx type code -> (canonical suffix string, numpy dtype, element size)
_PNNX_DTYPES: dict[int, tuple[str, np.dtype | None, int]] = {
    0: ("null", None, 0),
    1: ("f32", np.dtype(np.float32), 4),
    2: ("f64", np.dtype(np.float64), 8),
    3: ("f16", np.dtype(np.float16), 2),
    4: ("i32", np.dtype(np.int32), 4),
    5: ("i64", np.dtype(np.int64), 8),
    6: ("i16", np.dtype(np.int16), 2),
    7: ("i8", np.dtype(np.int8), 1),
    8: ("u8", np.dtype(np.uint8), 1),
    9: ("bool", np.dtype(np.bool_), 1),
    10: ("cp64", np.dtype(np.complex64), 8),
    11: ("cp128", np.dtype(np.complex128), 16),
    12: ("cp32", None, 4),  # complex32: no numpy equivalent
}

_SUFFIX_TO_CODE = {v[0]: k for k, v in _PNNX_DTYPES.items()}
_NUMPY_TO_CODE = {v[1]: k for k, v in _PNNX_DTYPES.items() if v[1] is not None}


def string_to_type(suffix: str) -> int:
    """Parse a pnnx type suffix like ``f32`` to its integer code.

    Unknown or empty suffixes map to 0 (null), matching the reference's
    string_to_type fallthrough (ir.cpp).
    """
    return _SUFFIX_TO_CODE.get(suffix, 0)


def type_to_string(code: int) -> str:
    return _PNNX_DTYPES.get(code, _PNNX_DTYPES[0])[0]


def type_to_numpy(code: int) -> np.dtype:
    dt = _PNNX_DTYPES.get(code, (None, None, 0))[1]
    if dt is None:
        raise ValueError(f"pnnx dtype code {code} has no numpy equivalent")
    return dt


def numpy_to_type(dtype) -> int:
    code = _NUMPY_TO_CODE.get(np.dtype(dtype))
    if code is None:
        raise ValueError(f"numpy dtype {dtype} has no pnnx code")
    return code


def type_to_elemsize(code: int) -> int:
    return _PNNX_DTYPES.get(code, (None, None, 0))[2]
