"""The reference's PascalCase API over the port's Engine.

The port's copy of simpleinfer_tpu/compat.py. The reference ships
pybind11 bindings whose Python surface is InitializeContext / DataType /
Status / Tensor(SetTensorDim4, GetTensorDim4) / Engine(LoadModel,
Release, InputNames, OutputNames, Input, Forward, Extract) returning
Status codes. This module reproduces that surface over
simpleinfer_tpu_torch.Engine so reference user scripts run verbatim:

    from simpleinfer_tpu_torch import compat as infer
    infer.InitializeContext()
    engine = infer.Engine()            # on "cuda" unless given a config
    rc = engine.LoadModel(param, bin)  # -> Status.Success
    t = infer.Tensor(infer.DataType.Float32, [4, 320, 320, 3])
    t.SetTensorDim4(np_array)          # NHWC, like the reference
    engine.Input(engine.InputNames()[0], t)
    engine.Forward()
    out = infer.Tensor()
    engine.Extract(engine.OutputNames()[0], out)
    result = out.GetTensorDim4()

Unlike the pythonic `simpleinfer_tpu_torch.Engine` (which raises),
every call returns a Status enum like the C++ API, the same Status the
JAX package's compat layer returns for the same call.
"""
from __future__ import annotations

import enum
import logging
from typing import Optional

import numpy as np

from .config import EngineConfig
from .engine import Engine as _Engine, initialize_context

logger = logging.getLogger("simpleinfer_tpu_torch.compat")


def InitializeContext() -> None:  # noqa: N802
    initialize_context()


class DataType(enum.Enum):
    """The reference binding exposes None/Float32."""

    None_ = 0
    Float32 = 1


# the binding exposes `DataType.None`, which is not a valid Python
# identifier; provide it via attribute assignment for script parity
setattr(DataType, "None", DataType.None_)


class Status(enum.Enum):
    """Status codes of the reference's C++ API."""

    Success = 0
    Fail = 1
    Empty = 2
    ErrorShape = 3
    ErrorContext = 4
    Unsupport = 5


class Tensor:
    """NHWC fp32 tensor container (the reference binding's Tensor)."""

    def __init__(self, dtype: DataType = DataType.Float32,
                 shape: Optional[list] = None):
        self._dtype = dtype
        self._shape = list(shape) if shape is not None else []
        self._data: Optional[np.ndarray] = None

    def GetDataType(self) -> DataType:  # noqa: N802
        return self._dtype

    def Shape(self) -> list:  # noqa: N802
        return list(self._shape)

    def SetTensorDim4(self, array) -> Status:  # noqa: N802
        arr = np.asarray(array, np.float32)
        if arr.ndim != 4:
            return Status.ErrorShape
        if self._shape and list(arr.shape) != self._shape:
            return Status.ErrorShape
        self._data = arr
        self._shape = list(arr.shape)
        self._dtype = DataType.Float32
        return Status.Success

    def GetTensorDim4(self) -> np.ndarray:  # noqa: N802
        if self._data is None:
            raise ValueError("empty tensor")
        return self._data


class Engine:
    """Status-returning façade over simpleinfer_tpu_torch.Engine (the
    reference's engine.h surface). Runs on the CUDA card unless `config`
    says otherwise (EngineConfig(device="cpu"))."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self._engine = _Engine(config)

    def LoadModel(self, parampath: str, binpath: str) -> Status:  # noqa: N802
        try:
            self._engine.load_model(parampath, binpath)
            return Status.Success
        except FileNotFoundError:
            return Status.Empty
        except Exception as e:  # noqa: BLE001
            logger.error("LoadModel failed: %s", e)
            return Status.Fail

    def Release(self) -> Status:  # noqa: N802
        self._engine.release()
        return Status.Success

    def InputNames(self) -> list:  # noqa: N802
        try:
            return self._engine.input_names
        except Exception:  # noqa: BLE001
            return []

    def OutputNames(self) -> list:  # noqa: N802
        try:
            return self._engine.output_names
        except Exception:  # noqa: BLE001
            return []

    def Input(self, name: str, tensor: Tensor) -> Status:  # noqa: N802
        try:
            self._engine.input(name, tensor.GetTensorDim4())
            return Status.Success
        except KeyError:
            return Status.Fail
        except ValueError:
            return Status.ErrorShape
        except Exception as e:  # noqa: BLE001
            logger.error("Input failed: %s", e)
            return Status.Fail

    def Forward(self) -> Status:  # noqa: N802
        try:
            self._engine.forward()
            return Status.Success
        except Exception as e:  # noqa: BLE001
            logger.error("Forward failed: %s", e)
            return Status.Fail

    def Extract(self, name: str, tensor: Tensor) -> Status:  # noqa: N802
        try:
            out = np.asarray(self._engine.extract(name), np.float32)
            # GetTensorDim4 is rank-4; lift lower ranks with leading 1s
            # (the reference's rank coercion extends leading dims)
            while out.ndim < 4:
                out = out[None]
            return tensor.SetTensorDim4(out)
        except KeyError:
            return Status.Fail
        except Exception as e:  # noqa: BLE001
            logger.error("Extract failed: %s", e)
            return Status.Fail
