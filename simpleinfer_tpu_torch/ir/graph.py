"""Framework-native graph IR loaded from the pnnx model format.

The class structure and the ``.pnnx.param`` text grammar mirror the pnnx IR
(reference: src/pnnx/ir.h:38-250 for the classes,
ir.cpp:709-815 for Graph::load, ir.cpp:479-548 for
Parameter::parse_from_string, ir.cpp:597-707 for load_shape /
load_attribute), re-expressed as Python dataclasses backed by numpy for
attribute (weight) storage.

Param file grammar (one token stream per line, whitespace separated):

    <magic>                                   e.g. 7767517
    <operator_count> <operand_count>
    <type> <name> <#in> <#out> <in-names...> <out-names...> <key=value...>

where a key prefixed ``@`` is an attribute (weights stored in the zip as
``<opname>.<key>``), ``$`` is an operand input-key annotation, ``#`` is an
operand shape annotation like ``(1,3,640,640)f32`` (``?`` = -1), and a bare
key is a typed parameter literal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from .dtypes import (
    string_to_type,
    type_to_elemsize,
    type_to_numpy,
    type_to_string,
    numpy_to_type,
)
from .storezip import StoreZipReader, StoreZipWriter

PNNX_MAGIC = 7767517

# Parameter type tags, same encoding as pnnx
# 0=null 1=bool 2=int 3=float 4=str 5=int[] 6=float[] 7=str[]
PARAM_NULL, PARAM_BOOL, PARAM_INT, PARAM_FLOAT, PARAM_STR = 0, 1, 2, 3, 4
PARAM_AINT, PARAM_AFLOAT, PARAM_ASTR = 5, 6, 7


@dataclass
class Parameter:
    """Tagged-union parameter value (ir.h:38-140)."""

    type: int = PARAM_NULL
    value: Union[None, bool, int, float, str, list] = None

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_value(v) -> "Parameter":
        if v is None:
            return Parameter(PARAM_NULL, None)
        if isinstance(v, bool):
            return Parameter(PARAM_BOOL, v)
        if isinstance(v, int):
            return Parameter(PARAM_INT, v)
        if isinstance(v, float):
            return Parameter(PARAM_FLOAT, v)
        if isinstance(v, str):
            return Parameter(PARAM_STR, v)
        if isinstance(v, (list, tuple)):
            vs = list(v)
            if not vs:
                return Parameter(PARAM_NULL, None)
            if all(isinstance(x, str) for x in vs):
                return Parameter(PARAM_ASTR, vs)
            if any(isinstance(x, float) for x in vs):
                return Parameter(PARAM_AFLOAT, [float(x) for x in vs])
            return Parameter(PARAM_AINT, [int(x) for x in vs])
        raise TypeError(f"unsupported parameter value {v!r}")

    @staticmethod
    def parse_from_string(value: str) -> "Parameter":
        """Literal grammar of Parameter::parse_from_string (ir.cpp:479-548)."""
        if value in ("None", "()", "[]"):
            return Parameter(PARAM_NULL, None)
        if value in ("True", "False"):
            return Parameter(PARAM_BOOL, value == "True")
        if value[0] in "([":
            inner = value[1:-1]
            ptype = PARAM_NULL
            out: list = []
            for elem in inner.split(","):
                if _looks_like_string(elem):
                    ptype = PARAM_ASTR
                    out.append(elem)
                elif "." in elem or "e" in elem:
                    ptype = PARAM_AFLOAT
                    out.append(float(elem))
                else:
                    ptype = PARAM_AINT
                    out.append(int(elem))
            return Parameter(ptype, out)
        if _looks_like_string(value):
            return Parameter(PARAM_STR, value)
        if "." in value or "e" in value:
            return Parameter(PARAM_FLOAT, float(value))
        return Parameter(PARAM_INT, int(value))

    # ---- typed accessors ----------------------------------------------
    @property
    def b(self) -> bool:
        return bool(self.value)

    @property
    def i(self) -> int:
        return int(self.value)

    @property
    def f(self) -> float:
        return float(self.value)

    @property
    def s(self) -> str:
        return str(self.value)

    @property
    def ai(self) -> list:
        return list(self.value)

    @property
    def af(self) -> list:
        return list(self.value)

    @property
    def as_(self) -> list:
        return list(self.value)

    def encode(self) -> str:
        """Inverse of parse_from_string, for Graph.save."""
        t, v = self.type, self.value
        if t == PARAM_NULL:
            return "None"
        if t == PARAM_BOOL:
            return "True" if v else "False"
        if t == PARAM_INT:
            return str(v)
        if t == PARAM_FLOAT:
            return _encode_float(v)
        if t == PARAM_STR:
            return v
        if t == PARAM_AINT:
            return "(" + ",".join(str(int(x)) for x in v) + ")"
        if t == PARAM_AFLOAT:
            return "(" + ",".join(_encode_float(x) for x in v) + ")"
        if t == PARAM_ASTR:
            return "(" + ",".join(v) + ")"
        raise ValueError(f"unsupported parameter type {t}")


def _looks_like_string(elem: str) -> bool:
    """First-char heuristic of the reference literal grammar."""
    if not elem:
        return True
    c0 = elem[0]
    if c0 != "-" and not c0.isdigit():
        return True
    if c0 == "-" and (len(elem) < 2 or not elem[1].isdigit()):
        return True
    return False


def _encode_float(f: float) -> str:
    """Float encoding that always round-trips as a float literal."""
    s = f"{float(f):g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s


@dataclass
class Attribute:
    """Typed weight blob (ir.h:144-163); data held as a numpy array."""

    type: int = 0
    shape: list = field(default_factory=list)
    data: Optional[np.ndarray] = None  # flat or shaped array, C order

    @staticmethod
    def from_array(arr: np.ndarray) -> "Attribute":
        arr = np.ascontiguousarray(arr)
        return Attribute(type=numpy_to_type(arr.dtype), shape=list(arr.shape), data=arr)

    def array(self) -> np.ndarray:
        """Return the data reshaped to `shape` with the pnnx dtype."""
        if self.data is None:
            raise ValueError("attribute has no data")
        return np.asarray(self.data).reshape(self.shape)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * type_to_elemsize(self.type) if self.shape else 0


@dataclass
class Operand:
    name: str
    producer: Optional["Operator"] = None
    consumers: list = field(default_factory=list)
    type: int = 0
    shape: list = field(default_factory=list)
    params: dict = field(default_factory=dict)

    def remove_consumer(self, op: "Operator") -> None:
        self.consumers = [c for c in self.consumers if c is not op]

    def __repr__(self):
        return (f"Operand({self.name!r}, type={type_to_string(self.type)}, "
                f"shape={self.shape})")


@dataclass
class Operator:
    type: str
    name: str
    inputs: list = field(default_factory=list)  # list[Operand]
    outputs: list = field(default_factory=list)
    inputnames: list = field(default_factory=list)
    params: dict = field(default_factory=dict)  # str -> Parameter
    attrs: dict = field(default_factory=dict)  # str -> Attribute

    def has_param(self, key: str, ptype: Optional[int] = None) -> bool:
        """Typed existence check, like CheckParam (pnnx_helper.cpp:5-22)."""
        p = self.params.get(key)
        if p is None:
            return False
        return ptype is None or p.type == ptype

    def has_attr(self, key: str, atype: Optional[int] = None) -> bool:
        """Typed existence check, like CheckAttr (pnnx_helper.cpp:24-39)."""
        a = self.attrs.get(key)
        if a is None:
            return False
        return atype is None or a.type == atype

    def __repr__(self):
        return f"Operator({self.type!r}, {self.name!r})"


class Graph:
    """pnnx graph: ordered operator list + operand table (ir.h:216-250)."""

    def __init__(self):
        self.ops: list[Operator] = []
        self.operands: list[Operand] = []
        self._operand_by_name: dict[str, Operand] = {}

    # ---- construction --------------------------------------------------
    def new_operator(self, type: str, name: str) -> Operator:
        op = Operator(type=type, name=name)
        self.ops.append(op)
        return op

    def new_operator_before(self, type: str, name: str, cur: Operator) -> Operator:
        op = Operator(type=type, name=name)
        self.ops.insert(self.ops.index(cur), op)
        return op

    def new_operator_after(self, type: str, name: str, cur: Operator) -> Operator:
        op = Operator(type=type, name=name)
        self.ops.insert(self.ops.index(cur) + 1, op)
        return op

    def new_operand(self, name: str) -> Operand:
        r = Operand(name=name)
        self.operands.append(r)
        self._operand_by_name[name] = r
        return r

    def get_operand(self, name: str) -> Optional[Operand]:
        return self._operand_by_name.get(name)

    def get_or_create_operand(self, name: str) -> Operand:
        r = self.get_operand(name)
        return r if r is not None else self.new_operand(name)

    def remove_operand(self, operand: Operand) -> None:
        self.operands.remove(operand)
        self._operand_by_name.pop(operand.name, None)

    def remove_operator(self, op: Operator) -> None:
        self.ops.remove(op)

    # ---- load / save ----------------------------------------------------
    @staticmethod
    def load(parampath: str, binpath: Optional[str] = None) -> "Graph":
        with open(parampath, "r", encoding="utf-8") as f:
            text = f.read()
        szr = StoreZipReader(binpath) if binpath is not None else None
        try:
            return Graph.parse(text, szr)
        finally:
            if szr is not None:
                szr.close()

    @staticmethod
    def parse(param_text: str, szr: Optional[StoreZipReader] = None) -> "Graph":
        """Parse `.param` text; weights resolved via `szr` when given.

        Follows Graph::load (ir.cpp:709-815).
        """
        g = Graph()
        lines = param_text.splitlines()
        if not lines:
            raise ValueError("empty param file")
        magic = int(lines[0].split()[0])
        if magic != PNNX_MAGIC:
            raise ValueError(f"bad magic {magic}, expected {PNNX_MAGIC}")
        counts = lines[1].split()
        operator_count = int(counts[0])

        li = 2
        for _ in range(operator_count):
            tokens = lines[li].split()
            li += 1
            type_, name = tokens[0], tokens[1]
            n_in, n_out = int(tokens[2]), int(tokens[3])
            op = g.new_operator(type_, name)
            pos = 4
            for _ in range(n_in):
                r = g.get_or_create_operand(tokens[pos])
                pos += 1
                r.consumers.append(op)
                op.inputs.append(r)
            for _ in range(n_out):
                r = g.get_or_create_operand(tokens[pos])
                pos += 1
                r.producer = op
                op.outputs.append(r)
            for tok in tokens[pos:]:
                key, _, value = tok.partition("=")
                if key.startswith("@"):
                    _load_attribute(op, key[1:], value, szr)
                elif key.startswith("$"):
                    _load_input_key(op, key[1:], value)
                elif key.startswith("#"):
                    _load_shape(op, key[1:], value)
                else:
                    op.params[key] = Parameter.parse_from_string(value)
        return g

    def save(self, parampath: str, binpath: Optional[str] = None) -> None:
        """Write `.param` (+ optional `.bin` zip) round-trippable by load."""
        szw = StoreZipWriter(binpath) if binpath is not None else None
        lines = [str(PNNX_MAGIC), f"{len(self.ops)} {len(self.operands)}"]
        for op in self.ops:
            tokens = [op.type, op.name, str(len(op.inputs)), str(len(op.outputs))]
            tokens += [r.name for r in op.inputs]
            tokens += [r.name for r in op.outputs]
            for i, r in enumerate(op.inputs):
                if i < len(op.inputnames) and op.inputnames[i]:
                    tokens.append(f"${op.inputnames[i]}={r.name}")
            for key, p in op.params.items():
                tokens.append(f"{key}={p.encode()}")
            for key, a in op.attrs.items():
                tokens.append(f"@{key}={_encode_shape(a.shape, a.type)}")
                if szw is not None and a.data is not None:
                    szw.write_file(f"{op.name}.{key}",
                                   np.ascontiguousarray(a.array()).tobytes())
            for r in op.inputs + op.outputs:
                if r.shape:
                    tokens.append(f"#{r.name}={_encode_shape(r.shape, r.type)}")
            lines.append(" ".join(tokens))
        with open(parampath, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        if szw is not None:
            szw.close()

    # ---- queries ---------------------------------------------------------
    def input_ops(self) -> list[Operator]:
        return [op for op in self.ops if op.type == "pnnx.Input"]

    def output_ops(self) -> list[Operator]:
        return [op for op in self.ops if op.type == "pnnx.Output"]

    def __repr__(self):
        return f"Graph(ops={len(self.ops)}, operands={len(self.operands)})"


def _encode_shape(shape: list, type_code: int) -> str:
    dims = ",".join("?" if d == -1 else str(d) for d in shape)
    return f"({dims}){type_to_string(type_code)}"


def _parse_shape_value(value: str) -> tuple[list, int]:
    rparen = value.rfind(")")
    type_code = string_to_type(value[rparen + 1:])
    inner = value[1:rparen]
    shape = []
    if inner:
        for elem in inner.split(","):
            shape.append(-1 if elem == "?" else int(elem))
    return shape, type_code


def _load_shape(op: Operator, key: str, value: str) -> None:
    """#name=(dims)type annotation on an input/output operand (ir.cpp:597-650)."""
    operand = None
    for r in op.inputs:
        if r.name == key:
            operand = r
            break
    if operand is None:
        for r in op.outputs:
            if r.name == key:
                operand = r
                break
    if operand is None:
        return
    operand.shape, operand.type = _parse_shape_value(value)


def _load_input_key(op: Operator, key: str, value: str) -> None:
    """$key=operand annotation (ir.cpp load_input_key)."""
    if len(op.inputnames) < len(op.inputs):
        op.inputnames.extend([""] * (len(op.inputs) - len(op.inputnames)))
    for i, r in enumerate(op.inputs):
        if r.name == value:
            op.inputnames[i] = key
            break


def _load_attribute(op: Operator, key: str, value: str,
                    szr: Optional[StoreZipReader]) -> None:
    """@key=(dims)type weight annotation; bytes from zip (ir.cpp:653-707)."""
    a = Attribute()
    op.attrs[key] = a
    shape, a.type = _parse_shape_value(value)
    if a.type == 0:
        return
    a.shape = shape
    if not a.shape:
        return
    nbytes = math.prod(a.shape) * type_to_elemsize(a.type)
    if szr is None:
        return
    filename = f"{op.name}.{key}"
    filesize = szr.get_file_size(filename)
    if filesize == 0:
        return
    if filesize != nbytes:
        raise ValueError(
            f"attribute {filename}: expected {nbytes} bytes, zip has {filesize}")
    raw = szr.read_file(filename)
    a.data = np.frombuffer(raw, dtype=type_to_numpy(a.type)).reshape(a.shape)
