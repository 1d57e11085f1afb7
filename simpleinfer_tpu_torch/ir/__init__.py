"""pnnx model-format IR: graph dataclasses, param/bin parser, rewrite passes.

Copies of the numpy-only modules of simpleinfer_tpu/ir/, kept here so the
port never imports the JAX package (whose __init__ imports jax).
"""
from .dtypes import (
    numpy_to_type,
    string_to_type,
    type_to_elemsize,
    type_to_numpy,
    type_to_string,
)
from .expression import expand_expression
from .graph import Attribute, Graph, Operand, Operator, Parameter
from .storezip import StoreZipReader, StoreZipWriter

__all__ = [
    "Attribute",
    "Graph",
    "Operand",
    "Operator",
    "Parameter",
    "StoreZipReader",
    "StoreZipWriter",
    "expand_expression",
    "numpy_to_type",
    "string_to_type",
    "type_to_elemsize",
    "type_to_numpy",
    "type_to_string",
]
