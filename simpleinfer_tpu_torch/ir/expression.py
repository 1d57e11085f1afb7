"""Expand fused ``pnnx.Expression`` operators into UnaryOp/BinaryOp chains.

Behavioral re-implementation of pnnx::expand_expression (reference:
src/pnnx/expand_expression.cpp:65-389): the expression
string (e.g. ``add(@0,mul(@1,2.0))``) is tokenized, scanned right-to-left
with an operand stack, and each function token emits a new UnaryOp/BinaryOp
operator inserted before the Expression op; finally the Expression op is
deleted and its consumers rewired to the last emitted operand.

Emitted op-code params follow the ncnn convention used by the reference:

    UnaryOp  "0": abs=0 neg=1 floor=2 ceil=3 square=4 sqrt=5 rsqrt=6 exp=7
                  log=8 sin=9 cos=10 tan=11 asin=12 acos=13 atan=14
                  reciprocal=15 tanh=16 log10=17
    BinaryOp "0": add=0 sub=1 mul=2 div=3 pow=6 atan2=10
                  (scalar-first reversed: rsub=7 rdiv=8 rpow=9 ratan2=11)
             "1": 1 if one side is a scalar literal, "2": the literal

Expressions containing ``size``/``int``/list tokens are left untouched,
exactly like the reference.
"""
from __future__ import annotations

from .graph import Graph, Operator, Parameter

UNARY_OP_CODES = {
    "abs": 0, "neg": 1, "floor": 2, "ceil": 3, "square": 4, "sqrt": 5,
    "rsqrt": 6, "exp": 7, "log": 8, "sin": 9, "cos": 10, "tan": 11,
    "asin": 12, "acos": 13, "atan": 14, "reciprocal": 15, "tanh": 16,
    "log10": 17,
}

BINARY_OP_CODES = {"add": 0, "sub": 1, "mul": 2, "div": 3, "pow": 6, "atan2": 10}
# codes when the scalar literal is the *first* argument (reversed variants)
BINARY_OP_CODES_SCALAR_FIRST = {"sub": 7, "div": 8, "pow": 9, "atan2": 11}


def _token_is_argument(t: str) -> bool:
    return len(t) >= 2 and t[0] == "@" and t[1:].isdigit()


def _token_is_literal(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


def _tokenize(expr: str) -> list[str]:
    tokens: list[str] = []
    t = ""
    for ch in expr:
        if ch == "[":
            t += ch
            tokens.append(t)
            t = ""
        elif ch in "(),]":
            if t:
                tokens.append(t)
                t = ""
        else:
            t += ch
    if t:
        tokens.append(t)
    return tokens


def _broadcast_shape(a_shape: list, b_shape: list) -> list:
    rank = max(len(a_shape), len(b_shape))
    a = [1] * (rank - len(a_shape)) + list(a_shape)
    b = [1] * (rank - len(b_shape)) + list(b_shape)
    return [max(x, y) for x, y in zip(a, b)]


def _expand_one(graph: Graph, op: Operator, counter: list) -> str:
    """Expand one Expression op; returns the result token name ('' = skip)."""
    expr = op.params["expr"].s
    tokens = _tokenize(expr)

    def resolve_operand(token: str):
        if _token_is_argument(token):
            return op.inputs[int(token[1:])]
        return graph.get_operand(f"{op.name}_{token}")

    def display(token: str) -> str:
        if _token_is_argument(token):
            return op.inputs[int(token[1:])].name
        return token

    stack: list[str] = []
    for t in reversed(tokens):
        if t in ("size", "int") or t == "[":
            return ""
        if t in UNARY_OP_CODES:
            a = stack.pop()
            r = f"{t}({display(a)})"
            stack.append(r)

            op_unary = graph.new_operator_before(
                "UnaryOp", f"{t}_{counter[0]}", op)
            counter[0] += 1
            op_unary.params["0"] = Parameter.from_value(UNARY_OP_CODES[t])

            in_opd = resolve_operand(a)
            in_opd.consumers.append(op_unary)
            out_opd = graph.new_operand(f"{op.name}_{r}")
            out_opd.producer = op_unary
            out_opd.shape = list(in_opd.shape)
            out_opd.type = in_opd.type
            op_unary.inputs.append(in_opd)
            op_unary.outputs.append(out_opd)
        elif t in BINARY_OP_CODES:
            a = stack.pop()
            b = stack.pop()
            r = f"{t}({display(a)},{display(b)})"
            stack.append(r)

            op_bin = graph.new_operator_before(
                "BinaryOp", f"{t}_{counter[0]}", op)
            counter[0] += 1
            op_bin.params["0"] = Parameter.from_value(BINARY_OP_CODES[t])

            if _token_is_literal(a):
                # scalar op tensor -> reversed scalar variant
                if t in BINARY_OP_CODES_SCALAR_FIRST:
                    op_bin.params["0"] = Parameter.from_value(
                        BINARY_OP_CODES_SCALAR_FIRST[t])
                in_b = resolve_operand(b)
                in_b.consumers.append(op_bin)
                op_bin.params["1"] = Parameter.from_value(1)
                op_bin.params["2"] = Parameter.from_value(float(a))
                out_opd = graph.new_operand(f"{op.name}_{r}")
                out_opd.producer = op_bin
                out_opd.shape = list(in_b.shape)
                out_opd.type = in_b.type
                op_bin.inputs.append(in_b)
                op_bin.outputs.append(out_opd)
            elif _token_is_literal(b):
                in_a = resolve_operand(a)
                in_a.consumers.append(op_bin)
                op_bin.params["1"] = Parameter.from_value(1)
                op_bin.params["2"] = Parameter.from_value(float(b))
                if t == "pow" and float(b) == 2.0:
                    # pow(x, 2) -> square, as the reference rewrites
                    op_bin.type = "UnaryOp"
                    op_bin.params = {"0": Parameter.from_value(
                        UNARY_OP_CODES["square"])}
                out_opd = graph.new_operand(f"{op.name}_{r}")
                out_opd.producer = op_bin
                out_opd.shape = list(in_a.shape)
                out_opd.type = in_a.type
                op_bin.inputs.append(in_a)
                op_bin.outputs.append(out_opd)
            else:
                in_a = resolve_operand(a)
                in_a.consumers.append(op_bin)
                in_b = resolve_operand(b)
                in_b.consumers.append(op_bin)
                out_opd = graph.new_operand(f"{op.name}_{r}")
                out_opd.producer = op_bin
                out_opd.shape = _broadcast_shape(in_a.shape, in_b.shape)
                out_opd.type = in_a.type
                op_bin.inputs.extend([in_a, in_b])
                op_bin.outputs.append(out_opd)
        else:
            stack.append(t)  # @argument or literal

    return stack.pop()


def expand_expression(graph: Graph) -> None:
    """Explode every supported pnnx.Expression op in place."""
    counter = [0]
    unsupported: set = set()

    while True:
        target = None
        for op in graph.ops:
            if op.type == "pnnx.Expression" and id(op) not in unsupported:
                target = op
                break
        if target is None:
            return
        op = target

        outname = _expand_one(graph, op, counter)
        if not outname:
            unsupported.add(id(op))
            continue

        new_out = graph.get_operand(f"{op.name}_{outname}")
        if new_out is None:
            unsupported.add(id(op))
            continue

        old_out = op.outputs[0]
        for r in op.inputs:
            r.remove_consumer(op)
        for consumer in old_out.consumers:
            new_out.consumers.append(consumer)
            consumer.inputs = [
                new_out if x is old_out else x for x in consumer.inputs]
        new_out.type = old_out.type
        new_out.shape = list(old_out.shape)
        new_out.params = dict(old_out.params)
        old_out.producer = None
        old_out.consumers = []
        graph.remove_operator(op)
        graph.remove_operand(old_out)
