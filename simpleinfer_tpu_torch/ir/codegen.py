"""Graph -> Python codegen (the pnnx `Graph::python()` analog; the
port's copy of simpleinfer_tpu/ir/codegen.py, numpy only).

The pnnx IR can emit a pytorch script that rebuilds the model
(src/pnnx/ir.cpp `Graph::python`). This emits a standalone Python
script that reconstructs the graph through the port's IR API — useful
for inspecting a model as code, editing it, and re-serializing it.

    from simpleinfer_tpu_torch.ir.codegen import graph_to_python
    script = graph_to_python(graph)          # weights -> .npz sidecar
"""
from __future__ import annotations

from .graph import Graph


def _fmt_param(p) -> str:
    return repr(p.value)


def graph_to_python(graph: Graph, weights_path: str = "weights.npz") -> str:
    """Emit a script that rebuilds `graph` (weights from a .npz sidecar
    written via `save_weights_npz`)."""
    lines = [
        '"""Auto-generated by simpleinfer_tpu_torch.ir.codegen (pnnx',
        'Graph::python analog). Rebuilds the graph via the IR API."""',
        "import numpy as np",
        "",
        "from simpleinfer_tpu_torch.ir.graph import (",
        "    Attribute, Graph, Parameter,",
        ")",
        "",
        f"_W = np.load({weights_path!r})" if _has_weights(graph) else "",
        "",
        "",
        "def build_graph() -> Graph:",
        "    g = Graph()",
    ]
    for op in graph.ops:
        lines.append(f"    op = g.new_operator({op.type!r}, {op.name!r})")
        for r in op.inputs:
            lines.append(
                f"    r = g.get_or_create_operand({r.name!r}); "
                "r.consumers.append(op); op.inputs.append(r)")
        for r in op.outputs:
            lines.append(
                f"    r = g.get_or_create_operand({r.name!r}); "
                "r.producer = op; op.outputs.append(r)")
            if r.shape:
                lines.append(f"    r.shape = {list(r.shape)!r}; r.type = "
                             f"{r.type}")
        for key, p in op.params.items():
            lines.append(f"    op.params[{key!r}] = "
                         f"Parameter.from_value({_fmt_param(p)})")
        for key in op.attrs:
            lines.append(
                f"    op.attrs[{key!r}] = Attribute.from_array("
                f"_W[{op.name + '.' + key!r}])")
    lines += ["    return g", "", "",
              'if __name__ == "__main__":',
              "    print(build_graph())", ""]
    return "\n".join(l for l in lines if l is not None)


def _has_weights(graph: Graph) -> bool:
    return any(op.attrs for op in graph.ops)


def save_weights_npz(graph: Graph, path: str) -> None:
    """Write every attribute array to a .npz keyed `opname.attrkey`."""
    import numpy as np

    arrays = {}
    for op in graph.ops:
        for key, a in op.attrs.items():
            if a.data is not None:
                arrays[f"{op.name}.{key}"] = a.array()
    np.savez(path, **arrays)


def export_python(graph: Graph, py_path: str, npz_path: str) -> None:
    """Write both the script and the weight sidecar."""
    save_weights_npz(graph, npz_path)
    with open(py_path, "w", encoding="utf-8") as f:
        f.write(graph_to_python(graph, npz_path))
