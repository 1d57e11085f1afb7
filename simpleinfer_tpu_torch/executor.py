"""Graph executor: pnnx graph -> a Program (plain Python function over the
topo-sorted plan + weights).

The counterpart of simpleinfer_tpu/executor.py. The JAX package traces
its plan into one jit-compiled XLA program; PyTorch runs eagerly, so here
`Program.fn` walks the plan and calls each op's lowering in order. The
load lifecycle is the same:

    CreateGraph       -> ir.Graph.load + expand_expression
    (fusions)         -> ir.passes.run_inference_fusions
    CreateTensorNodes -> input/output discovery by op type, then degree;
                         NCHW -> NHWC declared shapes
    CreateLayers      -> ops.lower_operator per op, int8w / int8 / int4w
                         quantization of `quantizable` weights
    CreatePipeline    -> the topo-sorted plan
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from .config import EngineConfig
from .ir.expression import expand_expression
from .ir.graph import Graph, Operand
from .ir.passes import run_inference_fusions
from .ops import OpImpl, lower_operator
from .quant.tensor import quantize_int4_grouped, quantize_per_channel


def nchw_shape_to_nhwc(shape: list) -> list:
    """Declared pnnx shapes are NCHW; runtime tensors are NHWC (rank 4)."""
    if len(shape) == 4:
        n, c, h, w = shape
        return [n, h, w, c]
    return list(shape)


@dataclass
class TensorSpec:
    """Runtime metadata for one graph input or output operand."""

    name: str
    shape: list  # NHWC for rank-4, -1 = dynamic (batch)
    # token ids consumed only by nn.Embedding: staged as float32 (exact
    # ids up to 2^24) whatever the compute dtype
    token: bool = False


@dataclass
class Program:
    """A lowered model: plain function + weights."""

    inputs: list  # list[TensorSpec] in declaration order
    outputs: list  # list[TensorSpec]
    impls: list  # list[OpImpl] in topo order
    weights: dict  # op name -> {weight key -> tensor | QuantizedTensor}
    fn: Callable  # fn(weights, inputs_dict) -> outputs_dict
    # execution plan: [(OpImpl, input operand names, output operand names)]
    plan: list = field(default_factory=list)
    # HOST-only pre-quantization fp32 weights of the ops a per-channel
    # activation scale can fold into (OpImpl.act_fold), for quant="int8":
    # op name -> HWIO / [in, out] tensor. The fold
    # (engine._install_act_scales) requantizes w·s from these, not from
    # the quantized weight, whose per-out-channel scales may have zeroed
    # small input channels. Never placed on the device.
    fp_weights: dict = field(default_factory=dict)

    @property
    def input_names(self) -> list:
        return [s.name for s in self.inputs]

    @property
    def output_names(self) -> list:
        return [s.name for s in self.outputs]


class GraphError(ValueError):
    pass


def _toposort(graph: Graph) -> list:
    """Topological order over operators (producer before consumer);
    keeps the executor independent of serialization order."""
    indeg = {id(op): 0 for op in graph.ops}
    name_to_producer = {}
    for op in graph.ops:
        for r in op.outputs:
            name_to_producer[r.name] = op
    edges = {id(op): [] for op in graph.ops}
    for op in graph.ops:
        for r in op.inputs:
            p = name_to_producer.get(r.name)
            if p is not None and p is not op:
                edges[id(p)].append(op)
                indeg[id(op)] += 1
    ready = deque(op for op in graph.ops if indeg[id(op)] == 0)
    order = []
    while ready:
        op = ready.popleft()
        order.append(op)
        for c in edges[id(op)]:
            indeg[id(c)] -= 1
            if indeg[id(c)] == 0:
                ready.append(c)
    if len(order) != len(graph.ops):
        raise GraphError("graph contains a cycle")
    return order


def discover_io(graph: Graph) -> tuple:
    """Input/output operands, by op type first then by degree (no
    producer -> input, no consumer -> output)."""
    inputs, outputs = [], []
    for op in graph.ops:
        if op.type == "pnnx.Input":
            inputs.extend(op.outputs)
        elif op.type == "pnnx.Output":
            outputs.extend(op.inputs)
    if not inputs:
        inputs = [r for r in graph.operands if r.producer is None]
    if not outputs:
        outputs = [r for r in graph.operands if not r.consumers]
    if not inputs:
        raise GraphError("graph has no inputs")
    if not outputs:
        raise GraphError("graph has no outputs")
    return inputs, outputs


def _spec_for(operand: Operand) -> TensorSpec:
    return TensorSpec(name=operand.name,
                      shape=nchw_shape_to_nhwc(operand.shape),
                      token=bool(operand.consumers) and all(
                          op.type == "nn.Embedding"
                          for op in operand.consumers))


def build_program(graph: Graph, cfg: Optional[EngineConfig] = None) -> Program:
    """Lower a pnnx graph to a Program. Mutates `graph` (expression
    expansion and fusions run in place, as in the JAX package)."""
    cfg = cfg or EngineConfig()
    expand_expression(graph)
    if cfg.fuse:
        run_inference_fusions(graph, cfg)
    order = _toposort(graph)
    input_operands, output_operands = discover_io(graph)

    impls: list[OpImpl] = []
    weights: dict = {}
    fp_weights: dict = {}
    plan: list[tuple] = []
    for op in order:
        if op.type in ("pnnx.Input", "pnnx.Output"):
            continue
        impl = lower_operator(op, cfg)
        if cfg.quant in ("int8w", "int8", "int4w"):
            for key, axis in impl.quantizable.items():
                if key not in impl.weights:
                    continue
                # kept for any int8 engine, so that a per-channel
                # calibration artifact loads whatever act_per_channel
                # this engine was built with
                if (key == "weight" and cfg.quant == "int8"
                        and impl.act_fold):
                    fp_weights[impl.name] = impl.weights[key]
                w = impl.weights[key].numpy()
                if cfg.quant == "int4w" and w.ndim == 2 and axis == 1:
                    # the W4 serving dtype: 2-D [in, out] weights are
                    # group-quantized and nibble-packed; 4-D conv
                    # weights keep per-channel int8
                    impl.weights[key] = quantize_int4_grouped(
                        w, group=cfg.int4_group)
                else:
                    impl.weights[key] = quantize_per_channel(w, axis)
        impls.append(impl)
        weights[impl.name] = impl.weights
        plan.append((impl, [r.name for r in op.inputs],
                     [r.name for r in op.outputs]))

    output_names = [r.name for r in output_operands]

    def fn(weights, inputs):
        env = dict(inputs)
        for impl, in_names, out_names in plan:
            args = []
            for n in in_names:
                if n not in env:
                    raise GraphError(
                        f"op {impl.name!r} consumes operand {n!r} before it "
                        f"is produced")
                args.append(env[n])
            out = impl.apply(weights[impl.name], *args)
            if impl.n_outputs == 1:
                env[out_names[0]] = out
            else:
                for n, o in zip(out_names, out):
                    env[n] = o
        return {n: env[n] for n in output_names}

    return Program(
        inputs=[_spec_for(r) for r in input_operands],
        outputs=[_spec_for(r) for r in output_operands],
        impls=impls,
        weights=weights,
        fn=fn,
        plan=plan,
        fp_weights=fp_weights,
    )
