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

Under a device mesh (EngineConfig.mesh) every rank runs `ShardedWalk`
over the same plan on its shard, where the JAX package lets GSPMD
partition one program: the collectives XLA would insert are written out
here (parallel/mesh.py, parallel/tp.py).
"""
from __future__ import annotations

import copy
import logging
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .config import EngineConfig
from .ir.expression import expand_expression
from .ir.graph import PARAM_AINT, Graph, Operand, Parameter
from .ir.passes import run_inference_fusions
from .ops import OpImpl, lower_operator
from .parallel.mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SPATIAL,
                            all_gather, axis_index, axis_size, exchange,
                            weight_shardings)
from .quant.tensor import (QuantizedActivation, quantize_int4_grouped,
                           quantize_per_channel)


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
    # op name -> how the op runs on height-sharded activations (the
    # `spatial` mesh axis; `spatial_rule`)
    spatial: dict = field(default_factory=dict)
    # what op_output_shapes walks at its first read: the batch given to
    # every input (a data-sharded rank's rows; None: each input's
    # declared dims, a dynamic one taken as 1) and the items it holds
    walk_batch: Optional[int] = None
    walk_items: int = 1
    _shapes: object = field(default=None, init=False, repr=False,
                            compare=False)

    @property
    def op_output_shapes(self) -> Optional[dict]:
        """op name -> the op's inferred output shapes (NHWC) at the
        declared input shapes (_infer_op_shapes), walked at the first
        read and kept: a load that never asks pays nothing. None when an
        input's shape is undeclared or an op cannot run on fake
        tensors."""
        if self._shapes is None:
            self._shapes = (_infer_op_shapes(self.plan, self.inputs,
                                             self.walk_batch),)
        return self._shapes[0]

    @property
    def flops_per_item(self) -> Optional[int]:
        """Forward FLOPs of one batch item (roofline), the sum of
        op_flops; None when op_output_shapes is, never a partial
        count."""
        if self.op_output_shapes is None:
            return None
        return sum(self.op_flops(impl) for impl in self.impls)

    def op_flops(self, impl: OpImpl) -> int:
        """impl's FLOPs for one batch item, from its inferred shapes;
        raises when there are none (op_output_shapes is None)."""
        shapes = self.op_output_shapes
        if shapes is None:
            raise ValueError(
                "no FLOP count: the op shapes are unknown (an input's shape "
                "is undeclared, or an op could not run on fake tensors; "
                "see the warning at the first read)")
        return _estimate_flops(impl, shapes[impl.name], self.walk_items)

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


def _infer_op_shapes(plan: list, input_specs: list,
                     batch: Optional[int] = None) -> Optional[dict]:
    """Every op's output shapes, from a walk of the plan on fake tensors
    (torch's FakeTensorMode: shapes and dtypes, no storage, no FLOPs
    spent) at the declared input shapes, a dynamic dim taken as 1 and
    the batch as `batch` where given (a data-sharded rank's rows): the
    counterpart of the JAX package's jax.eval_shape walk. The kernel
    wrappers see fake tensors and answer from their custom ops' fake
    implementations (kernels/__init__.py), so nothing launches. Returns
    None when an input's shape is undeclared, or when an op cannot run
    on fake tensors (one that reads its input's values on the host; a
    warning names it): no FLOP count is then better than a partial
    one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if any(not s.shape for s in input_specs):
        return None
    shapes: dict = {}
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        env = {}
        for s in input_specs:
            shape = [1 if d == -1 else int(d) for d in s.shape]
            if batch is not None:
                shape[0] = batch
            env[s.name] = torch.empty(shape, dtype=torch.float32)
        for impl, in_names, out_names in plan:
            try:
                # a copy: nothing the op might keep reaches its weights
                out = impl.apply(dict(impl.weights),
                                 *[env[n] for n in in_names])
            except (RuntimeError, TypeError, ValueError,
                    NotImplementedError) as e:
                logging.getLogger("simpleinfer_tpu_torch").warning(
                    "shape inference stopped at op %r (%s), so the program "
                    "has no FLOP count: %s", impl.name, impl.type, e)
                return None
            outs = [out] if impl.n_outputs == 1 else list(out)
            for n, o in zip(out_names, outs):
                env[n] = o
            shapes[impl.name] = [list(_data_of(o).shape) for o in outs]
    return shapes


def _estimate_flops(impl: OpImpl, out_shapes: list, items: int = 1) -> int:
    """An op's FLOPs for one batch item, from its output shapes at
    `items` batch items: flops_per_pixel times its first output's H*W
    where that output is rank 4; flops_per_element times its first
    output's elements an item (nn.Linear: every row, a token or a
    pixel); else flops_per_item."""
    if impl.flops_per_pixel and out_shapes:
        s = out_shapes[0]
        if len(s) == 4:
            return impl.flops_per_pixel * int(s[1]) * int(s[2])
    if impl.flops_per_element and out_shapes:
        return impl.flops_per_element * math.prod(out_shapes[0]) // items
    return impl.flops_per_item


# ---- the spatial axis: how each op runs on height-sharded activations ---
_SP_POINTWISE = {
    "BinaryOp", "UnaryOp", "nn.BatchNorm2d", "nn.PReLU", "nn.LeakyReLU",
    "nn.ELU", "nn.GELU", "nn.Tanh", "F.leaky_relu", "F.elu", "F.gelu",
    "F.tanh", "torch.clamp", "nn.ReLU", "nn.Sigmoid", "nn.SiLU",
    "nn.Hardsigmoid", "nn.Hardswish", "F.relu", "F.sigmoid", "F.silu",
    "F.hardsigmoid", "F.hardswish", "nn.ReLU6", "F.relu6", "nn.Mish",
    "F.mish", "nn.Identity", "nn.Dropout", "nn.Dropout2d",
    "Tensor.contiguous", "torch.clone",
}
_SP_POOLS = {"nn.MaxPool2d": -float("inf"), "F.max_pool2d": -float("inf"),
             "nn.AvgPool2d": 0.0, "F.avg_pool2d": 0.0}
_SP_UPSAMPLE = ("nn.Upsample", "nn.UpsamplingNearest2d", "F.interpolate",
                "F.upsample", "F.upsample_nearest")


def _hw(op, key, default):
    """An int or [h, w] param as (h, w)."""
    p = op.params.get(key)
    if p is None or p.value is None:
        return default
    return (p.value, p.value) if isinstance(p.value, int) else \
        tuple(p.value)


def _flag(op, key, default: bool) -> bool:
    p = op.params.get(key)
    return default if p is None or p.value is None else bool(p.value)


def spatial_rule(op) -> tuple:
    """How the walk runs `op` on activations sharded over height:
    ("local",) — every output row needs only its own input rows
    (pointwise ops, channel concat, integer nearest upsampling);
    ("window", k, s, p, dilation, fill) — a conv or pool over H that
    takes a halo from its neighbours, padded with `fill` at the image's
    true edges; ("gather",) — the op needs the whole height (flatten,
    global pooling, linear, attention, YOLO grids, ...): the walk
    all-gathers its sharded inputs and the op runs replicated."""
    t = op.type
    if t in _SP_POINTWISE:
        return ("local",)
    if t == "torch.cat":
        p = op.params.get("dim")
        return ("local",) if p is not None and p.value in (1, -3) \
            else ("gather",)
    if t == "nn.Conv2d" or t in _SP_POOLS:
        mode = op.params.get("padding_mode")
        k = _hw(op, "kernel_size", None)
        if (mode is not None and mode.value != "zeros") or k is None \
                or _flag(op, "ceil_mode", False):
            return ("gather",)
        s = _hw(op, "stride", k if t in _SP_POOLS else (1, 1))
        pad = _hw(op, "padding", (0, 0))
        if _SP_POOLS.get(t) == 0.0 and pad[0] and (
                not _flag(op, "count_include_pad", True)
                or "divisor_override" in op.params):
            return ("gather",)      # an average over the real rows only
        return ("window", k[0], s[0], pad[0],
                _hw(op, "dilation", (1, 1))[0], _SP_POOLS.get(t, 0.0))
    if t in _SP_UPSAMPLE:
        mode = op.params.get("mode")
        sf = op.params.get("scale_factor")
        if (mode is None or mode.value == "nearest") and sf is not None:
            f = sf.value[0] if isinstance(sf.value, list) else sf.value
            if float(f) == int(f) and int(f) >= 1:
                return ("local",)
        return ("gather",)
    return ("gather",)


# reshapes / views / expands whose params name the graph's batch
_BATCH_SHAPED = ("torch.reshape", "Tensor.reshape", "Tensor.view",
                 "Tensor.expand")


def _rank_batch_op(op, batch: int, data: int):
    """`op` with a leading `shape` entry equal to the graph's batch set
    to this rank's rows (batch / data): under the `data` axis a rank
    runs the graph on its rows, where a reshape of the whole batch
    would not fit. Other ops come back as they are."""
    p = op.params.get("shape")
    if (op.type not in _BATCH_SHAPED or p is None or p.type != PARAM_AINT
            or not p.value or p.value[0] != batch):
        return op
    local = copy.copy(op)
    local.params = dict(op.params)
    local.params["shape"] = Parameter(PARAM_AINT,
                                      [batch // data] + list(p.value[1:]))
    return local


def build_program(graph: Graph, cfg: Optional[EngineConfig] = None) -> Program:
    """Lower a pnnx graph to a Program. Mutates `graph` (expression
    expansion and fusions run in place, as in the JAX package). Under a
    mesh with data > 1 the program is a rank's: its reshapes of the
    graph's batch take the rank's rows (`_rank_batch_op`)."""
    cfg = cfg or EngineConfig()
    expand_expression(graph)
    if cfg.fuse:
        run_inference_fusions(graph, cfg)
    order = _toposort(graph)
    input_operands, output_operands = discover_io(graph)
    data = cfg.mesh.data if cfg.mesh is not None else 1
    batch = next((r.shape[0] for r in input_operands
                  if r.shape and r.shape[0] > 0), None)

    impls: list[OpImpl] = []
    weights: dict = {}
    fp_weights: dict = {}
    plan: list[tuple] = []
    spatial: dict = {}
    for op in order:
        if op.type in ("pnnx.Input", "pnnx.Output"):
            continue
        if data > 1 and batch is not None and batch % data == 0:
            op = _rank_batch_op(op, batch, data)
        impl = lower_operator(op, cfg)
        spatial[impl.name] = spatial_rule(op)
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
    input_specs = [_spec_for(r) for r in input_operands]
    walk_batch = (batch // data if data > 1 and batch is not None
                  and batch % data == 0 else None)

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
        inputs=input_specs,
        outputs=[_spec_for(r) for r in output_operands],
        impls=impls,
        weights=weights,
        fn=fn,
        plan=plan,
        fp_weights=fp_weights,
        spatial=spatial,
        walk_batch=walk_batch,
        walk_items=walk_batch or batch or 1,
    )


# ---- the sharded walk ----------------------------------------------------
def _data_of(x):
    return x.data if isinstance(x, QuantizedActivation) else x


def _like(x, data):
    """`data` in the wrapper of x (an int8 chain activation keeps its
    scale)."""
    if isinstance(x, QuantizedActivation):
        return QuantizedActivation(data=data, scale=x.scale)
    return data


def op_shardings(program: Program, mesh, tp_mode: str = "gspmd",
                 use_kernels: bool = True) -> dict:
    """{op name: (mode, weight specs, apply)} for this rank: "column"
    (conv / linear / embedding weights sharded on their output channels
    by parallel/mesh.weight_shardings: the op computes its output
    channels and the walk all-gathers them), "heads" (an attention op
    whose heads divide the model axis: OpImpl.tp_apply over this rank's
    heads, its row-parallel output projection reduced by
    parallel/tp.RowParallel) or "replicated" (every weight whole: no
    hints, a model axis of 1, or a shard the op cannot run, such as an
    attention op whose heads do not divide the axis)."""
    from .parallel.tp import RowParallel

    m = axis_size(mesh, AXIS_MODEL)
    reduce = RowParallel(mesh, tp_mode, use_kernels)
    out = {}
    for impl in program.impls:
        specs = weight_shardings(mesh, program.weights[impl.name],
                                 impl.shard_hints)
        mode, apply = "replicated", impl.apply
        if any(specs.values()):
            if impl.tp_apply is None:
                mode = "column"
            else:
                apply = impl.tp_apply(m, axis_index(mesh, AXIS_MODEL),
                                      reduce)
                if apply is None:
                    apply = impl.apply
                    specs = {k: () for k in specs}
                else:
                    mode = "heads"
        out[impl.name] = (mode, specs, apply)
    return out


class ShardedWalk:
    """One rank's forward over a mesh: fn(weights, inputs) -> the global
    outputs, on every rank.

    `inputs` are this rank's shards (Engine.input): its batch rows on
    `data`, and for rank-4 inputs its height rows on `spatial`. Per op:
    - model: a "column" op runs on its weight shard and all-gathers its
      output channels over the model group; a "heads" op runs its heads
      and reduces its output projection inside (op_shardings);
    - spatial: a "window" op (spatial_rule) takes a halo of rows from
      its neighbours (top: ceil(p / s) * s rows, bottom: k - s - p rows,
      cropped when negative; `fill` rows at the true edges), runs on
      the slab and keeps its own output rows; where h_local % s != 0,
      a halo outgrows a neighbour's rows or the output rows do not
      split evenly, and for "gather" ops, the walk all-gathers the
      height and carries on replicated. "local" ops run on the rows;
    - data: nothing — the batch stays sharded to the outputs, which are
      all-gathered (height, then batch) at the end.
    `observe(impl, args, sharded)` is called before each op with its
    inputs as the rank holds them and which of them are height-sharded
    (the calibration observer under a mesh)."""

    def __init__(self, program: Program, mesh, shardings: dict):
        self.program = program
        self.mesh = mesh
        self.shardings = shardings
        self.spatial = axis_size(mesh, AXIS_SPATIAL)
        self.sp_index = axis_index(mesh, AXIS_SPATIAL)

    # -- the height axis ----------------------------------------------------
    def _gather_h(self, x):
        return _like(x, all_gather(_data_of(x), self.mesh, AXIS_SPATIAL, 1))

    def _rows_of(self, x, h_local):
        """This rank's rows of a replicated rank-4 tensor of the whole
        height (broadcast operands of other heights pass)."""
        d = _data_of(x)
        if not isinstance(d, torch.Tensor) or d.ndim != 4 or \
                d.shape[1] != h_local * self.spatial:
            return x
        i = self.sp_index
        return _like(x, d[:, i * h_local:(i + 1) * h_local])

    def _window_fit(self, x, rule):
        """(top, bottom, skip) halo rows of a window op on this shard, or
        None when the shard cannot run it locally."""
        _, k, s, p, dil, fill = rule
        d = _data_of(x)
        if d is not x and fill != 0.0:
            return None
        h = d.shape[1]
        keff = dil * (k - 1) + 1
        skip = -(-p // s)
        top, bot = skip * s, max(keff - s - p, 0)
        n = self.spatial
        if (h % s or top > h or bot > h
                or (n * h + 2 * p - keff) // s + 1 != n * h // s):
            return None
        return top, bot, skip

    def _halo(self, x, top: int, bot: int, fill: float):
        """x with `top` rows of the previous rank above and `bot` rows of
        the next one below (fill rows past the image's edges)."""
        d = _data_of(x)
        j, n = self.sp_index, self.spatial
        sends, recvs = [], []
        if top:
            if j + 1 < n:
                sends.append((d[:, -top:], j + 1))
            if j > 0:
                recvs.append((d[:, :top], j - 1))
        if bot:
            if j > 0:
                sends.append((d[:, :bot], j - 1))
            if j + 1 < n:
                recvs.append((d[:, -bot:], j + 1))
        got = exchange(self.mesh, AXIS_SPATIAL, sends, recvs)
        parts = []
        if top:
            parts.append(got.pop(0) if j > 0 else torch.full_like(
                d[:, :top], fill))
        parts.append(d)
        if bot:
            parts.append(got.pop(0) if j + 1 < n else torch.full_like(
                d[:, :bot], fill))
        return _like(x, torch.cat(parts, dim=1) if len(parts) > 1 else d)

    # -- the walk -----------------------------------------------------------
    def __call__(self, weights, inputs, observe=None):
        env = dict(inputs)
        sharded = {n for n, x in inputs.items()
                   if self.spatial > 1 and x.ndim == 4}
        for impl, in_names, out_names in self.program.plan:
            args = []
            for n in in_names:
                if n not in env:
                    raise GraphError(
                        f"op {impl.name!r} consumes operand {n!r} before "
                        f"it is produced")
                args.append(env[n])
            sh = [n in sharded for n in in_names]
            if observe is not None:
                observe(impl, args, sh)
            mode, _specs, apply = self.shardings[impl.name]
            crop, out_sharded = None, False
            if any(sh):
                rule = self.program.spatial.get(impl.name, ("gather",))
                fit = (self._window_fit(args[0], rule)
                       if rule[0] == "window" and sh[0] else None)
                if fit is not None or rule[0] == "local":
                    h = next(_data_of(a).shape[1]
                             for a, s in zip(args, sh) if s)
                    args = [a if s else self._rows_of(a, h)
                            for a, s in zip(args, sh)]
                    if fit is not None:
                        top, bot, skip = fit
                        if top or bot:
                            args[0] = self._halo(args[0], top, bot,
                                                 rule[5])
                        crop = (skip, h // rule[2])
                    out_sharded = True
                else:
                    args = [self._gather_h(a) if s else a
                            for a, s in zip(args, sh)]
            out = apply(weights[impl.name], *args)
            if crop is not None:
                d = _data_of(out)
                out = _like(out, d[:, crop[0]:crop[0] + crop[1]])
            if mode == "column":
                out = _like(out, all_gather(_data_of(out), self.mesh,
                                            AXIS_MODEL, -1))
            if impl.n_outputs == 1:
                env[out_names[0]] = out
                if out_sharded:
                    sharded.add(out_names[0])
            else:
                for n, o in zip(out_names, out):
                    env[n] = o
                    if out_sharded:
                        sharded.add(n)
        outs = {}
        for n in self.program.output_names:
            x = env[n]
            if n in sharded:
                x = self._gather_h(x)
            outs[n] = all_gather(x, self.mesh, AXIS_DATA, 0)
        return outs
