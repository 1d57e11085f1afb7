"""The port's IR (simpleinfer_tpu_torch.ir, zoo, passes) against the JAX
package's: the same pnnx files parse to identical graphs and write
identical bytes, the YOLOv5 builder yields identical graphs, and the
ported fusion passes rewrite them identically."""
import glob
import os

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from simpleinfer_tpu.ir import passes as jpasses
from simpleinfer_tpu.ir.expression import expand_expression as jexpand
from simpleinfer_tpu.ir.graph import Graph as JGraph
from simpleinfer_tpu.zoo.builders import build_yolov5 as jbuild_yolov5
from simpleinfer_tpu_torch.ir import passes as tpasses
from simpleinfer_tpu_torch.ir.expression import expand_expression as texpand
from simpleinfer_tpu_torch.ir.graph import Graph as TGraph
from simpleinfer_tpu_torch.zoo import GraphBuilder
from simpleinfer_tpu_torch.zoo import build_yolov5 as tbuild_yolov5

HERE = os.path.dirname(os.path.abspath(__file__))
REAL = sorted(glob.glob(os.path.join(HERE, "golden", "pnnx_real",
                                     "*.pnnx.param")))

# params the JAX package's W-packed chain marking adds (a TPU layout
# means the port does not carry)
_TPU_ONLY_PARAMS = ("si_pack_out", "si_pack_in")


def canonical(g, drop_params=()):
    """Every field of a graph, with weights as bytes, in order."""
    ops = []
    for op in g.ops:
        ops.append((
            op.type, op.name,
            [r.name for r in op.inputs], [r.name for r in op.outputs],
            list(op.inputnames),
            sorted((k, p.type, repr(p.value)) for k, p in op.params.items()
                   if k not in drop_params),
            sorted((k, a.type, list(a.shape),
                    None if a.data is None
                    else np.ascontiguousarray(a.array()).tobytes())
                   for k, a in op.attrs.items())))
    operands = [(r.name, r.type, list(r.shape),
                 r.producer.name if r.producer else None,
                 [c.name for c in r.consumers],
                 sorted((k, p.type, repr(p.value))
                        for k, p in r.params.items()))
                for r in g.operands]
    return ops, operands


@pytest.mark.parametrize("param", REAL, ids=os.path.basename)
def test_parse_identical(param):
    binpath = param[:-len(".param")] + ".bin"
    j = JGraph.load(param, binpath)
    t = TGraph.load(param, binpath)
    assert canonical(t) == canonical(j)


@pytest.mark.parametrize("param", REAL, ids=os.path.basename)
def test_save_identical_bytes(param, tmp_path):
    binpath = param[:-len(".param")] + ".bin"
    j = JGraph.load(param, binpath)
    t = TGraph.load(param, binpath)
    j.save(str(tmp_path / "j.param"), str(tmp_path / "j.bin"))
    t.save(str(tmp_path / "t.param"), str(tmp_path / "t.bin"))
    assert (tmp_path / "t.param").read_bytes() == \
        (tmp_path / "j.param").read_bytes()
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    # and the port reads back what it wrote
    back = TGraph.load(str(tmp_path / "t.param"), str(tmp_path / "t.bin"))
    assert canonical(back)[0] == canonical(TGraph.load(
        str(tmp_path / "j.param"), str(tmp_path / "j.bin")))[0]


@pytest.mark.parametrize("kw", [
    dict(variant="n", batch=1, image_size=32),
    dict(variant="s", batch=2, image_size=64, seed=3),
])
def test_build_yolov5_identical(kw):
    jg, jin, jout = jbuild_yolov5(**kw)
    tg, tin, tout = tbuild_yolov5(**kw)
    assert (tin, tout) == (jin, jout)
    assert canonical(tg) == canonical(jg)


@pytest.mark.parametrize("variant", ["n", "s"])
def test_fusions_identical(variant):
    """expand_expression + the ported fusions rewrite a YOLOv5 graph as
    the JAX package's passes do (apart from its packed-chain markers),
    and the counts are those of a YOLOv5: every conv takes its SiLU, 22
    pointwise convs stay single-input, the C3/SPPF cats are split."""
    jg, _, _ = jbuild_yolov5(variant, batch=1, image_size=64)
    tg, _, _ = tbuild_yolov5(variant, batch=1, image_size=64)
    jexpand(jg)
    texpand(tg)
    jstats = jpasses.run_inference_fusions(jg)
    tstats = tpasses.run_inference_fusions(tg)
    for key in ("conv_bn", "conv_act", "cat_conv"):
        assert tstats[key] == jstats[key]
    assert canonical(tg, _TPU_ONLY_PARAMS) == canonical(jg, _TPU_ONLY_PARAMS)
    pointwise = [op for op in tg.ops if op.type == "nn.Conv2d"
                 and op.params["kernel_size"].value == [1, 1]]
    assert sum(len(op.inputs) == 1 for op in pointwise) == 22
    assert sum(len(op.inputs) > 1 for op in pointwise) == 17
    assert {op.type for op in tg.ops} == {
        "pnnx.Input", "pnnx.Output", "nn.Conv2d", "BinaryOp",
        "nn.MaxPool2d", "nn.Upsample", "models.yolo.Detect"}


def _conv_bn_act_graph(builder):
    x = builder.input([1, 4, 6, 6], name="0")
    y = builder.bn(builder.conv(x, 8, 3, bias=False))
    y = builder.hardswish(y)
    z = builder.relu(builder.bn(builder.conv(y, 8, 1)))
    builder.output(builder.mul(z, y))
    return builder.build()


def test_conv_bn_fold_identical():
    from simpleinfer_tpu.zoo.builders import GraphBuilder as JBuilder

    jg = _conv_bn_act_graph(JBuilder(seed=5))
    tg = _conv_bn_act_graph(GraphBuilder(seed=5))
    assert canonical(tg) == canonical(jg)
    jexpand(jg)
    texpand(tg)
    assert (jpasses.fuse_conv_bn(jg), jpasses.fuse_conv_activation(jg)) == \
        (tpasses.fuse_conv_bn(tg), tpasses.fuse_conv_activation(tg)) == \
        (2, 2)
    assert canonical(tg) == canonical(jg)
