"""YOLOv8 in the port (models.yolo.DetectV8, build_yolov8) and the
reduction / softmax ops against the JAX package, on the CPU.

- builder graphs: the same .pnnx.param text and .bin bytes as JAX's;
- fp32 forwards: the golden tolerance of tests/test_golden.py (atol =
  rtol = 5e-4 x scale, scale = max(1, max|out|));
- int8w bf16 on the same quantized bytes: max |diff| <= 2^-5 x scale and
  mean <= 1e-4 x scale, as tests/test_torch_engine.py holds YOLOv5s.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.ir.graph import Graph as JGraph
from simpleinfer_tpu.zoo.builders import build_yolov8 as jbuild
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.ir.graph import Graph
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.zoo import build_yolov8


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) / 3


@pytest.mark.parametrize("variant,image,nc,reg_max", [
    ("n", 64, 80, 16), ("s", 64, 80, 16), ("n", 96, 7, 8),
    ((0.25, 0.125), 64, 3, 4)])
def test_build_yolov8_graph_identical_to_jax(tmp_path, variant, image, nc,
                                             reg_max):
    gt, it, ot = build_yolov8(variant, batch=2, image_size=image,
                              num_classes=nc, reg_max=reg_max)
    gj, ij, oj = jbuild(variant, batch=2, image_size=image,
                        num_classes=nc, reg_max=reg_max)
    assert (it, ot) == (ij, oj)
    gt.save(str(tmp_path / "t.param"), str(tmp_path / "t.bin"))
    gj.save(str(tmp_path / "j.param"), str(tmp_path / "j.bin"))
    for ext, mode in (("param", "r"), ("bin", "rb")):
        assert open(tmp_path / f"t.{ext}", mode).read() == \
            open(tmp_path / f"j.{ext}", mode).read()


@pytest.mark.parametrize("image", [64, 96])
def test_yolov8n_fp32_matches_jax(image):
    gt, i, o = build_yolov8("n", batch=2, image_size=image)
    gj, _, _ = jbuild("n", batch=2, image_size=image)
    x = _images((2, image, image, 3))
    got = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=gt).run({i: x})[o]
    want = JEngine(JCfg()).load_model(None, graph=gj).run({i: x})[o]
    assert got.shape == (2, sum((image // s) ** 2 for s in (8, 16, 32)), 84)
    golden_close(got, want)


def test_yolov8s_int8w_bf16_matches_jax_same_bytes():
    from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
    from simpleinfer_tpu_torch.convert import program_weights_from_numpy

    gt, i, o = build_yolov8("s", batch=1, image_size=64)
    gj, _, _ = jbuild("s", batch=1, image_size=64)
    cfg = dict(quant="int8w", compute_dtype="bfloat16")
    je = JEngine(JCfg(**cfg)).load_model(None, graph=gj)
    pe = Engine(EngineConfig(device="cpu", **cfg)).load_model(None, graph=gt)
    weights = {op: {k: ((np.asarray(v.data), np.asarray(v.scale), v.axis)
                        if isinstance(v, JQ) else np.asarray(v))
                    for k, v in d.items()}
               for op, d in je.program.weights.items()}
    pe._device_weights = pe.place_weights(program_weights_from_numpy(
        weights, device="cpu"), pe.program)
    x = _images((1, 64, 64, 3), 1)
    got, want = pe.run({i: x})[o], je.run({i: x})[o]
    scale = max(1.0, float(np.abs(want).max()))
    d = np.abs(got - want)
    assert d.max() <= 2 ** -5 * scale and d.mean() <= 1e-4 * scale


def test_yolov8s_pointwise_convs_reach_matmul_int8w(monkeypatch):
    """With kernels on, YOLOv8s calls matmul_int8w 11 times a forward
    (chip_smoke.YOLOV8S_POINTWISE); with kernels off, never."""
    calls = []
    orig = tmm.matmul_int8w

    def spy(x, w_q, *a, **kw):
        calls.append((tuple(x.shape), tuple(w_q.shape)))
        return orig(x, w_q, *a, **kw)

    monkeypatch.setattr(tmm, "matmul_int8w", spy)
    for use_kernels, want in ((True, 11), (False, 0)):
        calls.clear()
        g, i, o = build_yolov8("s", batch=1, image_size=64)
        eng = Engine(EngineConfig(device="cpu", quant="int8w",
                                  compute_dtype="bfloat16",
                                  use_kernels=use_kernels))
        out = eng.load_model(None, graph=g).run(
            {i: _images((1, 64, 64, 3))})[o]
        assert len(calls) == want and np.isfinite(out).all()


# ---- models.yolo.DetectV8 on a hand-written graph --------------------------
def _detect_v8_graph(graph_cls, nc, reg_max, hw, strides, batch=2):
    g = graph_cls()
    no = 4 * reg_max + nc
    op = g.new_operator("models.yolo.DetectV8", "detect")
    from simpleinfer_tpu_torch.ir.graph import Attribute, Parameter
    for k, (h, w) in enumerate(hw):
        inp = g.new_operator("pnnx.Input", f"in{k}")
        r = g.get_or_create_operand(f"x{k}")
        r.producer = inp
        inp.outputs.append(r)
        r.shape = [batch, no, h, w]
        r.consumers.append(op)
        op.inputs.append(r)
    out = g.get_or_create_operand("y")
    out.producer = op
    op.outputs.append(out)
    op.params["nc"] = Parameter.from_value(nc)
    op.params["reg_max"] = Parameter.from_value(reg_max)
    op.attrs["strides"] = Attribute.from_array(np.asarray(strides,
                                                          np.float32))
    return g


@pytest.mark.parametrize("nc,reg_max,hw,strides", [
    (80, 16, [(8, 8), (4, 4), (2, 2)], (8.0, 16.0, 32.0)),
    (3, 4, [(5, 7), (3, 4)], (4.0, 8.0)),
    (1, 1, [(6, 6)], (16.0,))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_v8_op_matches_jax(tmp_path, nc, reg_max, hw, strides, dtype):
    """The DFL decode of the port against the JAX lowering, fed the same
    per-level maps; computed in f32 whatever the engine's dtype."""
    g = _detect_v8_graph(Graph, nc, reg_max, hw, strides)
    g.save(str(tmp_path / "d.param"), str(tmp_path / "d.bin"))
    gj = JGraph.load(str(tmp_path / "d.param"), str(tmp_path / "d.bin"))
    rng = np.random.default_rng(5)
    feeds = {f"x{k}": (rng.standard_normal((2, h, w, 4 * reg_max + nc))
                       * 3).astype(np.float32) for k, (h, w) in
             enumerate(hw)}
    pe = Engine(EngineConfig(device="cpu", compute_dtype=dtype))
    out_p = pe.load_model(None, graph=g).run(feeds)["y"]
    out_j = JEngine(JCfg(compute_dtype=dtype)).load_model(
        None, graph=gj).run(feeds)["y"]
    assert out_p.shape == (2, sum(h * w for h, w in hw), 4 + nc)
    if dtype == "float32":
        golden_close(out_p, out_j)
    else:        # both round the inputs to bf16, then decode in f32
        scale = max(1.0, float(np.abs(out_j).max()))
        np.testing.assert_allclose(out_p, out_j, atol=1e-5 * scale)


def test_detect_v8_rejects_bad_widths():
    g = _detect_v8_graph(Graph, 3, 4, [(4, 4)], (8.0,))
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=g)
    with pytest.raises(ValueError, match="channels"):
        eng.run({"x0": np.zeros((2, 4, 4, 5), np.float32)})
    g = _detect_v8_graph(Graph, 3, 4, [(4, 4), (2, 2)], (8.0,))
    with pytest.raises(ValueError, match="strides"):
        Engine(EngineConfig(device="cpu")).load_model(None, graph=g)


# ---- torch.mean / sum / amax and F.softmax on a hand-written graph -------
def test_reductions_and_softmax_graph_matches_jax(tmp_path):
    """A graph chaining the four ops over logical NCHW dims (physical
    NHWC storage): mean over H keepdim, sum over W, amax over C, softmax
    over the last dim — against the JAX lowering of the same file."""
    param = "\n".join([
        "7767517",
        "6 6",
        "pnnx.Input in 0 1 x",
        "torch.mean m 1 1 x a dim=(2) keepdim=True",
        "F.softmax s 1 1 a b dim=1",
        "torch.sum su 1 1 b c dim=(3) keepdim=False",
        "torch.amax am 1 1 c d dim=(1) keepdim=True",
        "pnnx.Output out 1 0 d", ""])
    (tmp_path / "g.param").write_text(param)
    from simpleinfer_tpu_torch.ir.storezip import StoreZipWriter
    with StoreZipWriter(str(tmp_path / "g.bin")):
        pass
    x = _images((2, 5, 6, 7), 2) * 3
    got = Engine(EngineConfig(device="cpu")).load_model(
        str(tmp_path / "g.param"), str(tmp_path / "g.bin")).run({"x": x})
    want = JEngine(JCfg()).load_model(
        str(tmp_path / "g.param"), str(tmp_path / "g.bin")).run({"x": x})
    golden_close(got["d"], want["d"])
    # the same chain in torch on the logical NCHW array
    t = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))
    ref = torch.softmax(t.mean(2, keepdim=True), 1).sum(3).amax(1,
                                                                keepdim=True)
    golden_close(got["d"], ref.numpy())

