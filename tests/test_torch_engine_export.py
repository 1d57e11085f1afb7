"""Engine.export_model / load_exported of the port (torch.export, one
.pt2 file with the weights inside) on the CPU: the counterparts of
tests/test_engine.py's export tests (the round trip within 1e-5 of the
live engine, a batch override with io_layout="nchw", the YOLO head in
its logical shape, a mesh engine refused), the port's artifact against
the JAX package's artifact of the same graph and weights (the golden
tolerance, tests/test_golden.py: 5e-4·scale), a static-int8 C3-fused
graph whose artifact holds the kernels as their custom ops, and one
load in a fresh `python -c` process that builds no graph."""
import os
import sys

import numpy as np
import pytest
import torch

import simpleinfer_tpu.zoo as jzoo
from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu import load_exported as j_load_exported
from simpleinfer_tpu_torch import (Engine, EngineConfig, EngineStateError,
                                   load_exported)
from simpleinfer_tpu_torch.kernels import c3block as kc3
from simpleinfer_tpu_torch.kernels import matmul as kmm
from simpleinfer_tpu_torch.zoo import build_resnet18, build_unet, build_yolov5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
sys.path.remove(ROOT)
FP32 = dict(device="cpu", compute_dtype="float32")


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """A ResNet-18 engine, its feed and output, and its artifact (built
    and exported once for the module)."""
    g, i, o = build_resnet18(batch=2, image_size=32, num_classes=5, width=8)
    eng = Engine(EngineConfig(**FP32)).load_model(None, graph=g)
    x = np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = eng.run({i: x})[o]
    path = str(tmp_path_factory.mktemp("x") / "m.pt2")
    eng.export_model(path)
    return eng, i, o, x, want, path


def test_export_model_roundtrip(resnet):
    _eng, i, o, x, want, path = resnet
    got = load_exported(path)({i: x})[o]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_export_matches_the_jax_artifact(resnet, tmp_path):
    """The same graph and weights exported by both packages: outputs
    within the golden tolerance."""
    _eng, i, o, x, _want, path = resnet
    g, _, _ = jzoo.build_resnet18(batch=2, image_size=32, num_classes=5,
                                  width=8)
    jeng = JEngine(JConfig(compute_dtype="float32")).load_model(None,
                                                                graph=g)
    jpath = str(tmp_path / "m.shlo")
    jeng.export_model(jpath)
    want = np.asarray(j_load_exported(jpath)({i: x})[o], np.float32)
    got = load_exported(path)({i: x})[o]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def test_export_model_batch_override_and_nchw(tmp_path):
    g, i, o = build_unet(batch=1, image_size=32, num_classes=3, width=8,
                         depth=1)
    eng = Engine(EngineConfig(io_layout="nchw", **FP32)).load_model(
        None, graph=g)
    path = str(tmp_path / "m.pt2")
    eng.export_model(path, batch=2)
    x = np.random.default_rng(6).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    got = load_exported(path)({i: x})[o]
    assert got.shape == (2, 3, 32, 32)
    eng.input(i, x)
    eng.forward()
    np.testing.assert_allclose(got, eng.extract(o), atol=1e-5)


def test_export_model_yolo_head_logical_shape(tmp_path):
    g, i, o = build_yolov5("n", batch=1, image_size=32)
    eng = Engine(EngineConfig(**FP32)).load_model(None, graph=g)
    x = np.random.default_rng(7).standard_normal(
        (1, 32, 32, 3)).astype(np.float32) / 4
    want = eng.run({i: x})[o]
    path = str(tmp_path / "y.pt2")
    eng.export_model(path)
    got = load_exported(path)({i: x})[o]
    assert got.shape == want.shape == (1, 63, 85)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_export_model_rejects_mesh_engine(resnet, tmp_path):
    """A mesh engine's weights are its rank's shards: export refuses it
    (the sharded export itself runs in tests/test_torch_mesh_engine.py's
    ranks)."""
    eng = resnet[0]
    eng._mesh = object()
    try:
        with pytest.raises(EngineStateError, match="single-device"):
            eng.export_model(str(tmp_path / "x.pt2"))
    finally:
        eng._mesh = None


def test_export_bf16_int8w_keeps_the_kernel_op(tmp_path, monkeypatch):
    """A bf16 int8w engine with its kernels on exports matmul_int8w as
    torch.ops.simpleinfer.matmul_int8w, tracing through the op's fake
    implementation (no call of the wrapper's body); the artifact runs
    its CPU implementation (the plain version) as the live engine
    does."""
    g, i, o = build_yolov5("n", batch=1, image_size=32)
    eng = Engine(EngineConfig(device="cpu", quant="int8w",
                              use_kernels=True)).load_model(None, graph=g)
    x = np.random.default_rng(8).standard_normal(
        (1, 32, 32, 3)).astype(np.float32) / 4
    want = eng.run({i: x})[o]
    path = str(tmp_path / "q.pt2")
    calls = []
    real = kmm._matmul_int8w
    monkeypatch.setattr(kmm, "_matmul_int8w",
                        lambda *a: calls.append(a) or real(*a))
    eng.export_model(path)
    assert calls == []
    ops = _custom_ops(path)
    assert ops == {"simpleinfer.matmul_int8w.default"}
    np.testing.assert_array_equal(load_exported(path)({i: x})[o], want)


def _custom_ops(path) -> set:
    ep = torch.export.load(path)
    return {str(n.target) for n in ep.graph.nodes
            if str(n.target).startswith("simpleinfer.")}


def test_static_int8_c3_export_records_the_kernels(tmp_path, monkeypatch):
    """A calibrated static-int8 yolov5n with c3_fusion (every block on
    c3_block: its gate at 0): the artifact's graph holds
    simpleinfer::matmul_s8s8 and simpleinfer::c3_block, and the
    artifact equals the live engine."""
    monkeypatch.setattr(kc3, "C3_MIN_WORK", 0)
    g, i, o = build_yolov5("n", batch=1, image_size=32)
    eng = Engine(EngineConfig(quant="int8", c3_fusion=True, use_kernels=True,
                              **FP32)).load_model(None, graph=g)
    x = np.random.default_rng(9).standard_normal(
        (1, 32, 32, 3)).astype(np.float32) / 4
    eng.calibrate([{i: x}])
    want = eng.run({i: x})[o]
    path = str(tmp_path / "s8.pt2")
    eng.export_model(path)
    ops = _custom_ops(path)
    assert {"simpleinfer.matmul_s8s8.default",
            "simpleinfer.c3_block.default"} <= ops
    np.testing.assert_array_equal(load_exported(path)({i: x})[o], want)


def test_artifact_loads_in_a_fresh_process():
    """chip_smoke.py's tooling phase at a tiny size on the CPU: a YOLOv5s
    engine exported and reloaded by load_exported in a new interpreter
    that imports no builder and no JAX (its own assertion), the output
    equal to the live engine's; the roofline and the FLOP slices of the
    same engine."""
    r = chip_smoke.tooling_rehearsal(torch.device("cpu"))
    art = r["art"]
    assert art["max_abs_over_scale"] <= chip_smoke.EXPORT_TOL
    assert art["launches"] == {"matmul_int8w": 0, "matmul_s8s8": 0,
                               "c3_block": 0}       # the CPU: no launch
    assert "GFLOP/batch1" in r["table"]
    assert len(r["segments"]) >= 2


def test_card_artifact_refuses_the_cpu(resnet, tmp_path, monkeypatch):
    """An artifact recorded on the card raises where there is none
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import json

    from simpleinfer_tpu_torch import engine as teng

    path = resnet[5]
    extra = {teng._EXPORT_META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = dict(json.loads(extra[teng._EXPORT_META]), device="cuda")
    card = str(tmp_path / "card.pt2")
    torch.export.save(ep, card,
                      extra_files={teng._EXPORT_META: json.dumps(meta)})
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(card)
