"""The port's mesh Engine against the JAX package's (the cases of
tests/test_engine.py's sharding tests and tests/test_quant_static.py's
static int8 under DP and TP).

Every MESH_CASES model runs through a port mesh engine in 4 gloo ranks
on the CPU (one spawn for the module; executor.ShardedWalk, the
collectives over torch.distributed) and is held against the JAX mesh
engine of the same MeshConfig on the first 4 devices of this process's
simulated mesh, and against the port's single-process engine, at the
JAX tests' tolerances (1e-4; yolov5n 2e-4 / 1e-3)."""
import os

import jax
import numpy as np
import pytest

import simpleinfer_tpu.zoo as jzoo
import simpleinfer_tpu_torch.ops.conv as tconv
import simpleinfer_tpu_torch.zoo as tzoo
from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu import MeshConfig as JMesh
from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
from simpleinfer_tpu_torch.parallel import multiproc

import torch_rank_tasks as T

TASKS = os.path.join(os.path.dirname(__file__), "torch_rank_tasks.py")
FP_CASES = [n for n, c in T.MESH_CASES.items() if not c[3]]
INT8_CASES = [n for n, c in T.MESH_CASES.items() if c[3]]


@pytest.fixture(scope="module")
def ranks():
    return multiproc.spawn(f"{TASKS}:mesh_engine_cases", n_processes=2,
                           devices_per_process=2, timeout_s=120,
                           device="cpu")


def _tol(name):
    return dict(atol=2e-4, rtol=1e-3) if name.startswith("y5") else \
        dict(atol=1e-4, rtol=1e-4)


def _jax_engine(name):
    kind, kw, mesh, ekw = T.MESH_CASES[name]
    graph, i, o = T.mesh_graph(jzoo, kind, kw)
    extra = dict(int8_min_channels=1, int8_pointwise=True) \
        if ekw.get("quant") == "int8" else {}
    eng = JEngine(JConfig(mesh=JMesh(**mesh), **ekw, **extra)).load_model(
        None, graph=graph)
    return eng, i, o


def _port_single(name, monkeypatch):
    kind, kw, _mesh, ekw = T.MESH_CASES[name]
    monkeypatch.setattr(tconv, "INT8_MIN_CHANNELS", 1)
    monkeypatch.setattr(tconv, "INT8_POINTWISE", True)
    graph, i, o = T.mesh_graph(tzoo, kind, kw)
    eng = Engine(EngineConfig(device="cpu", **ekw)).load_model(
        None, graph=graph)
    return eng, i, o


@pytest.mark.parametrize("name", FP_CASES)
def test_mesh_engine_matches_jax_mesh_and_one_process(ranks, name,
                                                      monkeypatch):
    kind, kw, mesh, _ = T.MESH_CASES[name]
    x = T.mesh_input(name, kw)
    jeng, i, o = _jax_engine(name)
    want_jax = jeng.run({i: x})[o]
    seng, i, o = _port_single(name, monkeypatch)
    want_port = seng.run({i: x})[o]
    for r in ranks:     # extract() is the global output on every rank
        got = r[name]
        assert got.shape == want_jax.shape
        np.testing.assert_allclose(got, want_jax, **_tol(name))
        np.testing.assert_allclose(got, want_port, **_tol(name))
        np.testing.assert_array_equal(got, ranks[0][name])
    modes = set(ranks[0][f"{name}_modes"].values())
    calls = ranks[0][f"{name}_calls"]
    if mesh.get("model", 1) > 1:
        # channel-sharded convs / linears gather their outputs; ViT's
        # attention runs its heads and reduces the output projection
        assert "column" in modes and calls["all_gather"] > 0
        if kind == "vit":
            assert "heads" in modes and calls["all_reduce"] > 0
    if mesh.get("spatial", 1) > 1:
        # halo rows travel between neighbours before the convs / pools
        assert calls["batch_isend_irecv"] > 0


@pytest.mark.parametrize("name", INT8_CASES)
def test_static_int8_under_mesh(ranks, name, monkeypatch):
    """Static int8 calibrated under DP / TP installs one process's scales
    (every rank the same) and stays within the JAX test's budget of the
    fp32 model; against the port's single int8 engine the outputs agree
    to the quantization step the scales allow."""
    kind, kw, mesh, ekw = T.MESH_CASES[name]
    x = T.mesh_input(name, kw)
    seng, i, o = _port_single(name, monkeypatch)
    want_scales = seng.calibrate([{i: x}])
    single = seng.run({i: x})[o]
    graph, _, _ = T.mesh_graph(tzoo, kind, kw)
    fp = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=graph).run({i: x})[o]
    jeng, ji, jo = _jax_engine(name)
    jeng.calibrate([{ji: x}])
    jgot = jeng.run({ji: x})[jo]
    scale = max(1.0, float(np.abs(fp).max()))
    for r in ranks:
        got_scales = r[f"{name}_scales"]
        assert set(got_scales) == set(want_scales)
        for k, v in want_scales.items():
            if mesh.get("model", 1) > 1:
                # channel-sharded convs sum the same products in their
                # own blocking: the activations, hence abs-max, agree to
                # f32 rounding
                np.testing.assert_allclose(got_scales[k], v, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got_scales[k], v)
        got = r[name]
        assert np.abs(got - fp).max() < 0.1 * scale
        assert np.abs(jgot - fp).max() < 0.1 * scale
        assert np.abs(got - single).max() < 0.01 * scale
        if mesh.get("model", 1) == 1:
            assert np.argmax(got, -1).tolist() == np.argmax(fp, -1).tolist()


def test_mesh_engine_checks_the_world():
    """One process is a world of one rank: a mesh of 2 raises with how to
    launch the ranks; int4w refuses a mesh as in the JAX package, and a
    device index refuses one too (the JAX device_index rule)."""
    graph, _, _ = tzoo.build_resnet18(batch=2, image_size=32,
                                      num_classes=4, width=8)
    eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(data=2)))
    with pytest.raises(ValueError, match="torchrun"):
        eng.load_model(None, graph=graph)
    with pytest.raises(ValueError, match="int4w"):
        EngineConfig(quant="int4w", mesh=MeshConfig(model=2))
    with pytest.raises(ValueError, match="SINGLE-device"):
        EngineConfig(device="cuda:0", mesh=MeshConfig(model=2))
    with pytest.raises(ValueError, match="tp_mode"):
        EngineConfig(tp_mode="tree")
    # a mesh of one device is the single-device engine
    one = Engine(EngineConfig(device="cpu", mesh=MeshConfig())).load_model(
        None, graph=graph)
    assert one.mesh is None
    assert jax.devices()  # JAX stays on its simulated CPU mesh here
