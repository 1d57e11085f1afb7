"""The port's reference API (simpleinfer_tpu_torch/compat.py and
tensor.py) against the JAX package's, on the CPU.

Each scenario drives both packages' PascalCase Engine through the same
calls, the reference's own script flow and its error paths, and the
Status codes (by name) must be equal; the port's outputs must equal its
own Engine.run bit for bit and the JAX Engine's within the golden
tolerance (5e-4 x scale + 5e-4 x |ref|). tensor.py's enums equal the
JAX copy's, name for name and value for value; its Tensor holds numpy
or torch payloads.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

import simpleinfer_tpu.compat as jcompat
import simpleinfer_tpu.tensor as jtensor
import simpleinfer_tpu_torch as port
import simpleinfer_tpu_torch.compat as tcompat
import simpleinfer_tpu_torch.tensor as ttensor
from simpleinfer_tpu.zoo import build_yolov5 as jbuild_yolov5
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.zoo import build_yolov5

CPU = EngineConfig(device="cpu")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """A small YOLOv5n written by Graph.save (the JAX builder's bytes are
    the port's: tests/test_torch_engine.py)."""
    d = tmp_path_factory.mktemp("compat")
    param, binf = str(d / "yolov5n.pnnx.param"), str(d / "yolov5n.pnnx.bin")
    build_yolov5("n", batch=2, image_size=64)[0].save(param, binf)
    return param, binf


def _engine(infer):
    return infer.Engine(CPU) if infer is tcompat else infer.Engine()


def _flow(infer, files, x):
    """The reference's python script: every call's Status and the
    output."""
    infer.InitializeContext()
    eng = _engine(infer)
    st = [eng.LoadModel(*files)]
    ins, outs = eng.InputNames(), eng.OutputNames()
    t = infer.Tensor(infer.DataType.Float32, list(x.shape))
    st.append(t.SetTensorDim4(x))
    st.append(eng.Input(ins[0], t))
    st.append(eng.Forward())
    out = infer.Tensor()
    st.append(eng.Extract(outs[0], out))
    result = out.GetTensorDim4()
    st.append(eng.Release())
    return st, (ins, outs), result


def test_reference_flow_statuses_and_outputs(model_files):
    x = np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32) / 3
    tst, tnames, got = _flow(tcompat, model_files, x)
    jst, jnames, want = _flow(jcompat, model_files, x)
    assert [s.name for s in tst] == [s.name for s in jst]
    assert set(s.name for s in tst) == {"Success"}
    assert tnames == jnames
    direct = Engine(CPU).load_model(*model_files).run(
        {tnames[0][0]: x})[tnames[1][0]]
    assert got.shape == want.shape == (1,) + direct.shape
    np.testing.assert_array_equal(got[0], direct)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def _missing_files(infer, files):
    eng = _engine(infer)
    return [eng.LoadModel("/nope/m.pnnx.param", "/nope/m.pnnx.bin"),
            eng.Forward(), eng.Release()], eng.InputNames()


def _unloaded_calls(infer, files):
    eng = _engine(infer)
    t = infer.Tensor()
    t.SetTensorDim4(np.zeros((1, 4, 4, 3)))
    return [eng.Input("0", t), eng.Forward(),
            eng.Extract("x", infer.Tensor())], eng.OutputNames()


def _bad_inputs(infer, files):
    eng = _engine(infer)
    st = [eng.LoadModel(*files)]
    good = infer.Tensor()
    good.SetTensorDim4(np.zeros((2, 64, 64, 3), np.float32))
    st.append(eng.Input("no_such_input", good))
    st.append(eng.Input("0", infer.Tensor()))        # empty tensor
    st.append(eng.Extract(eng.OutputNames()[0], infer.Tensor()))
    st.append(eng.Extract("no_such_output", infer.Tensor()))
    return st, None


def _tensor_shapes(infer, files):
    t = infer.Tensor(infer.DataType.Float32, [1, 2, 2, 3])
    return [t.SetTensorDim4(np.zeros((2, 2))),
            t.SetTensorDim4(np.zeros((9, 2, 2, 3))),
            t.SetTensorDim4(np.zeros((1, 2, 2, 3))),
            infer.Tensor().SetTensorDim4(np.zeros((3, 1, 1, 1)))], \
        (t.Shape(), t.GetDataType().name)


@pytest.mark.parametrize("scenario", [_missing_files, _unloaded_calls,
                                      _bad_inputs, _tensor_shapes],
                         ids=lambda f: f.__name__.strip("_"))
def test_error_statuses_equal_jax(scenario, model_files):
    """The error paths return the JAX copy's Status for the same calls
    (Empty for missing files, Fail for unknown names and calls out of
    order, ErrorShape for a wrong rank or shape)."""
    tst, textra = scenario(tcompat, model_files)
    jst, jextra = scenario(jcompat, model_files)
    assert [s.name for s in tst] == [s.name for s in jst]
    assert textra == jextra


def test_default_engine_runs_on_cuda():
    """Engine() with no config asks for the card: without one it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcompat.Engine()


def test_compat_enums_equal_jax():
    for a, b in ((tcompat.Status, jcompat.Status),
                 (tcompat.DataType, jcompat.DataType)):
        assert [(m.name, m.value) for m in a] == \
            [(m.name, m.value) for m in b]
    assert getattr(tcompat.DataType, "None") is tcompat.DataType.None_


def test_tensor_module_enums_equal_jax():
    for a, b in ((ttensor.Status, jtensor.Status),
                 (ttensor.DataType, jtensor.DataType)):
        assert [(m.name, m.value) for m in a] == \
            [(m.name, m.value) for m in b]
    assert port.DataType is ttensor.DataType
    assert port.Status is ttensor.Status
    assert port.Tensor is ttensor.Tensor


@pytest.mark.parametrize("payload", ["numpy", "torch", "torch_bf16"])
def test_tensor_payloads(payload):
    """Tensor over a numpy array or a torch tensor: shape, emptiness,
    numpy() (bf16 fetched as f32) and the layout helpers, against the
    JAX Tensor over the same numpy data."""
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    if payload == "torch_bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    data = {"numpy": x, "torch": torch.from_numpy(x),
            "torch_bf16": torch.from_numpy(x).bfloat16()}[payload]
    t = ttensor.Tensor(data=data)
    j = jtensor.Tensor.from_numpy(x)
    assert t.shape == j.shape and not t.empty
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    np.testing.assert_array_equal(t.nhwc(), j.nhwc())
    np.testing.assert_array_equal(t.nchw(), j.nchw())
    if payload != "numpy":
        assert tuple(ttensor.nchw_to_nhwc(data).shape) == (2, 4, 5, 3)
        assert tuple(ttensor.nhwc_to_nchw(data).shape) == (2, 5, 3, 4)
    assert ttensor.Tensor().empty and ttensor.Tensor().shape == ()
    with pytest.raises(ValueError):
        ttensor.Tensor().numpy()


def test_jax_builder_files_load_through_port_compat(tmp_path):
    """Files the JAX package's Graph.save wrote load through the port's
    LoadModel (the on-disk format is shared)."""
    param, binf = str(tmp_path / "j.pnnx.param"), str(tmp_path / "j.pnnx.bin")
    jbuild_yolov5("n", batch=1, image_size=64)[0].save(param, binf)
    eng = tcompat.Engine(CPU)
    assert eng.LoadModel(param, binf) is tcompat.Status.Success
    assert eng.InputNames() == ["0"]
