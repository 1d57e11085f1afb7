"""The port's Engine (simpleinfer_tpu_torch) against the JAX Engine on
small YOLOv5 graphs, on the CPU.

Tolerances:
- fp32: the golden tolerance of tests/test_golden.py (atol 5e-4 x scale,
  rtol 5e-4), scale = max(1, max|out|);
- int8w fp32, same quantized bytes: the golden tolerance too. The JAX
  package runs its W-packed stem chain on the pre-quantization fp
  weights (its `bt_in*` packs are not quantized), the port quantizes
  every conv, so the two differ by ~1e-4 x scale at most;
- int8w bf16, same quantized bytes: max |diff| <= 2^-5 x scale and mean
  |diff| <= 1e-4 x scale: the two round to bf16 at other places in each
  of ~60 layers (measured 1.1e-2 and 1.3e-5).
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.zoo.builders import build_yolov5 as jbuild
from simpleinfer_tpu_torch import Engine, EngineConfig, EngineStateError
from simpleinfer_tpu_torch.convert import program_weights_from_numpy
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.quant.tensor import QuantizedTensor
from simpleinfer_tpu_torch.zoo import build_yolov5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "yolov5n.npz")


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def jax_weights_numpy(weights):
    """A JAX Program.weights tree as numpy, quantized tensors as
    (int8 data, f32 scale, axis) — the input of program_weights_from_numpy."""
    return {op: {k: ((np.asarray(v.data), np.asarray(v.scale), v.axis)
                     if isinstance(v, JQ) else np.asarray(v))
                 for k, v in d.items()}
            for op, d in weights.items()}


def port_engine(quant=None, dtype="float32", use_kernels=None, batch=2,
                image=64, variant="s", **cfg):
    graph, in_name, out_name = build_yolov5(variant, batch=batch,
                                            image_size=image)
    eng = Engine(EngineConfig(device="cpu", quant=quant, compute_dtype=dtype,
                              use_kernels=use_kernels, **cfg))
    return eng.load_model(None, graph=graph), in_name, out_name, graph


def jax_engine(quant=None, dtype="float32", batch=2, image=64, variant="s",
               **cfg):
    graph, in_name, out_name = jbuild(variant, batch=batch, image_size=image)
    eng = JEngine(JCfg(quant=quant, compute_dtype=dtype, **cfg))
    return eng.load_model(None, graph=graph)


def images(batch=2, image=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32) / 3


def test_golden_yolov5n():
    """tests/golden/yolov5n.npz (the JAX package's fp32 golden) through
    the port, with the inputs of tests/test_golden.py."""
    eng, in_name, out_name, _ = port_engine(variant="n", batch=1, image=32)
    x = np.random.default_rng(1234).standard_normal(
        (1, 32, 32, 3)).astype(np.float32) / 3
    golden_close(eng.run({in_name: x})[out_name], np.load(GOLDEN)["out"])


@pytest.mark.parametrize("variant,batch,image", [("n", 1, 32),
                                                 ("s", 2, 64)])
def test_fp32_matches_jax(variant, batch, image):
    x = images(batch, image)
    je = jax_engine(batch=batch, image=image, variant=variant)
    pe, in_name, out_name, _ = port_engine(batch=batch, image=image,
                                           variant=variant)
    assert pe.input_names == je.input_names
    assert pe.output_names == je.output_names
    golden_close(pe.run({in_name: x})[out_name],
                 je.run({in_name: x})[out_name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8w_matches_jax_same_bytes(dtype):
    """Both engines on the same quantized bytes: the port quantizes its
    own weights byte-equal to the JAX package's, and runs the JAX
    package's weights (program_weights_from_numpy) to the same output."""
    x = images()
    je = jax_engine(quant="int8w", dtype=dtype)
    want = je.run({"0": x})[je.output_names[0]]
    pe, in_name, out_name, _ = port_engine(quant="int8w", dtype=dtype,
                                           use_kernels=True)
    n_quant = 0
    for op, wd in pe.program.weights.items():
        for k, w in wd.items():
            if isinstance(w, QuantizedTensor):
                jw = je.program.weights[op][k]
                assert w.data.numpy().tobytes() == \
                    np.asarray(jw.data).tobytes()
                assert w.scale.numpy().tobytes() == \
                    np.asarray(jw.scale).tobytes()
                n_quant += 1
    assert n_quant == sum(1 for i in pe.program.impls
                          if i.type == "nn.Conv2d")
    own = pe.run({in_name: x})[out_name]
    carried = program_weights_from_numpy(
        jax_weights_numpy(je.program.weights), device="cpu")
    assert carried.keys() == pe.program.weights.keys()
    for op in carried:
        assert carried[op].keys() == pe.program.weights[op].keys()
    with torch.inference_mode():
        got = pe.program.fn(
            pe.place_weights(carried, pe.program),
            {in_name: torch.from_numpy(x).to(getattr(torch, dtype))}
        )[out_name].float().numpy()
    np.testing.assert_array_equal(got, own)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        golden_close(got, want)
    else:
        d = np.abs(got - want)
        assert d.max() <= 2 ** -5 * scale, d.max() / scale
        assert d.mean() <= 1e-4 * scale, d.mean() / scale


def test_convert_places_on_the_card_by_default():
    """program_weights_from_numpy places on the card unless the caller
    asks for the CPU, as EngineConfig.device does: without a card, a
    call that names no device raises instead of landing on the CPU."""
    import inspect

    default = inspect.signature(program_weights_from_numpy).parameters[
        "device"].default
    assert default == "cuda" == EngineConfig().device
    tree = {"op": {"w": np.ones(3, np.float32),
                   "q": (np.ones((2, 3), np.int8),
                         np.ones(3, np.float32), 1)}}
    if torch.cuda.is_available():
        placed = program_weights_from_numpy(tree)["op"]
        assert placed["w"].device.type == placed["q"].data.device.type \
            == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            program_weights_from_numpy(tree)
    cpu = program_weights_from_numpy(tree, device="cpu")["op"]
    assert cpu["w"].device.type == cpu["q"].data.device.type == "cpu"


def test_every_pointwise_conv_reaches_matmul_int8w(monkeypatch):
    """With kernels on, each single-input pointwise int8w conv of the
    fused graph calls matmul_int8w once per forward (on the CPU the
    wrapper runs the plain version); cat-split convs do not."""
    calls = []
    orig = tmm.matmul_int8w

    def spy(x, w_q, scale, bias=None, activation=None, **kw):
        calls.append((tuple(x.shape), tuple(w_q.shape), activation))
        return orig(x, w_q, scale, bias, activation, **kw)

    monkeypatch.setattr(tmm, "matmul_int8w", spy)
    pe, in_name, out_name, graph = port_engine(quant="int8w",
                                               dtype="bfloat16",
                                               use_kernels=True)
    pointwise = [op for op in graph.ops if op.type == "nn.Conv2d"
                 and op.params["kernel_size"].value == [1, 1]
                 and op.params["stride"].value == [1, 1]
                 and op.params["padding"].value == [0, 0]]
    expected = sum(len(op.inputs) == 1 for op in pointwise)
    assert expected == 22  # yolov5s; the other 17 are cat-split
    out = pe.run({in_name: images()})[out_name]
    assert len(calls) == expected
    assert all(act == "silu" for _, _, act in calls)
    assert out.shape == (2, 252, 85) and np.isfinite(out).all()
    calls.clear()
    port_engine(quant="int8w", use_kernels=False)[0].run(
        {in_name: images()})
    assert calls == []


def test_io_layout_and_u8_match_jax():
    """io_layout='nchw' and uint8 inputs scaled on the device."""
    x = np.random.default_rng(3).integers(0, 256, (1, 3, 32, 32),
                                          dtype=np.uint8)
    je = jax_engine(batch=1, image=32, variant="n", io_layout="nchw")
    pe, in_name, out_name, _ = port_engine(batch=1, image=32, variant="n",
                                           io_layout="nchw")
    golden_close(pe.run({in_name: x})[out_name],
                 je.run({in_name: x})[out_name])


def test_engine_states():
    eng = Engine(EngineConfig(device="cpu"))
    with pytest.raises(EngineStateError):
        eng.forward()
    eng, in_name, out_name, _ = port_engine(variant="n", batch=1, image=32)
    with pytest.raises(EngineStateError, match="inputs not set"):
        eng.forward()
    with pytest.raises(EngineStateError, match="forward"):
        eng.extract(out_name)
    with pytest.raises(KeyError):
        eng.input("nope", images(1, 32))
    eng.input(in_name, torch.from_numpy(images(1, 32)))
    eng.forward()
    eng.synchronize()
    out = eng.extract(out_name, as_numpy=False)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    eng.release()
    assert not eng.loaded


def test_config_rejects_unported():
    """Static int8 and the C3 collapse are ported now (they construct);
    what no package supports still raises."""
    for kw in (dict(quant="int8"), dict(c3_fusion=True)):
        EngineConfig(device="cpu", **kw)
    with pytest.raises(ValueError, match="quant"):
        EngineConfig(device="cpu", quant="int4")
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", compute_dtype="float16")
    with pytest.raises(ValueError, match="int4_group"):
        EngineConfig(device="cpu", quant="int4w", int4_group=7)


def test_int4w_engine_builds():
    """quant='int4w' builds: 2-D weights become Quantized4Tensors of the
    configured group, the 4-D conv weights of a CNN fall back to int8
    (as in the JAX package), and a forward gives finite outputs."""
    from simpleinfer_tpu_torch.quant.tensor import Quantized4Tensor
    from simpleinfer_tpu_torch.zoo import build_llama

    graph, in_name, out_name = build_llama("nano", seq_len=16, vocab_size=32)
    eng = Engine(EngineConfig(device="cpu", quant="int4w", int4_group=32))
    eng.load_model(None, graph=graph)
    q4 = [w for d in eng.program.weights.values() for w in d.values()
          if isinstance(w, Quantized4Tensor)]
    assert q4 and all(w.group == 32 for w in q4)
    out = eng.run({in_name: np.zeros((1, 16), np.float32)})[out_name]
    assert out.shape == (1, 16, 32) and np.isfinite(out).all()
    pe, in_name, out_name, _ = port_engine(quant="int4w", variant="n",
                                           batch=1, image=32)
    assert any(isinstance(w, QuantizedTensor)
               for d in pe.program.weights.values() for w in d.values())
    assert np.isfinite(pe.run({in_name: images(1, 32)})[out_name]).all()


def test_chip_smoke_phases_rehearse_on_cpu():
    """chip_smoke.py's main-path and fp32 phases, on the CPU at a tiny
    size, with the plain versions (the card runs them at full size)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cpu = torch.device("cpu")
    res = chip_smoke.main_path(cpu, batch=1, image=64, n_batches=2)
    assert res["kernel_convs_per_forward"] == 22
    assert res["output_shape"] == [1, 252, 85]
    chip_smoke.fp32_card_vs_cpu(cpu, batch=1, image=32)


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a card, or without the package beside it, chip_smoke.py
    exits non-zero and prints no ok line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
