"""The port's CUDA kernel and Engine on the card (marker `cuda`).

These tests need a CUDA card and skip without one. They import neither
jax nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the other tests.)
Tolerances as in chip_smoke.py: 1e-4 x max(1, max|ref|) for the kernel
against its plain version (f32 sums in another order), plus one bf16
ulp (2^-7 relative) for a bf16 output; fp32 Engine on the card against
the CPU within 1e-4 x scale + 1e-4 x |ref|.
"""
import numpy as np
import pytest
import torch

from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.engine import fp32_parity
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel
from simpleinfer_tpu_torch.zoo import build_yolov5

SHAPES = [(128, 128, 128), (256, 512, 256), (100, 60, 50), (1, 256, 255),
          (37, 129, 131), (8, 16, 8)]
ACTIVATIONS = [None, "relu", "silu", "sigmoid", "hardsigmoid", "hardswish",
               "relu6", "tanh", "mish", "gelu", "gelu_tanh",
               "leaky_relu@0.1", "elu@1.0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs the CUDA kernel)")
    return torch.device("cuda")


def _assert_close(got, ref):
    assert got.dtype == ref.dtype
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float().cpu(), ref.float().cpu()
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    if bf16:
        lim = lim + 2.0 ** -7 * ref.abs()
    d = (got - ref).abs()
    assert bool((d <= lim).all()), float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    b = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    q = quantize_per_channel(w, axis=1)
    wq, scale = q.data.to(cuda), q.scale.to(cuda)
    before = tmm.launches
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(cuda, dtype)
        wt = torch.from_numpy(w).to(cuda, dtype)
        bt = b.to(cuda, dtype)
        for act in ACTIVATIONS:
            with fp32_parity(True):
                got = tmm.matmul_int8w(xt, wq, scale, bt, act)
                torch.cuda.synchronize()
                _assert_close(got, tmm.matmul_int8w_ref(xt, wq, scale, bt,
                                                        act))
                got = tmm.matmul(xt, wt, bt, act)
                torch.cuda.synchronize()
                _assert_close(got, tmm.matmul_ref(xt, wt, bt, act))
    assert tmm.launches - before == 2 * 2 * len(ACTIVATIONS)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """fp32 int8w YOLOv5s through the kernel on the card against the
    plain versions on the CPU; 22 launches per forward."""
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32) / 3
    outs = {}
    for dev in ("cuda", "cpu"):
        graph, in_name, out_name = build_yolov5("s", batch=2, image_size=64)
        eng = Engine(EngineConfig(device=dev, quant="int8w",
                                  use_kernels=True))
        eng.load_model(None, graph=graph)
        before = tmm.launches
        outs[dev] = eng.run({in_name: x})[out_name]
        if dev == "cuda":
            assert tmm.launches - before == 22
    scale = max(1.0, float(np.abs(outs["cpu"]).max()))
    np.testing.assert_allclose(outs["cuda"], outs["cpu"],
                               atol=1e-4 * scale, rtol=1e-4)
