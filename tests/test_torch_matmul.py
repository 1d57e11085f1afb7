"""The port's `matmul` / `matmul_int8w` (simpleinfer_tpu_torch.kernels.
matmul) against the JAX package's Pallas kernel and its jnp oracles.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernel needs a card; tests/test_torch_cuda.py holds it against the plain
version there). The Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it. Tolerances:
- f32 vs Pallas-interpret: rtol = atol = 1e-4 x max(1, max|ref|): the
  Pallas body splits f32 operands into bf16 hi/lo and drops lo*lo,
  about 2^-16 relative per product;
- f32 vs the jnp oracle (`matmul_ref`, HIGHEST precision): 1e-5, the
  same sums in another order;
- bf16 out: one bf16 ulp of the output (2^-7 relative) on top, as the
  two sides may round an f32 value on either side of a bf16 boundary.
"""
import importlib

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from simpleinfer_tpu.quant.tensor import quantize_per_channel as jquant
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel as tquant

# the module (the package re-exports a function of the same name)
jmm = importlib.import_module("simpleinfer_tpu.kernels.matmul")

# M, K, N: the shapes of tests/test_kernels.py
SHAPES = [
    (128, 128, 128),
    (256, 512, 256),
    (100, 60, 50),
    (1, 256, 255),
    (37, 129, 131),
    (8, 16, 8),
]
ACTIVATIONS = [None, "relu", "silu", "sigmoid", "hardsigmoid", "hardswish",
               "relu6", "tanh", "mish", "gelu", "gelu_tanh",
               "leaky_relu@0.1", "elu@1.0"]
BF16_ULP = 2.0 ** -7


def _case(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m * 7 + k * 3 + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    b = 0.1 * rng.standard_normal(n).astype(np.float32)
    return x, w, b


def _port(entry, x, w, b, act, dtype):
    """The port's entry on CPU tensors, inputs at `dtype`, as numpy f32."""
    xt = torch.from_numpy(x).to(dtype)
    bt = torch.from_numpy(b)
    if entry == "matmul":
        out = tmm.matmul(xt, torch.from_numpy(w).to(dtype), bt, act)
    else:
        q = tquant(w, axis=1)
        out = tmm.matmul_int8w(xt, q.data, q.scale, bt, act)
    assert out.dtype == dtype
    return out.float().numpy()


def _jax(entry, x, w, b, act, dtype, pallas):
    xj = jnp.asarray(x).astype(dtype)
    bj = jnp.asarray(b)
    if entry == "matmul":
        wj = jnp.asarray(w).astype(dtype)
        fn = jmm.matmul if pallas else jmm.matmul_ref
        args = (xj, wj, bj, act)
    else:
        q = jquant(w, axis=1)
        fn = jmm.matmul_int8w if pallas else jmm.matmul_int8w_ref
        args = (xj, q.data, q.scale, bj, act)
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            out = fn(*args)
    else:
        out = fn(*args)
    return np.asarray(out.astype(jnp.float32))


def _assert_close(got, want, tol, bf16):
    scale = max(1.0, float(np.abs(want).max()))
    atol = tol * scale + (BF16_ULP * np.abs(want) if bf16 else 0.0)
    err = np.abs(got - want)
    assert np.all(err <= atol + tol * np.abs(want)), float(err.max())


@pytest.mark.parametrize("entry", ["matmul", "matmul_int8w"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_vs_pallas_interpret(m, k, n, dtype, entry):
    x, w, b = _case(m, k, n)
    td = getattr(torch, dtype)
    jd = getattr(jnp, dtype)
    got = _port(entry, x, w, b, "silu", td)
    want = _jax(entry, x, w, b, "silu", jd, pallas=True)
    _assert_close(got, want, 1e-4, dtype == "bfloat16")


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations_vs_pallas_interpret(act):
    x, w, b = _case(37, 129, 131, seed=1)
    got = _port("matmul_int8w", x, w, b, act, torch.float32)
    want = _jax("matmul_int8w", x, w, b, act, jnp.float32, pallas=True)
    _assert_close(got, want, 1e-4, False)


@pytest.mark.parametrize("entry", ["matmul", "matmul_int8w"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_vs_jnp_oracle(act, entry):
    # every activation at the two most ragged shapes (the Pallas tests
    # above cover every shape)
    for m, k, n in [(100, 60, 50), (1, 256, 255)]:
        x, w, b = _case(m, k, n, seed=2)
        got = _port(entry, x, w, b, act, torch.float32)
        want = _jax(entry, x, w, b, act, jnp.float32, pallas=False)
        _assert_close(got, want, 1e-5, False)
        got = _port(entry, x, w, b, act, torch.bfloat16)
        want = _jax(entry, x, w, b, act, jnp.bfloat16, pallas=False)
        _assert_close(got, want, 1e-5, True)


@pytest.mark.parametrize("shape,axis", [((16, 24), 1), ((3, 3, 8, 12), 3),
                                        ((1, 1, 5, 7), 3), ((4, 6), 0)])
def test_quantize_per_channel_equal(shape, axis):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes scale 1.0 in both
    j, t = jquant(w, axis), tquant(w, axis)
    assert t.axis == j.axis
    assert t.data.dtype == torch.int8
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert t.scale.numpy().tobytes() == np.asarray(j.scale).tobytes()
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))


def test_resolve_activation_names():
    for act in ACTIVATIONS:
        tmm.resolve_activation(act)
        code, arg = tmm._act_code(act)
        assert 0 <= code <= 12
    assert tmm._act_code("leaky_relu@0.25") == (11, 0.25)
    with pytest.raises(KeyError):
        tmm.resolve_activation("swish")


def test_wrapper_checks_without_card():
    """A CPU tensor takes the plain version and launches nothing; a
    tensor on any other device goes to the kernel path, which raises
    where the kernel cannot take it (no silent fallback)."""
    x = torch.randn(4, 8)
    q = tquant(np.random.default_rng(0).standard_normal((8, 3)), axis=1)
    before = tmm.launches
    out = tmm.matmul_int8w(x, q.data, q.scale)
    assert out.shape == (4, 3) and tmm.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tmm.matmul(x.to("meta"), torch.randn(8, 3, device="meta"))
    with pytest.raises(TypeError):
        tmm.matmul_int8w(x.to("meta"), torch.randn(8, 3, device="meta"),
                         torch.ones(3, device="meta"))
